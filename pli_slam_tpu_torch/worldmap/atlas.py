"""Atlas: several maps, a new one on persistent loss, and map merging (port of
pli_slam_tpu.worldmap.atlas).

A map is a bundle of the three struct-of-arrays stores and its BoW
database. A merge welds the active map into a parked one: every active
pose and landmark is transformed by the verified SE3 and copied into the
parked map's free slots, observation tables re-indexed by gathers, the
covisibility block and the landmark->keyframe incidence bitsets carried
through the slot permutation as matrix products. Scatters are
last-write-wins (`ops.indexing.scatter_set`), as on XLA's CPU backend; the
bitsets stay int32 bit patterns (worldmap.stores).
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.indexing import scatter_set
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.worldmap import stores as st


@dataclasses.dataclass
class MapBundle:
    pstore: st.PointStore
    lstore: st.LineStore
    kstore: st.KeyFrameStore
    n_kf: int = 0
    # a parked map keeps its BoW database, so place recognition can find it again
    bow_db: object = None

    @staticmethod
    def empty(cfg: SlamConfig, device=None) -> "MapBundle":
        m = cfg.map
        return MapBundle(
            pstore=st.PointStore.empty(m.max_points, device=device),
            lstore=st.LineStore.empty(m.max_lines, device=device),
            kstore=st.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, device),
        )


class Atlas:
    """Host-side registry of maps (the stores live on `device`)."""

    def __init__(self, cfg: SlamConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.maps: list[MapBundle] = [MapBundle.empty(cfg, device)]
        self.active_idx = 0
        self.last_kf_slots = None

    @property
    def active(self) -> MapBundle:
        return self.maps[self.active_idx]

    def n_maps(self) -> int:
        return len(self.maps)

    def create_new_map(self) -> MapBundle:
        self.maps.append(MapBundle.empty(self.cfg, self.device))
        self.active_idx = len(self.maps) - 1
        return self.active

    def merge_active_into(self, target_idx: int, R_rel, t_rel, fuse_src=None, fuse_dst=None) -> MapBundle:
        """Weld the active map into maps[target_idx]; (R_rel, t_rel) maps
        active-map world points into the target's world. The merged map
        becomes active, the old active map is dropped. `last_kf_slots`
        (numpy [K]) maps each active keyframe slot to its merged slot or -1."""
        merged, kf_slots = merge_maps(self.maps[target_idx], self.active, R_rel, t_rel, fuse_src, fuse_dst)
        self.last_kf_slots = kf_slots.cpu().numpy()
        self.maps[target_idx] = merged
        self.maps.pop(self.active_idx)
        self.active_idx = target_idx if target_idx < self.active_idx else target_idx - 1
        return self.active


def _unpack_bits(words, K: int):
    """[*, KW] int32 bit patterns -> [*, K] 0/1 float32."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(words.shape[0], -1)[:, :K].to(torch.float32)


def _pack_bits(bits, KW: int):
    """[*, K] 0/1 (exact small integers) -> [*, KW] int32 bit patterns."""
    n, K = bits.shape
    padded = torch.zeros((n, KW * 32), dtype=torch.int64, device=bits.device)
    padded[:, :K] = torch.round(bits).to(torch.int64)
    words = torch.sum(padded.reshape(n, KW, 32) << torch.arange(32, device=bits.device), dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def merge_maps(dst: MapBundle, src: MapBundle, R_rel, t_rel, fuse_src=None, fuse_dst=None):
    """Copy `src` (transformed by x_dst = R_rel x_src + t_rel) into `dst`'s
    free slots. `fuse_src` / `fuse_dst` ([M] int, -1 padded) name src point
    landmarks verified to be dst landmarks: their observations move onto the
    dst landmark instead of a copy. Returns (merged MapBundle, kf_slots [K]
    src keyframe slot -> merged slot or -1)."""
    dev = R_rel.device
    i32 = torch.int32
    Rr_inv, tr_inv = lie.se3_inverse(R_rel, t_rel)
    src_pts = lie._einsum("ij,nj->ni", R_rel, src.pstore.x) + t_rel
    src_seg = torch.cat([lie._einsum("ij,nj->ni", R_rel, src.lstore.seg[:, :3]) + t_rel,
                         lie._einsum("ij,nj->ni", R_rel, src.lstore.seg[:, 3:]) + t_rel], dim=-1)
    # poses: T_cw_dst = T_cw_src o T_rel^-1
    src_R = torch.einsum("kij,jl->kil", src.kstore.R, Rr_inv)
    src_t = torch.einsum("kij,j->ki", src.kstore.R, tr_inv) + src.kstore.t

    # fused src points take the dst landmark's id instead of a fresh slot
    P_cap = src.pstore.x.shape[0]
    fuse_map = torch.full((P_cap,), -1, dtype=i32, device=dev)
    if fuse_src is not None:
        fs = torch.as_tensor(fuse_src, device=dev).to(i32)
        fd = torch.as_tensor(fuse_dst, device=dev).to(i32)
        fs0 = torch.clamp(fs, min=0)
        fuse_map = scatter_set(fuse_map, fs0, torch.where(fs >= 0, fd, fuse_map[fs0.long()]))
    pt_slots, pt_ok = st.alloc_slots(~dst.pstore.valid, src.pstore.valid & (fuse_map < 0))
    ln_slots, ln_ok = st.alloc_slots(~dst.lstore.valid, src.lstore.valid)
    kf_slots, kf_ok = st.alloc_slots(~dst.kstore.valid, src.kstore.valid)
    pt_map = torch.where(fuse_map >= 0, fuse_map, pt_slots)  # src point -> dst point, for the observations

    def scatter_rows(dst_arr, src_arr, slots, ok):
        safe = torch.clamp(slots, min=0)
        mask = ok.reshape((-1,) + (1,) * (dst_arr.ndim - 1))
        return scatter_set(dst_arr, safe, torch.where(mask, src_arr.to(dst_arr.dtype), dst_arr[safe.long()]))

    def through(slots, ids):
        """slots[clip(ids)], clamped at 0: a landmark's keyframe anchor in the merged map."""
        return torch.clamp(slots[torch.clamp(ids, 0, slots.shape[0] - 1).long()], min=0)

    ps, sp = dst.pstore, src.pstore
    ps = dataclasses.replace(ps, **{
        name: scatter_rows(getattr(ps, name), val, pt_slots, pt_ok)
        for name, val in (("x", src_pts), ("desc", sp.desc), ("desc_bank", sp.desc_bank), ("valid", sp.valid),
                          ("n_obs", sp.n_obs), ("visible", sp.visible), ("found", sp.found))})
    ls, sl = dst.lstore, src.lstore
    ls = dataclasses.replace(ls, **{
        name: scatter_rows(getattr(ls, name), val, ln_slots, ln_ok)
        for name, val in (("seg", src_seg), ("desc", sl.desc), ("valid", sl.valid), ("n_obs", sl.n_obs))})
    ls = dataclasses.replace(ls, first_kf=scatter_rows(ls.first_kf, through(kf_slots, sl.first_kf), ln_slots, ln_ok),
                             last_kf=scatter_rows(ls.last_kf, through(kf_slots, sl.last_kf), ln_slots, ln_ok))

    def remap_obs(obs_src, lm_slots):
        return torch.where(obs_src >= 0, lm_slots[torch.clamp(obs_src, min=0).long()], torch.full_like(obs_src, -1))

    ps = dataclasses.replace(ps, first_kf=scatter_rows(ps.first_kf, through(kf_slots, sp.first_kf), pt_slots, pt_ok),
                             last_kf=scatter_rows(ps.last_kf, through(kf_slots, sp.last_kf), pt_slots, pt_ok))
    ks, sk = dst.kstore, src.kstore
    ks = dataclasses.replace(ks, **{
        name: scatter_rows(getattr(ks, name), val, kf_slots, kf_ok)
        for name, val in (("R", src_R), ("t", src_t), ("v_w", lie._einsum("ij,kj->ki", R_rel, sk.v_w)),
                          ("bg", sk.bg), ("ba", sk.ba), ("stamp", sk.stamp), ("valid", sk.valid),
                          ("obs_pt", remap_obs(sk.obs_pt, pt_map)), ("obs_uvr", sk.obs_uvr),
                          ("obs_sigma2", sk.obs_sigma2), ("obs_stereo", sk.obs_stereo),
                          ("obs_ln", remap_obs(sk.obs_ln, ln_slots)), ("obs_l", sk.obs_l),
                          ("obs_ln_sigma2", sk.obs_ln_sigma2))})

    # covisibility and incidence bitsets through the slot permutation
    # P[j, i] = 1 where src keyframe i landed in dst slot j (exact in float32)
    K = ks.covis.shape[0]
    Pm = torch.zeros((K * K,), dtype=torch.float32, device=dev)
    Pm.index_add_(0, torch.clamp(kf_slots, min=0).long() * K + torch.arange(K, device=dev), kf_ok.to(torch.float32))
    Pm = Pm.reshape(K, K)
    covis_src = Pm @ sk.covis.to(torch.float32) @ Pm.T
    ks = dataclasses.replace(ks, covis=ks.covis + torch.round(covis_src).to(ks.covis.dtype))
    KW = sp.obs_bits.shape[1]
    repacked = _pack_bits(_unpack_bits(sp.obs_bits, K) @ Pm.T, KW)
    ps = dataclasses.replace(ps, obs_bits=scatter_rows(ps.obs_bits, repacked, pt_slots, pt_ok))
    ls = dataclasses.replace(ls, obs_bits=scatter_rows(
        ls.obs_bits, _pack_bits(_unpack_bits(sl.obs_bits, K) @ Pm.T, KW), ln_slots, ln_ok))
    if fuse_src is not None:
        # fused landmarks: the src observations accumulate onto the dst row
        fs_safe, fd_safe = torch.clamp(fs, min=0).long(), torch.clamp(fd, min=0)
        fok = (fs >= 0) & (fd >= 0)
        n_obs = ps.n_obs.index_add(0, fd_safe.long(), torch.where(fok, sp.n_obs[fs_safe], torch.zeros_like(fs)))
        old = ps.obs_bits[fd_safe.long()]
        ps = dataclasses.replace(ps, n_obs=n_obs, obs_bits=scatter_set(
            ps.obs_bits, fd_safe, torch.where(fok[:, None], old | repacked[fs_safe], old)))
    # the tracker inserts keyframes at slot n_kf: past the highest occupied slot
    n_next = int(torch.max(torch.where(ks.valid, torch.arange(K, device=dev), torch.full((K,), -1, device=dev)))) + 1
    return MapBundle(pstore=ps, lstore=ls, kstore=ks, n_kf=max(dst.n_kf, n_next)), kf_slots

