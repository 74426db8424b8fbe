"""Loop closing: BoW detection -> geometric verification -> graph correction
(port of pli_slam_tpu.frontend.loop_closing).

Detection runs inside the fused per-frame step (the BoW add and query of
`frontend.step._index_keyframe`); the candidates reach `LoopCloser` through
the step's stats vector. On the host, per keyframe: a temporal-consistency
counter; on a confirmed hit, 3D-3D landmark matching, batched Sim3/SE3
RANSAC (`solve.sim3`) and the projection re-check; then the essential-graph
PGO (`solve.pgo`) with landmark re-anchoring, line endpoints included, and
the global BA, queued on the tracker as per-frame chunks.

Verification and correction run as the tracker's stage programs
(frontend.graphs.StageProgram; CUDA graphs on a GPU, eagerly on the CPU
and with `cuda_graphs=False`): `loop_match` (3D-3D matching, the scene-
scaled threshold, the sampling weights), the draw on the host, then
`loop_verify` (RANSAC and both projection re-checks, one int32 read) per
candidate, and `loop_correct` (the essential-graph correction in its mode,
the live pose's rigid delta). Keyframe slots enter them as 0-d device ints
(`ops.indexing.row` / `set_row`), so one capture serves every closure.

`LoopCloser.warm_up` runs each of those stages once on the tracker's
stores, results dropped; `Tracker` calls it at construction on a GPU, so
that the first closure in a process pays neither for loading their
kernels nor, under graphs, for capturing them.

Random draws go through `LoopCloser.draw` (default `solve.sim3.sample_indices`,
seeded with the reference's `kf_slot * 7 + candidate`); a parity test can
hand in the reference's own draw instead.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import torch

from pli_slam_tpu_torch.frontend.step import _dev_int
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie, matching
from pli_slam_tpu_torch.ops.indexing import nanmedian, row, set_row
from pli_slam_tpu_torch.solve import pgo, sim3
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.worldmap import stores as st


def _observed(kstore, pstore, kf):
    """(landmark ids [S], valid [S], descriptors [S,256], positions [S,3]) of keyframe `kf`'s observations."""
    ids = row(kstore.obs_pt, kf)
    safe = torch.clamp(ids, min=0).long()
    return ids, (ids >= 0) & pstore.valid[safe], pstore.desc[safe], pstore.x[safe]


def match_cross_map(ks_a: st.KeyFrameStore, ps_a: st.PointStore, kf_a, ks_b: st.KeyFrameStore,
                    ps_b: st.PointStore, kf_b, max_dist: float = 60.0):
    """3D-3D correspondences between keyframe `kf_a` of map a and `kf_b` of
    map b through the landmarks' own descriptors (mutual nearest neighbours,
    ratio 0.9). Returns (x [S,3] map-a points, y [S,3] map-b points, idx_b [S]
    map-b landmark ids or -1, mask [S])."""
    _, va, da, xa = _observed(ks_a, ps_a, kf_a)
    ib, vb, db, _ = _observed(ks_b, ps_b, kf_b)
    dist = matching.hamming_matrix(da, db)
    idx, _, ok = matching.match_nn(dist, va, vb, max_dist=max_dist, ratio=0.9)
    ok = matching.mutual_consistency(idx, ok, dist, va, vb)
    ib_m = ib[idx.long()]
    xb = ps_b.x[torch.clamp(ib_m, min=0).long()]
    ok = ok & va & vb[idx.long()]
    return xa, xb, torch.where(ok, ib_m, torch.full_like(ib_m, -1)), ok


def match_kf_landmarks(kstore: st.KeyFrameStore, pstore: st.PointStore, kf_a, kf_b, max_dist: float = 60.0):
    """match_cross_map within one map. Returns (x, y, mask)."""
    xa, xb, _, ok = match_cross_map(kstore, pstore, kf_a, kstore, pstore, kf_b, max_dist)
    return xa, xb, ok


def scene_scaled_thresh(x, mask, frac: float = 0.06, floor: float = 1e-3):
    """RANSAC inlier threshold: `frac` of the matched cloud's median spread."""
    c = torch.sum(torch.where(mask[:, None], x, torch.zeros_like(x)), dim=0) / torch.clamp(mask.sum(), min=1)
    spread = nanmedian(torch.linalg.norm(x - c, dim=-1), mask)
    spread = torch.where(torch.isfinite(spread), spread, torch.ones_like(spread))
    return torch.clamp(frac * spread, min=floor)


def projection_support(cam, kstore: st.KeyFrameStore, pstore: st.PointStore, kf_obs, kf_src, R_rel, t_rel, s_rel,
                       radius: float = 10.0, max_dist: float = 60.0):
    """Count `kf_src`'s landmarks that, mapped into the current region by the
    inverse of the verified Sim3 (x_loop = s R x_cur + t) and projected into
    `kf_obs`'s camera, land on one of `kf_obs`'s observed landmarks (window
    and descriptor gate). Slots are host ints or 0-d device ints."""
    _, va, da, X_loop = _observed(kstore, pstore, kf_src)
    Ri, ti, si = lie.sim3_inverse(R_rel, t_rel, torch.as_tensor(s_rel, dtype=R_rel.dtype, device=R_rel.device))
    X_cur = si * lie._einsum("ij,nj->ni", Ri, X_loop) + ti
    xc = lie._einsum("ij,nj->ni", row(kstore.R, kf_obs), X_cur) + row(kstore.t, kf_obs)
    uv = cam_ops.project(cam, xc)
    va = va & (xc[:, 2] > 0.1) & cam_ops.in_image(cam, uv, margin=-radius)
    _, vb, db, _ = _observed(kstore, pstore, kf_obs)
    gate = matching.window_gate(uv, row(kstore.obs_uvr, kf_obs)[:, :2], radius) & vb[None, :]
    _, _, ok = matching.match_nn(matching.hamming_matrix(da, db), va, vb, gate, max_dist=max_dist)
    return torch.sum(ok.to(torch.int32))


def apply_loop_correction(kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore, kf_cur: int,
                          kf_loop: int, R_rel, t_rel, cfg: SlamConfig, inertial: bool = False, s_rel=None):
    """Essential-graph correction (chain + covisibility edges + the loop
    edge, weight 5) and landmark re-anchoring: every landmark moves with its
    last-observing keyframe. `inertial` runs the 4-DoF graph; `s_rel` (mono)
    the 7-DoF sim3 graph, the poses SE3-ified after (t /= s); otherwise SE3.
    `kf_cur` and `kf_loop` are host ints or 0-d device ints."""
    K = kstore.R.shape[0]
    dev, dt_ = kstore.R.device, kstore.R.dtype
    valid = kstore.valid
    with_scale = s_rel is not None
    one = torch.ones((), dtype=dt_, device=dev)
    s_rel = one if s_rel is None else torch.as_tensor(s_rel, dtype=dt_, device=dev)
    ones = torch.ones(K, dtype=dt_, device=dev)
    chain = pgo.chain_edges(kstore.R, kstore.t, ones, valid)
    covis = pgo.covis_edges(kstore.R, kstore.t, ones, valid, kstore.covis)
    ci, cj, cR, ct, cs, cmask = (torch.cat([a, b]) for a, b in zip(chain, covis))
    # the loop edge: x_loop = s R x_cur + t, so S_cur' = T_cur o S^-1 and the
    # measured S_cur,loop = T_cur o S^-1 o T_loop^-1 (camera poses with s = 1)
    R_s_inv, t_s_inv, s_s_inv = lie.sim3_inverse(R_rel, t_rel, s_rel)
    Rc, tc, sc = lie.sim3_compose(row(kstore.R, kf_cur), row(kstore.t, kf_cur), one, R_s_inv, t_s_inv, s_s_inv)
    Rl_inv, tl_inv = lie.se3_inverse(row(kstore.R, kf_loop), row(kstore.t, kf_loop))
    Rm, tm, sm = lie.sim3_compose(Rc, tc, sc, Rl_inv, tl_inv, one)

    def cat1(a, b):
        return torch.cat([a, b[None]])

    graph = pgo.PoseGraph(
        R=kstore.R, t=kstore.t, s=ones, node_mask=valid, fixed_mask=set_row(~valid, kf_loop, True),
        e_i=cat1(ci, _dev_int(kf_loop, dev)),
        e_j=cat1(cj, _dev_int(kf_cur, dev)),
        e_R=cat1(cR, Rm), e_t=cat1(ct, tm), e_s=cat1(cs, sm),
        e_weight=cat1(torch.ones(ci.shape[0], dtype=dt_, device=dev), 5.0 * one),
        e_mask=cat1(cmask, torch.ones((), dtype=torch.bool, device=dev)))
    mode = "4dof" if inertial else ("sim3" if with_scale else "se3")
    out = pgo.optimize(graph, iters=cfg.opt.pgo_iters, mode=mode)

    # landmark re-anchoring: X' = S_new(k)^-1 T_old(k) X, k = the landmark's last keyframe
    R_old, t_old = kstore.R, kstore.t
    R_new, t_new, s_new = out.R, out.t, out.s
    Rw_new = R_new.transpose(-1, -2)

    def correct_points(x, ref_kf, valid_lm):
        k = ref_kf.long()
        x_c = torch.einsum("kij,kj->ki", R_old[k], x) + t_old[k]
        x_n = torch.einsum("kij,kj->ki", Rw_new[k], x_c - t_new[k]) / s_new[k][:, None]
        return torch.where(valid_lm[:, None], x_n, x)

    ref_pt = torch.clamp(pstore.last_kf, 0, K - 1)
    pstore = dataclasses.replace(pstore, x=correct_points(pstore.x, ref_pt, pstore.valid))
    ref_ln = torch.clamp(lstore.last_kf, 0, K - 1)
    lstore = dataclasses.replace(lstore, seg=torch.cat([correct_points(lstore.seg[:, :3], ref_ln, lstore.valid),
                                                        correct_points(lstore.seg[:, 3:], ref_ln, lstore.valid)], -1))
    # SE3-ify: [sR | t] ~ [R | t/s]
    kstore = dataclasses.replace(kstore, R=R_new, t=t_new / s_new[:, None])
    return kstore, pstore, lstore


def loop_match(kstore: st.KeyFrameStore, pstore: st.PointStore, kf_cur, kf_cand):
    """Stage `loop_match`: the 3D-3D correspondences of keyframes `kf_cur` and
    `kf_cand` (0-d device ints), the RANSAC's scene-scaled threshold and its
    sampling weights. Returns (x, y, mask, thresh, probs)."""
    x, y, m = match_kf_landmarks(kstore, pstore, kf_cur, kf_cand)
    return x, y, m, scene_scaled_thresh(x, m), sim3.mask_probs(m)


def loop_verify(cam, cfg: SlamConfig, with_scale: bool, kstore: st.KeyFrameStore, pstore: st.PointStore, x, y, m,
                thresh, hyp, kf_cur, kf_prev, kf_cand):
    """Stage `loop_verify`: the Sim3 / SE3 RANSAC over `loop_match`'s
    correspondences on the drawn triplets `hyp`, then the projection
    re-check of the candidate's landmarks onto the current keyframe and onto
    `kf_prev` (the one before it). Returns (R, t, s, read): `read` is int32
    (RANSAC inliers, support on the current keyframe, on the previous)."""
    R_rel, t_rel, s_rel, _, n_in = sim3.ransac_sim3(x, y, m, hyp, inlier_thresh=thresh, with_scale=with_scale)
    radius = cfg.loop.proj_radius_px
    n_cur = projection_support(cam, kstore, pstore, kf_cur, kf_cand, R_rel, t_rel, s_rel, radius=radius)
    n_prev = projection_support(cam, kstore, pstore, kf_prev, kf_cand, R_rel, t_rel, s_rel, radius=radius)
    return R_rel, t_rel, s_rel, torch.stack([n.to(torch.int32) for n in (n_in, n_cur, n_prev)])


def merge_match(kstore: st.KeyFrameStore, pstore: st.PointStore, kf_slot, dst_kstore: st.KeyFrameStore,
                dst_pstore: st.PointStore, kf_dst):
    """Stage `merge_match`: the Atlas merge's 3D-3D correspondences between
    the active map's keyframe `kf_slot` and the parked map's `kf_dst` (0-d
    device ints; the reference's `_match_cross_j`) and the RANSAC's sampling
    weights. Returns (x, y, idx_b, mask, probs)."""
    xa, xb, idx_b, m = match_cross_map(kstore, pstore, kf_slot, dst_kstore, dst_pstore, kf_dst)
    return xa, xb, idx_b, m, sim3.mask_probs(m)


def merge_verify(kstore: st.KeyFrameStore, kf_slot, x, y, idx_b, m, hyp):
    """Stage `merge_verify`: the SE3 RANSAC over `merge_match`'s
    correspondences on the drawn triplets `hyp` at the scene-scaled
    threshold (the reference's `_ransac_merge_j`), and the fusion pairs its
    inliers give: the active keyframe's landmark and the parked one, -1
    elsewhere. Returns (R, t, fuse_src, fuse_dst, read): `read` is the
    inlier count, int32 [1]."""
    R_rel, t_rel, _, inl, n_in = sim3.ransac_sim3(x, y, m, hyp, inlier_thresh=scene_scaled_thresh(x, m),
                                                  with_scale=False)
    neg = torch.full_like(idx_b, -1)
    fuse_src = torch.where(inl, row(kstore.obs_pt, kf_slot), neg)
    return R_rel, t_rel, fuse_src, torch.where(inl, idx_b, neg), n_in.to(torch.int32).reshape(1)


def loop_correct(cfg: SlamConfig, mode: str, kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore,
                 kf_cur, kf_loop, R_rel, t_rel, s_rel, R, t):
    """Stage `loop_correct`: `apply_loop_correction` in `mode` ("se3",
    "4dof" or "sim3"; `s_rel` is used in "sim3" only), and the live pose
    (R, t) carried by keyframe `kf_cur`'s rigid delta. Returns (kstore,
    pstore, lstore, R, t)."""
    R_kf0, t_kf0 = row(kstore.R, kf_cur), row(kstore.t, kf_cur)
    kstore, pstore, lstore = apply_loop_correction(kstore, pstore, lstore, kf_cur, kf_loop, R_rel, t_rel, cfg,
                                                   inertial=mode == "4dof", s_rel=s_rel if mode == "sim3" else None)
    R, t = carry_pose(kstore, kf_cur, R_kf0, t_kf0, R, t)
    return kstore, pstore, lstore, R, t


def carry_pose(kstore: st.KeyFrameStore, kf, R_kf0, t_kf0, R, t):
    """The live pose (R, t) moved by the rigid delta that took keyframe `kf`
    from (R_kf0, t_kf0) to its pose in `kstore`."""
    R_d = lie._mm(row(kstore.R, kf), R_kf0.T)
    t_d = row(kstore.t, kf) - lie._einsum("ij,j->i", R_d, t_kf0)
    return lie._mm(R_d, R), lie._einsum("ij,j->i", R_d, t) + t_d


class LoopCloser:
    """Host-side loop closing state machine: the temporal-consistency
    counter and, on a confirmed hit, verification, correction and the
    global BA."""

    def __init__(self, cfg: SlamConfig, draw=None):
        self.cfg = cfg
        self._consistent_with = -1
        self._consistency = 0
        self.n_loops_closed = 0
        self._last_closed_kf = -10 ** 9
        # pure mono accumulates scale drift: Sim3 scale and the 7-DoF graph;
        # every other sensor is metric and the loop is rigid
        self.with_scale = cfg.sensor == "mono"
        self.draw = sim3.sample_indices if draw is None else draw

    def warm_up(self, tracker) -> float:
        """Run each stage a closure uses once on `tracker`'s stores, results
        dropped: `loop_match`, `loop_verify` and `loop_correct` in every mode
        the tracker can reach, and a "gba" chunk (`iters` gba_chunk_iters
        under graphs, else one iteration). The first closure in a process
        otherwise pays for loading their kernels and creating the solver
        handles (9-15 s on an H100, against ~2 s warm) and, under graphs, for
        capturing them. Returns its wall time in ms, the device synchronised
        at the end."""
        t0 = time.perf_counter()
        ks, ps, ls, dev = tracker.kstore, tracker.pstore, tracker.lstore, tracker.device
        R_rel, t_rel, s_rel = self._verify(tracker, 1, 0, 0)[:3]
        for mode in self.modes(tracker.use_imu):
            self._stages(tracker)["loop_correct"](mode, ks, ps, ls, _dev_int(1, dev), _dev_int(0, dev), R_rel, t_rel,
                                                  s_rel, tracker.R, tracker.t)
        if self.cfg.loop.run_gba:
            iters = max(self.cfg.loop.gba_chunk_iters, 1) if tracker.cuda_graphs else 1
            tracker._stages["gba"](ks, ps, ls, iters)
        if ks.R.device.type == "cuda":
            torch.cuda.synchronize(ks.R.device)
        return (time.perf_counter() - t0) * 1e3

    def modes(self, use_imu: bool) -> tuple[str, ...]:
        """The correction modes a tracker with (`use_imu`) or without an IMU can reach."""
        if self.with_scale:
            return ("sim3",)
        return ("se3", "4dof") if use_imu else ("se3",)

    def _stages(self, tracker) -> dict:
        """The tracker's stage programs ("loop_match", "loop_verify",
        "loop_correct"); for a stand-in that carries none (tests drive the
        closer on bare stores), the same stage bodies, run eagerly."""
        stages = getattr(tracker, "_stages", None)
        if stages is not None:
            return stages
        cfg = self.cfg
        return {"loop_match": loop_match,
                "loop_verify": partial(loop_verify, tracker.cam, cfg, self.with_scale),
                "loop_correct": partial(loop_correct, cfg)}

    def _verify(self, tracker, kf_slot: int, cand: int, seed: int):
        """`loop_match`, the draw, `loop_verify` for keyframe `kf_slot` against
        `cand`: (R, t, s, (RANSAC inliers, support on the current keyframe,
        on the previous one))."""
        stages, dev = self._stages(tracker), tracker.kstore.R.device
        kf, kc = _dev_int(kf_slot, dev), _dev_int(cand, dev)
        x, y, m, thresh, probs = stages["loop_match"](tracker.kstore, tracker.pstore, kf, kc)
        hyp = self.draw(seed, probs, (self.cfg.loop.sim3_hypotheses, 3))
        R_rel, t_rel, s_rel, read = stages["loop_verify"](tracker.kstore, tracker.pstore, x, y, m, thresh, hyp, kf,
                                                          _dev_int(max(kf_slot - 1, 0), dev), kc)
        n_in, n_cur, n_prev = read.tolist()  # the candidate's one read
        return R_rel, t_rel, s_rel, (n_in, n_cur, n_cur if kf_slot < 1 else n_prev)

    def on_keyframe(self, tracker, kf_slot: int, candidates) -> bool:
        """Consume keyframe `kf_slot`'s loop candidates ((slot, bow score),
        best first). Returns True if a loop was verified and closed (the
        tracker's stores and live pose updated in place)."""
        cfg = self.cfg
        if kf_slot - self._last_closed_kf < cfg.loop.min_kf_gap:
            return False
        candidates = [(s, sc) for s, sc in candidates if s >= 0 and sc >= 0.15]
        if not candidates:
            self._consistency = 0
            self._consistent_with = -1
            return False
        # temporal consistency: some candidate persists near the same past keyframe
        best = -1
        for s, _ in candidates:
            if self._consistent_with >= 0 and abs(s - self._consistent_with) <= 3:
                best = s
                break
        if best >= 0:
            self._consistency += 1
            self._consistent_with = best
        else:
            self._consistency = 1
            self._consistent_with = candidates[0][0]
        if self._consistency < cfg.loop.consistency_kfs:
            return False
        with tracker.span("loop"):
            return self._verify_and_close(tracker, kf_slot, candidates)

    def _verify_and_close(self, tracker, kf_slot: int, candidates) -> bool:
        """Close the loop at the first candidate that passes verification."""
        cfg = self.cfg
        # geometric verification of each candidate, best first: 3D-3D RANSAC,
        # then the stricter projection re-check onto the current and previous keyframes
        verified = None
        for s, _ in candidates:
            R_rel, t_rel, s_rel, (n_in, n_cur, n_prev) = self._verify(tracker, kf_slot, s, kf_slot * 7 + s)
            if n_in < cfg.loop.sim3_min_inliers:
                continue
            if n_cur >= cfg.loop.proj_min_inliers and n_prev >= cfg.loop.proj_min_inliers // 2:
                verified = (s, R_rel, t_rel, s_rel)
                break
        if verified is None:
            return False
        best, R_rel, t_rel, s_rel = verified

        inertial = bool(tracker.imu_ready)
        mode = "sim3" if self.with_scale else ("4dof" if inertial else "se3")
        # the live pose rides the same rigid delta as keyframe kf_slot
        R_kf0, t_kf0, R0, t0 = tracker.kstore.R[kf_slot], tracker.kstore.t[kf_slot], tracker.R, tracker.t
        dev = tracker.kstore.R.device
        tracker.kstore, tracker.pstore, tracker.lstore, tracker.R, tracker.t = self._stages(tracker)["loop_correct"](
            mode, tracker.kstore, tracker.pstore, tracker.lstore, _dev_int(kf_slot, dev), _dev_int(best, dev), R_rel,
            t_rel, s_rel, tracker.R, tracker.t)
        # global BA over the corrected map: by default amortized, one chunk per later frame
        if cfg.loop.run_gba and cfg.loop.gba_amortize:
            tracker._queue_gba(inertial)
        elif cfg.loop.run_gba:
            # the BA at once, then the delta of the keyframe's pose across correction and BA
            tracker.R, tracker.t = R0, t0
            if inertial:
                tracker._full_inertial_ba()
            else:
                tracker.kstore, tracker.pstore, tracker.lstore = tracker._stages["gba"](
                    tracker.kstore, tracker.pstore, tracker.lstore, cfg.opt.gba_iters)
            tracker.R, tracker.t = carry_pose(tracker.kstore, kf_slot, R_kf0, t_kf0, tracker.R, tracker.t)
        tracker._reset_motion()
        tracker._map_event_cooldown = 5  # widened matching while re-locking
        self.n_loops_closed += 1
        self._last_closed_kf = kf_slot
        self._consistency = 0
        self._consistent_with = -1
        return True
