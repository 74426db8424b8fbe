"""Loop closing: BoW detection -> geometric verification -> graph correction
(port of pli_slam_tpu.frontend.loop_closing).

Detection runs inside the fused per-frame step (the BoW add and query of
`frontend.step._index_keyframe`); the candidates reach `LoopCloser` through
the step's stats vector. On the host, per keyframe: a temporal-consistency
counter; on a confirmed hit, 3D-3D landmark matching, batched Sim3/SE3
RANSAC (`solve.sim3`) and the projection re-check; then the essential-graph
PGO (`solve.pgo`) with landmark re-anchoring, line endpoints included, and
the global BA, queued on the tracker as per-frame chunks.

`LoopCloser.warm_up` runs each of those solvers once on empty stores of
the real shapes; `Tracker` calls it at construction on a GPU, so that the
first closure in a process does not pay for loading their kernels.

Random draws go through `LoopCloser.draw` (default `solve.sim3.sample_indices`,
seeded with the reference's `kf_slot * 7 + candidate`); a parity test can
hand in the reference's own draw instead.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie, matching
from pli_slam_tpu_torch.ops.indexing import nanmedian
from pli_slam_tpu_torch.solve import pgo, sim3
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.worldmap import stores as st


def _observed(kstore, pstore, kf):
    """(landmark ids [S], valid [S], descriptors [S,256], positions [S,3]) of keyframe `kf`'s observations."""
    ids = kstore.obs_pt[kf]
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
    and descriptor gate)."""
    _, va, da, X_loop = _observed(kstore, pstore, kf_src)
    Ri, ti, si = lie.sim3_inverse(R_rel, t_rel, torch.as_tensor(s_rel, dtype=R_rel.dtype, device=R_rel.device))
    X_cur = si * lie._einsum("ij,nj->ni", Ri, X_loop) + ti
    xc = lie._einsum("ij,nj->ni", kstore.R[kf_obs], X_cur) + kstore.t[kf_obs]
    uv = cam_ops.project(cam, xc)
    va = va & (xc[:, 2] > 0.1) & cam_ops.in_image(cam, uv, margin=-radius)
    _, vb, db, _ = _observed(kstore, pstore, kf_obs)
    gate = matching.window_gate(uv, kstore.obs_uvr[kf_obs][:, :2], radius) & vb[None, :]
    _, _, ok = matching.match_nn(matching.hamming_matrix(da, db), va, vb, gate, max_dist=max_dist)
    return torch.sum(ok.to(torch.int32))


def apply_loop_correction(kstore: st.KeyFrameStore, pstore: st.PointStore, lstore: st.LineStore, kf_cur: int,
                          kf_loop: int, R_rel, t_rel, cfg: SlamConfig, inertial: bool = False, s_rel=None):
    """Essential-graph correction (chain + covisibility edges + the loop
    edge, weight 5) and landmark re-anchoring: every landmark moves with its
    last-observing keyframe. `inertial` runs the 4-DoF graph; `s_rel` (mono)
    the 7-DoF sim3 graph, the poses SE3-ified after (t /= s); otherwise SE3."""
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
    Rc, tc, sc = lie.sim3_compose(kstore.R[kf_cur], kstore.t[kf_cur], one, R_s_inv, t_s_inv, s_s_inv)
    Rl_inv, tl_inv = lie.se3_inverse(kstore.R[kf_loop], kstore.t[kf_loop])
    Rm, tm, sm = lie.sim3_compose(Rc, tc, sc, Rl_inv, tl_inv, one)

    def cat1(a, b):
        return torch.cat([a, b[None]])

    i32 = torch.int32
    fixed = ~valid
    fixed[kf_loop] = True
    graph = pgo.PoseGraph(
        R=kstore.R, t=kstore.t, s=ones, node_mask=valid, fixed_mask=fixed,
        e_i=cat1(ci, torch.tensor(kf_loop, dtype=i32, device=dev)),
        e_j=cat1(cj, torch.tensor(kf_cur, dtype=i32, device=dev)),
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
        """Run each solver a closure uses once on `tracker`'s stores, results
        dropped: 3D-3D matching, RANSAC, the projection re-check, the
        essential-graph PGO in every mode the tracker can reach (one
        iteration each, on the [7K, 7K] system of the real K) and one
        whole-map BA iteration. The first closure in a process otherwise
        pays for loading these kernels and creating the solver handles
        (9-15 s on an H100, against ~2 s warm). Returns its wall time in ms,
        the device synchronised at the end."""
        t0 = time.perf_counter()
        cfg = dataclasses.replace(self.cfg, opt=dataclasses.replace(self.cfg.opt, pgo_iters=1))
        ks, ps, ls = tracker.kstore, tracker.pstore, tracker.lstore
        x, y, m = match_kf_landmarks(ks, ps, 1, 0)
        R_rel, t_rel, s_rel, _, _ = self._ransac(x, y, m, 0)
        projection_support(tracker.cam, ks, ps, 1, 0, R_rel, t_rel, s_rel, radius=cfg.loop.proj_radius_px)
        for inertial in (False, True) if tracker.use_imu else (False,):
            apply_loop_correction(ks, ps, ls, 1, 0, R_rel, t_rel, cfg, inertial=inertial,
                                  s_rel=s_rel if self.with_scale else None)
        if cfg.loop.run_gba:
            from pli_slam_tpu_torch.frontend.step import global_ba

            global_ba(tracker.cam, cfg, ks, ps, ls, iters=1)
        if ks.R.device.type == "cuda":
            torch.cuda.synchronize(ks.R.device)
        return (time.perf_counter() - t0) * 1e3

    def _ransac(self, x, y, m, seed: int):
        idx = self.draw(seed, sim3.mask_probs(m), (self.cfg.loop.sim3_hypotheses, 3))
        return sim3.ransac_sim3(x, y, m, idx, inlier_thresh=scene_scaled_thresh(x, m), with_scale=self.with_scale)

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
            x, y, m = match_kf_landmarks(tracker.kstore, tracker.pstore, kf_slot, s)
            R_rel, t_rel, s_rel, _, n_in = self._ransac(x, y, m, kf_slot * 7 + s)
            if int(n_in) < cfg.loop.sim3_min_inliers:
                continue
            n_cur = int(projection_support(tracker.cam, tracker.kstore, tracker.pstore, kf_slot, s, R_rel, t_rel,
                                           s_rel, radius=cfg.loop.proj_radius_px))
            n_prev = int(projection_support(tracker.cam, tracker.kstore, tracker.pstore, max(kf_slot - 1, 0), s,
                                            R_rel, t_rel, s_rel, radius=cfg.loop.proj_radius_px)) if kf_slot >= 1 \
                else n_cur
            if n_cur >= cfg.loop.proj_min_inliers and n_prev >= cfg.loop.proj_min_inliers // 2:
                verified = (s, R_rel, t_rel, s_rel)
                break
        if verified is None:
            return False
        best, R_rel, t_rel, s_rel = verified

        inertial = bool(tracker.imu_ready)
        # the live pose rides the same rigid delta as keyframe kf_slot
        R_kf0, t_kf0 = tracker.kstore.R[kf_slot], tracker.kstore.t[kf_slot]
        tracker.kstore, tracker.pstore, tracker.lstore = apply_loop_correction(
            tracker.kstore, tracker.pstore, tracker.lstore, kf_slot, best, R_rel, t_rel, cfg, inertial=inertial,
            s_rel=s_rel if self.with_scale else None)
        # global BA over the corrected map: by default amortized, one chunk per later frame
        if cfg.loop.run_gba:
            if cfg.loop.gba_amortize:
                tracker._queue_gba(inertial)
            elif inertial:
                tracker._full_inertial_ba()
            else:
                from pli_slam_tpu_torch.frontend.step import global_ba

                tracker.kstore, tracker.pstore, tracker.lstore = global_ba(
                    tracker.cam, cfg, tracker.kstore, tracker.pstore, tracker.lstore)
        R_d = lie._mm(tracker.kstore.R[kf_slot], R_kf0.T)
        t_d = tracker.kstore.t[kf_slot] - lie._einsum("ij,j->i", R_d, t_kf0)
        tracker.t = lie._einsum("ij,j->i", R_d, tracker.t) + t_d
        tracker.R = lie._mm(R_d, tracker.R)
        tracker._reset_motion()
        tracker._map_event_cooldown = 5  # widened matching while re-locking
        self.n_loops_closed += 1
        self._last_closed_kf = kf_slot
        self._consistency = 0
        self._consistent_with = -1
        return True
