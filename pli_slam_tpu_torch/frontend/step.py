"""The per-frame device programs (port of the device half of
pli_slam_tpu/frontend/tracker.py:48-1445).

`make_step_visual` is the visual step of the stereo and RGB-D paths;
`make_step_vi` is its inertial analog after IMU initialization
(preintegrate, IMU prediction, `track_step_inertial`, and on a keyframe the
chain factor and `local_inertial_ba`). The monocular path is
host-orchestrated and adds `_mono_reconstruct` (two-view initialization)
and `_mono_triangulated_depths`. Every point match -- twice per frame in
tracking and once per keyframe in the fuse step, on every path -- goes
through `ops.kernels.hamming.gated_match`, the
hand-written CUDA kernel on a GPU and its plain twin on the CPU. Both
call sites follow the reference's accelerator branch on every device
(tracker.py:82-89 and :375-389): the direct du^2+dv^2 gate inside the
match, and for the fuse the depth band checked on the single winner
afterwards. (The reference's CPU branch puts the depth band inside the
argmin gate instead, so on the CPU the two packages fuse differently;
the parity tests run the reference's accelerator branch.)

Control flow. The reference's `jax.lax.cond` on `need_kf`
(tracker.py:1186) and on `n_kf2 >= 3` (:1102) are host `if`s here. The
keyframe decision needs the frame's match outcome, so each frame makes
exactly one device->host read (ok, inlier count, reference-KF inliers:
three int32s); everything downstream of it is known on the host
(keyframe count, frames since keyframe) or stays on the device. That
one sync per frame is accepted for bring-up; CUDA graphs and an
asynchronous keyframe branch are later work. GN and BA `fori_loop`s are
Python loops (solve.gn, solve.ba).

Index semantics. JAX clamps gathers and wraps negative scatter indices;
every gather here clamps explicitly (`clamp(idx, min=0)`), sentinel
padding (`_local_map_ids`, `_compact_ids`) is masked before use, and
repeated scatter indices go through `ops.indexing.scatter_set`
(last write wins, as on XLA's CPU backend).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend.frame import FrameData
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie, matching
from pli_slam_tpu_torch.ops.indexing import nanmedian, scatter_add, scatter_set, top_k, unique_fixed
from pli_slam_tpu_torch.ops.kernels.hamming import gated_match
from pli_slam_tpu_torch.ops.lines import _deg2rad_f32
from pli_slam_tpu_torch.solve import ba as ba_mod
from pli_slam_tpu_torch.solve import gn
from pli_slam_tpu_torch.solve import inertial as inr
from pli_slam_tpu_torch.solve import triangulate as tri
from pli_slam_tpu_torch.solve import twoview
from pli_slam_tpu_torch.solve import vi_ba as vib
from pli_slam_tpu_torch.worldmap import stores as st
from pli_slam_tpu_torch.worldmap import vocab as vocab_mod

N_TRI_VIEWS = 3
ST_OK, ST_NIN, ST_NKF, ST_KF_CREATED, ST_NNEW, ST_NPTS, ST_NLNS = 0, 1, 2, 3, 4, 5, 6
ST_FSKF, ST_LASTKFIN, ST_LOOP_SLOT, ST_LOOP_SCORE, ST_KF_SLOT = 7, 8, 9, 12, 15
N_LOOP_CANDS = 3


def _f32(x) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Tracking
# ---------------------------------------------------------------------------


def _match_points_against_store(cam, cfg, frame: FrameData, R, t, pstore: st.PointStore, radius, local_ids=None):
    """Gated match of the frame's features against the point store (or the
    local-map subset `local_ids`, [C] int32, -1 padded). Returns (idx in
    global store slots, ok, (row_ids, frustum_rows))."""
    if local_ids is None:
        x, desc, valid, row_ids = pstore.x, pstore.desc, pstore.valid, None
    else:
        safe = torch.clamp(local_ids, min=0).long()
        x = pstore.x[safe]
        desc = pstore.desc[safe]
        valid = pstore.valid[safe] & (local_ids >= 0)
        row_ids = local_ids
    xc = lie._einsum("ij,pj->pi", R, x) + t
    uv_proj = cam_ops.project(cam, xc)
    frustum = valid & (xc[:, 2] > 0.1) & cam_ops.in_image(cam, uv_proj, margin=-radius)
    idx, best, ok = gated_match(frame.feats.desc, frame.feats.uv, frame.feats.valid, desc, uv_proj, frustum,
                                radius, max_dist=cfg.match.orb_th_high, ratio=cfg.match.nn_ratio)
    ok = matching.dedup_matches(idx, best, ok, x.shape[0])
    if local_ids is not None:
        idx = torch.where(ok, local_ids[torch.clamp(idx, min=0).long()], torch.full_like(idx, -1))
    return idx, ok, (row_ids, frustum)


def _match_lines_against_store(cam, cfg, frame: FrameData, R, t, lstore: st.LineStore, radius):
    xs_c = lie._einsum("ij,pj->pi", R, lstore.seg[:, :3]) + t
    xe_c = lie._einsum("ij,pj->pi", R, lstore.seg[:, 3:]) + t
    uv_s = cam_ops.project(cam, xs_c)
    uv_e = cam_ops.project(cam, xe_c)
    mid_proj = 0.5 * (uv_s + uv_e)
    infront = (xs_c[:, 2] > 0.1) & (xe_c[:, 2] > 0.1)
    frustum = lstore.valid & infront & cam_ops.in_image(cam, mid_proj, margin=-2 * radius)
    ang_proj = torch.atan2(uv_e[:, 1] - uv_s[:, 1], uv_e[:, 0] - uv_s[:, 0])
    da = torch.abs(frame.lines.angle[:, None] - ang_proj[None, :])
    da = torch.minimum(da, 2 * np.pi - da)
    da = torch.minimum(da, np.pi - da)
    gate = (matching.window_gate(frame.lines.midpoint(), mid_proj, 2.0 * radius)
            & (da <= _deg2rad_f32(12.0)) & frustum[None, :])
    dist = matching.hamming_matrix(frame.lines.desc, lstore.desc)
    idx, best, ok = matching.match_nn(dist, frame.lines.valid, lstore.valid, gate, max_dist=90.0, ratio=0.95)
    ok = matching.dedup_matches(idx, best, ok, lstore.seg.shape[0])
    return idx, ok, frustum


def _pose_obs_from_matches(cfg, frame: FrameData, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok):
    uvr = torch.cat([frame.feats.uv, frame.u_right[:, None]], dim=-1)
    safe_pt = torch.clamp(pt_idx, min=0).long()
    safe_ln = torch.clamp(ln_idx, min=0).long()
    return gn.PoseObservations(
        x_w=pstore.x[safe_pt], uvr=uvr, stereo_mask=frame.stereo_ok,
        point_mask=pt_ok & frame.feats.valid, sigma2_pt=frame.sigma2,
        xs_w=lstore.seg[safe_ln, :3], xe_w=lstore.seg[safe_ln, 3:],
        l_obs=frame.lines.line_coeffs(), line_mask=ln_ok & frame.lines.valid,
        sigma2_ln=torch.full_like(frame.lines.angle, cfg.lines.sigma_px ** 2),
    )


def track_step(cam, cfg: SlamConfig, frame: FrameData, R0, t0, pstore: st.PointStore, lstore: st.LineStore,
               wide, local_pt_ids=None):
    """Two-round match + solve. `wide` (device bool) triples the round-1
    window. Returns (R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore)."""
    rad = cfg.match.search_radius_px
    r1 = torch.where(wide, _f32(3.0 * rad), _f32(rad))  # 0-d float32 on the device
    pt_idx, pt_ok, _ = _match_points_against_store(cam, cfg, frame, R0, t0, pstore, r1, local_pt_ids)
    ln_idx, ln_ok, _ = _match_lines_against_store(cam, cfg, frame, R0, t0, lstore, r1)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    res1 = gn.solve_pose(cam, obs, R0, t0, cfg.opt)

    r2 = max(rad * 0.4, 4.0)
    pt_idx, pt_ok, pt_frust = _match_points_against_store(cam, cfg, frame, res1.R_cw, res1.t_cw, pstore, r2, local_pt_ids)
    ln_idx, ln_ok, ln_frust = _match_lines_against_store(cam, cfg, frame, res1.R_cw, res1.t_cw, lstore, r2)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    res2 = gn.solve_pose(cam, obs, res1.R_cw, res1.t_cw, cfg.opt)

    pt_in = pt_ok & res2.inlier_pt
    ln_in = ln_ok & res2.inlier_ln
    pstore, lstore, n_in = _count_seen_and_found(pstore, lstore, pt_frust, ln_frust, pt_idx, pt_in, ln_idx, ln_in)
    return res2.R_cw, res2.t_cw, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore


def _count_seen_and_found(pstore, lstore, pt_frust, ln_frust, pt_idx, pt_in, ln_idx, ln_in):
    """The landmark statistics a tracking step leaves behind: `visible` for
    what lay in the frustum, `found` for the inliers. Returns the stores and
    the inlier count."""
    frust_ids, frust_rows = pt_frust
    if frust_ids is None:
        visible = pstore.visible + frust_rows.to(torch.int32)
    else:
        visible = scatter_add(pstore.visible, torch.clamp(frust_ids, min=0),
                              (frust_rows & (frust_ids >= 0)).to(torch.int32))
    pstore = dataclasses.replace(
        pstore, visible=visible,
        found=scatter_add(pstore.found, torch.clamp(pt_idx, min=0), pt_in.to(torch.int32)))
    lstore = dataclasses.replace(
        lstore, visible=lstore.visible + ln_frust.to(torch.int32),
        found=scatter_add(lstore.found, torch.clamp(ln_idx, min=0), ln_in.to(torch.int32)))
    n_in = torch.sum(pt_in.to(torch.int32)) + torch.sum(ln_in.to(torch.int32))
    return pstore, lstore, n_in


def track_step_inertial(cam, cfg: SlamConfig, frame: FrameData, preint, prev_state, init_state, gravity_w, ext,
                        pstore: st.PointStore, lstore: st.LineStore, local_pt_ids=None, wide=False):
    """Inertial analog of track_step: the 15-dof state is solved with the
    preintegration factor in the loop. `wide` (a bool, or a 0-d device bool)
    triples the round-1 window, for the frames after a map-changing event.
    Returns (state, R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore)."""
    R0, t0 = inr.camera_pose(init_state, ext)
    rad = cfg.match.search_radius_px
    if isinstance(wide, torch.Tensor):
        r1 = torch.where(wide, _f32(3.0 * rad), _f32(rad))
    else:
        r1 = _f32(3.0 * rad) if wide else _f32(rad)
    pt_idx, pt_ok, _ = _match_points_against_store(cam, cfg, frame, R0, t0, pstore, r1, local_pt_ids)
    ln_idx, ln_ok, _ = _match_lines_against_store(cam, cfg, frame, R0, t0, lstore, r1)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    st1, _, _, _ = inr.solve_pose_inertial(cam, ext, obs, preint, prev_state, init_state, cfg.opt, cfg.imu,
                                           gravity_w=gravity_w)

    R1, t1 = inr.camera_pose(st1, ext)
    r2 = max(rad * 0.4, 4.0)
    pt_idx, pt_ok, pt_frust = _match_points_against_store(cam, cfg, frame, R1, t1, pstore, r2, local_pt_ids)
    ln_idx, ln_ok, ln_frust = _match_lines_against_store(cam, cfg, frame, R1, t1, lstore, r2)
    obs = _pose_obs_from_matches(cfg, frame, pstore, lstore, pt_idx, pt_ok, ln_idx, ln_ok)
    st2, in_pt, in_ln, _ = inr.solve_pose_inertial(cam, ext, obs, preint, prev_state, st1, cfg.opt, cfg.imu,
                                                   gravity_w=gravity_w)
    pt_in = pt_ok & in_pt
    ln_in = ln_ok & in_ln
    pstore, lstore, n_in = _count_seen_and_found(pstore, lstore, pt_frust, ln_frust, pt_idx, pt_in, ln_idx, ln_in)
    R2, t2 = inr.camera_pose(st2, ext)
    return st2, R2, t2, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore


# ---------------------------------------------------------------------------
# Monocular: two-view initialization and triangulated depth
# ---------------------------------------------------------------------------


def _mono_reconstruct(cam, cfg: SlamConfig, prev_frame: FrameData, frame: FrameData, draw, seed: int):
    """Two-view initialization between the held anchor frame and the
    current one; the F / H hypotheses are drawn with `draw(seed, probs,
    shape)` from the mutual matches. Returns (success, R, t: T_c2c1 with the
    map scaled to a median inlier depth of 1, depth1 [N] per anchor feature
    in that scale (-1 where none), n_inliers)."""
    dist = matching.hamming_matrix(prev_frame.feats.desc, frame.feats.desc)
    idx, _, ok = matching.match_nn(dist, prev_frame.feats.valid, frame.feats.valid, max_dist=cfg.match.orb_th_low,
                                   ratio=0.9)
    ok = matching.mutual_consistency(idx, ok, dist, prev_frame.feats.valid, frame.feats.valid)
    uv2 = frame.feats.uv[torch.clamp(idx, min=0).long()]
    idx_f, idx_h = twoview.draw_hypotheses(draw, seed, ok)
    rec = twoview.reconstruct_two_views(cam, prev_frame.feats.uv, uv2, ok, idx_f, idx_h)
    z = rec["points"][:, 2]
    front = rec["inliers"] & (z > 0)
    med = nanmedian(z, front)  # as jnp.nanmedian: an even count averages the middle two
    med = torch.where(torch.isfinite(med) & (med > 1e-6), med, torch.ones_like(med))
    scale = 1.0 / med
    depth1 = torch.where(front, z * scale, torch.full_like(z, -1.0))
    return rec["success"], rec["R"], rec["t"] * scale, depth1, rec["n_inliers"]


def _mono_triangulated_depths(cam, cfg: SlamConfig, frame: FrameData, R, t, kf_uv, kf_desc, kf_valid, R_kf, t_kf):
    """A mono frame's depth channel [N] (current-camera z): its features
    matched against a keyframe's view and triangulated; the frame's own
    depth (-1) where that fails."""
    dist = matching.hamming_matrix(frame.feats.desc, kf_desc)
    idx, _, ok = matching.match_nn(dist, frame.feats.valid, kf_valid, max_dist=cfg.match.orb_th_low, ratio=0.8)
    ok = matching.mutual_consistency(idx, ok, dist, frame.feats.valid, kf_valid)
    uv1 = kf_uv[torch.clamp(idx, min=0).long()]
    X = tri.triangulate_dlt(R_kf, t_kf, R, t, cam_ops.unproject(cam, uv1), cam_ops.unproject(cam, frame.feats.uv))
    good = tri.triangulation_checks(cam, R_kf, t_kf, R, t, X, uv1, frame.feats.uv, frame.sigma2, frame.sigma2)
    z = lie.se3_apply(R, t, X)[:, 2]
    return torch.where(ok & good & (z > 0.05), z, frame.depth)


# ---------------------------------------------------------------------------
# Local map, far points, keyframe insertion
# ---------------------------------------------------------------------------


def _local_map_ids(cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, kf_slot: int):
    """Local-map point ids [C] (-1 padded): landmarks observed by `kf_slot`
    and its top covisible neighbours; the smallest ids are kept on overflow."""
    K = kstore.covis.shape[0]
    dev = kstore.covis.device
    C = min(cfg.map.local_map_points, cfg.map.max_points)
    J = min(cfg.map.local_map_kfs, K)
    ids_k = torch.arange(K, device=dev)
    w = torch.where(kstore.valid & (ids_k != kf_slot), kstore.covis[kf_slot], torch.full_like(kstore.covis[kf_slot], -1))
    nb_w, nb = top_k(w, max(J - 1, 1))
    rows = torch.cat([torch.tensor([kf_slot], device=dev), nb])
    row_ok = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), nb_w > 0])
    obs = kstore.obs_pt[rows]
    P = pstore.x.shape[0]
    ids = torch.where(row_ok[:, None] & (obs >= 0), obs, torch.full_like(obs, P)).reshape(-1)
    uniq = unique_fixed(ids, C, P)
    return torch.where(uniq < P, uniq, torch.full_like(uniq, -1)).to(torch.int32)


def _empty_local_map(cfg: SlamConfig, device=None):
    C = min(cfg.map.local_map_points, cfg.map.max_points)
    return torch.full((C,), -1, dtype=torch.int32, device=device)


def _empty_kf_views(cfg: SlamConfig, device=None):
    """Ring of recent keyframe views (uv, desc, valid, kf_slot); slot -1 is empty."""
    nfe, V = cfg.orb.n_features, N_TRI_VIEWS
    return (torch.zeros((V, nfe, 2), device=device), torch.zeros((V, nfe, 256), dtype=torch.int8, device=device),
            torch.zeros((V, nfe), dtype=torch.bool, device=device),
            torch.full((V,), -1, dtype=torch.int32, device=device))


def far_point_depths(cam, cfg: SlamConfig, frame: FrameData, R, t, kf_views, kstore):
    """[N] depth in the current camera of features confirmed by epipolar
    triangulation against the recent-keyframe view ring (-1 where not);
    the newest confirming view wins."""
    kf_uv, kf_desc, kf_valid, kf_slot = kf_views
    safe = torch.clamp(kf_slot, min=0).long()
    R_kf, t_kf = kstore.R[safe], kstore.t[safe]
    kf_valid = kf_valid & (kf_slot >= 0)[:, None]
    zs, cps = [], []
    for v in range(kf_uv.shape[0]):
        dist = matching.hamming_matrix(frame.feats.desc, kf_desc[v])
        idx, best, ok = matching.match_nn(dist, frame.feats.valid, kf_valid[v], max_dist=cfg.match.orb_th_low, ratio=0.8)
        ok = matching.mutual_consistency(idx, ok, dist, frame.feats.valid, kf_valid[v])
        uv1 = kf_uv[v][torch.clamp(idx, min=0).long()]
        ray1 = cam_ops.unproject(cam, uv1)
        ray2 = cam_ops.unproject(cam, frame.feats.uv)
        X = tri.triangulate_dlt(R_kf[v], t_kf[v], R, t, ray1, ray2)
        good = tri.triangulation_checks(cam, R_kf[v], t_kf[v], R, t, X, uv1, frame.feats.uv, frame.sigma2, frame.sigma2)
        z = lie.se3_apply(R, t, X)[:, 2]
        _, tw1 = lie.se3_inverse(R_kf[v], t_kf[v])
        _, tw2 = lie.se3_inverse(R, t)
        r1, r2 = X - tw1, X - tw2
        cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
            torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
        confirmed = ok & good & (z > 0.05)
        zs.append(torch.where(confirmed, z, torch.full_like(z, -1.0)))
        cps.append(torch.where(confirmed, cos_par, torch.full_like(cos_par, 2.0)))
    zs, cps = torch.stack(zs), torch.stack(cps)
    confirmed = cps < 1.5
    pick = torch.argmax(confirmed.to(torch.int32), dim=0)
    z_best = torch.gather(zs, 0, pick[None])[0]
    return torch.where(torch.any(confirmed, dim=0), z_best, torch.full_like(z_best, -1.0))


def _incidence_counts(bits_words, has, K: int):
    """Per-keyframe count of landmarks (rows with `has`) whose bitset has
    that keyframe's bit. bits_words [S, KW] int32 -> [K] int32."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits_words.device)
    unpacked = ((bits_words[:, :, None] >> shifts[None, None, :]) & 1).reshape(bits_words.shape[0], -1)[:, :K]
    return torch.sum(torch.where(has[:, None], unpacked, torch.zeros_like(unpacked)), dim=0, dtype=torch.int32)


def insert_keyframe(cam, cfg: SlamConfig, frame: FrameData, R, t, stamp: float, pt_idx, pt_in, ln_idx, ln_in,
                    kf_slot: int, pstore: st.PointStore, lstore: st.LineStore, kstore: st.KeyFrameStore,
                    tri_depth=None):
    """Create keyframe `kf_slot`: fuse-before-create and allocate landmarks,
    maintain descriptor banks, covisibility and incidence bits, write the
    keyframe row, cull young bad landmarks. Returns (pstore, lstore, kstore, n_new)."""
    dev = R.device
    i32 = torch.int32
    R_wc = R.T
    t_wc = -lie._einsum("ij,j->i", R.T, t)

    max_depth = float(np.float32(120.0) * np.float32(cam.bf) / np.float32(cam.fx)) if cam.bf > 0 else float("inf")
    depth_ok = (frame.depth > 0) & (frame.depth < max_depth)
    if tri_depth is not None:
        far_ok = (tri_depth > 0) & ~depth_ok
        agree = (frame.depth > 0) & (torch.abs(frame.depth - tri_depth) < 0.25 * torch.clamp(tri_depth, min=1e-3))
        depth = torch.where(depth_ok, frame.depth,
                       torch.where(far_ok, torch.where(agree, frame.depth, tri_depth), torch.full_like(tri_depth, -1.0)))
        frame = dataclasses.replace(frame, depth=depth)
        depth_ok = frame.depth > 0
    want_new = frame.feats.valid & depth_ok & ~(pt_in & (pt_idx >= 0))
    x_c = cam_ops.unproject(cam, frame.feats.uv) * frame.depth[:, None]
    x_w = lie._einsum("ij,nj->ni", R_wc, x_c) + t_wc

    # fuse-before-create through the gated-match kernel; the depth band is
    # checked on the single winner (reference accelerator branch, :375-389)
    xc_store = lie._einsum("ij,pj->pi", R, pstore.x) + t
    z_store = xc_store[:, 2]
    uv_store = cam_ops.project(cam, xc_store)
    P = pstore.x.shape[0]
    fuse_idx, fuse_best, fuse_ok = gated_match(
        frame.feats.desc, frame.feats.uv, want_new, pstore.desc, uv_store, pstore.valid & (z_store > 0.05),
        float(np.float32(0.05) * np.float32(cam.fx)), max_dist=64.0, ratio=1.0)
    zb = torch.abs(z_store[torch.clamp(fuse_idx, min=0).long()] - x_c[:, 2])
    fuse_ok = fuse_ok & (zb <= 0.05 * torch.clamp(x_c[:, 2], min=1e-3))
    fuse_ok = matching.dedup_matches(fuse_idx, fuse_best, fuse_ok, P)
    want_new = want_new & ~fuse_ok
    N = want_new.shape[0]
    cap = min(cfg.tracking.kf_max_new_points, N)
    if cap < N and kf_slot > 0:
        create_score = torch.where(want_new, 1.0 / torch.clamp(frame.depth, min=1e-3), torch.full_like(frame.depth, -1.0))
        kth = top_k(create_score, cap)[0][-1]
        keep = (create_score >= torch.clamp(kth, min=1e-9)) & (create_score > 0)
        want_new = want_new & keep
    slots, ok_new = st.alloc_slots(~pstore.valid, want_new)
    safe_slots = torch.clamp(slots, min=0)
    ss = safe_slots.long()
    kf_t = torch.full_like(slots, kf_slot)
    one_t = torch.ones_like(slots)
    p = pstore
    pstore = dataclasses.replace(
        p,
        x=scatter_set(p.x, safe_slots, torch.where(ok_new[:, None], x_w, p.x[ss])),
        desc=scatter_set(p.desc, safe_slots, torch.where(ok_new[:, None], frame.feats.desc, p.desc[ss])),
        valid=scatter_set(p.valid, safe_slots, ok_new | p.valid[ss]),
        n_obs=scatter_set(p.n_obs, safe_slots, torch.where(ok_new, one_t, p.n_obs[ss])),
        visible=scatter_set(p.visible, safe_slots, torch.where(ok_new, one_t, p.visible[ss])),
        found=scatter_set(p.found, safe_slots, torch.where(ok_new, one_t, p.found[ss])),
        first_kf=scatter_set(p.first_kf, safe_slots, torch.where(ok_new, kf_t, p.first_kf[ss])),
        last_kf=scatter_set(p.last_kf, safe_slots, torch.where(ok_new, kf_t, p.last_kf[ss])),
    )
    neg = torch.full_like(slots, -1)
    lm_id = torch.where(ok_new, slots, torch.where(fuse_ok, fuse_idx, torch.where(pt_in, pt_idx, neg))).to(i32)

    B = st.DESC_BANK
    bank0 = torch.zeros((N, B, 256), dtype=torch.int8, device=dev)
    bank0[:, 0] = frame.feats.desc
    pstore = dataclasses.replace(
        pstore, desc_bank=scatter_set(pstore.desc_bank, safe_slots,
                                      torch.where(ok_new[:, None, None], bank0, pstore.desc_bank[ss])))

    # distinctive-descriptor maintenance: ring bank + min-sum-Hamming medoid
    reobs = (pt_in & (pt_idx >= 0)) | fuse_ok
    safe_idx = torch.clamp(torch.where(fuse_ok, fuse_idx, pt_idx), min=0)
    si = safe_idx.long()
    ring = pstore.n_obs[si] % B
    bank = pstore.desc_bank[si]
    bsl = torch.arange(B, device=dev)
    bank = torch.where((reobs[:, None] & (bsl[None, :] == ring[:, None]))[:, :, None], frame.feats.desc[:, None, :], bank)
    n_after = pstore.n_obs[si] + 1
    slot_valid = bsl[None, :] < torch.clamp(n_after, max=B)[:, None]
    bf = bank.float()
    dots = torch.matmul(bf, bf.transpose(1, 2)).to(i32)  # exact integers
    dist = torch.div(256 - dots, 2, rounding_mode="floor")
    sums = torch.sum(torch.where(slot_valid[:, None, :], dist, torch.zeros_like(dist)), dim=-1)
    sums = torch.where(slot_valid, sums, torch.full_like(sums, 10 ** 9))
    medoid = torch.argmin(sums, dim=-1)
    desc_medoid = torch.gather(bank, 1, medoid[:, None, None].expand(N, 1, 256))[:, 0]
    p = pstore
    pstore = dataclasses.replace(
        p,
        desc_bank=scatter_set(p.desc_bank, safe_idx, torch.where(reobs[:, None, None], bank, p.desc_bank[si])),
        desc=scatter_set(p.desc, safe_idx, torch.where(reobs[:, None], desc_medoid, p.desc[si])),
        n_obs=scatter_add(p.n_obs, safe_idx, reobs.to(i32)),
        last_kf=scatter_set(p.last_kf, safe_idx, torch.where(reobs, kf_t, p.last_kf[si])),
    )

    # new line landmarks from stereo line disparities
    ln_depth_ok = frame.line_ok & torch.all(frame.line_disp > 0.5, dim=-1)
    want_new_ln = frame.lines.valid & ln_depth_ok & ~(ln_in & (ln_idx >= 0))
    lslots, lok_new = st.alloc_slots(~lstore.valid, want_new_ln)
    xs_c = cam_ops.back_project_stereo(cam, frame.lines.p0, frame.line_disp[:, 0])
    xe_c = cam_ops.back_project_stereo(cam, frame.lines.p1, frame.line_disp[:, 1])
    seg_w = torch.cat([lie._einsum("ij,nj->ni", R_wc, xs_c) + t_wc, lie._einsum("ij,nj->ni", R_wc, xe_c) + t_wc], dim=-1)
    safe_l = torch.clamp(lslots, min=0)
    sl = safe_l.long()
    kf_l = torch.full_like(lslots, kf_slot)
    one_l = torch.ones_like(lslots)
    q = lstore
    lstore = dataclasses.replace(
        q,
        seg=scatter_set(q.seg, safe_l, torch.where(lok_new[:, None], seg_w, q.seg[sl])),
        desc=scatter_set(q.desc, safe_l, torch.where(lok_new[:, None], frame.lines.desc, q.desc[sl])),
        valid=scatter_set(q.valid, safe_l, lok_new | q.valid[sl]),
        n_obs=scatter_set(q.n_obs, safe_l, torch.where(lok_new, one_l, q.n_obs[sl])),
        visible=scatter_set(q.visible, safe_l, torch.where(lok_new, one_l, q.visible[sl])),
        found=scatter_set(q.found, safe_l, torch.where(lok_new, one_l, q.found[sl])),
        first_kf=scatter_set(q.first_kf, safe_l, torch.where(lok_new, kf_l, q.first_kf[sl])),
        last_kf=scatter_set(q.last_kf, safe_l, torch.where(lok_new, kf_l, q.last_kf[sl])),
    )
    lml_id = torch.where(lok_new, lslots, torch.where(ln_in, ln_idx, torch.full_like(ln_idx, -1))).to(i32)
    reobs_l = ln_in & (ln_idx >= 0)
    safe_ln = torch.clamp(ln_idx, min=0)
    lstore = dataclasses.replace(
        lstore,
        n_obs=scatter_add(lstore.n_obs, safe_ln, reobs_l.to(i32)),
        last_kf=scatter_set(lstore.last_kf, safe_ln,
                            torch.where(reobs_l, torch.full_like(ln_idx, kf_slot), lstore.last_kf[safe_ln.long()])),
    )

    # covisibility row from the landmark->KF incidence bitsets, then stamp this KF's bit
    K = kstore.covis.shape[0]
    KW = pstore.obs_bits.shape[1]
    has_lm = lm_id >= 0
    safe_lm = torch.clamp(lm_id, min=0)
    words = pstore.obs_bits[safe_lm.long()]
    has_lml = lml_id >= 0
    safe_lml = torch.clamp(lml_id, min=0)
    words_l = lstore.obs_bits[safe_lml.long()]
    covis_row = (_incidence_counts(words, has_lm & ~ok_new, K)
                 + _incidence_counts(words_l, has_lml & ~lok_new, K))
    covis_row[kf_slot] = 0
    covis = kstore.covis.clone()
    covis[kf_slot] = covis_row
    covis[:, kf_slot] = covis_row
    kstore = dataclasses.replace(kstore, covis=covis)
    bit = 1 << (kf_slot % 32)
    bit_val = torch.tensor(bit - (1 << 32) if bit >= (1 << 31) else bit, dtype=i32, device=dev)
    col = torch.arange(KW, device=dev)[None, :] == kf_slot // 32
    zero_w = torch.zeros((), dtype=i32, device=dev)
    cleared = torch.where(ok_new[:, None], zero_w, words)
    stamped = torch.where(col, cleared | bit_val, cleared)
    pstore = dataclasses.replace(pstore, obs_bits=scatter_set(pstore.obs_bits, safe_lm, torch.where(has_lm[:, None], stamped, words)))
    cleared_l = torch.where(lok_new[:, None], zero_w, words_l)
    stamped_l = torch.where(col, cleared_l | bit_val, cleared_l)
    lstore = dataclasses.replace(lstore, obs_bits=scatter_set(lstore.obs_bits, safe_lml, torch.where(has_lml[:, None], stamped_l, words_l)))

    # the keyframe row
    uvr = torch.cat([frame.feats.uv, frame.u_right[:, None]], dim=-1)
    k = kstore
    fields = dict(R=R, t=t, stamp=torch.tensor(_f32(stamp), device=dev), valid=True, obs_pt=lm_id, obs_uvr=uvr,
                  obs_sigma2=frame.sigma2, obs_stereo=frame.stereo_ok, obs_ln=lml_id, obs_l=frame.lines.line_coeffs(),
                  obs_ln_sigma2=torch.full_like(frame.lines.angle, cfg.lines.sigma_px ** 2))
    new = {}
    for name, val in fields.items():
        arr = getattr(k, name).clone()
        arr[kf_slot] = val
        new[name] = arr
    kstore = dataclasses.replace(k, **new)

    # landmark culling (young low found-ratio landmarks)
    ratio = pstore.found.float() / torch.clamp(pstore.visible.float(), min=1.0)
    young = (kf_slot - pstore.first_kf) <= 3
    bad = pstore.valid & young & (pstore.visible > 8) & (ratio < cfg.map.cull_found_ratio)
    pstore = dataclasses.replace(pstore, valid=pstore.valid & ~bad)
    ratio_l = lstore.found.float() / torch.clamp(lstore.visible.float(), min=1.0)
    young_l = (kf_slot - lstore.first_kf) <= 3
    bad_l = lstore.valid & young_l & (lstore.visible > 8) & (ratio_l < cfg.map.cull_found_ratio)
    lstore = dataclasses.replace(lstore, valid=lstore.valid & ~bad_l)
    return pstore, lstore, kstore, torch.sum(ok_new.to(i32))


# ---------------------------------------------------------------------------
# Windowed BA
# ---------------------------------------------------------------------------


def _compact_ids(obs_flat, obs_mask, capacity_sentinel: int, cap: int):
    """(uniq [cap] sorted ids padded with the sentinel, remapped obs ids
    [O] in 0..cap-1 or -1, surviving obs mask [O]); overflow drops the
    largest ids' observations."""
    ids = torch.where(obs_mask, obs_flat, torch.full_like(obs_flat, capacity_sentinel))
    uniq = unique_fixed(ids, cap, capacity_sentinel)
    pos = torch.clamp(torch.searchsorted(uniq.long(), obs_flat.long()), 0, cap - 1)
    mask = obs_mask & (uniq[pos] == obs_flat)
    return uniq, torch.where(mask, pos, torch.full_like(pos, -1)).to(torch.int32), mask


def window_problem(kstore, pstore, lstore, window, fixed, pt_cap=None, ln_cap=None):
    """Pose-major BAProblem over `window` ([W] KF slots), landmarks compacted
    to the ids the window observes. Returns (prob, ids_pt, ids_ln)."""
    W = window.shape[0]
    dev = window.device
    S = kstore.obs_pt.shape[1]
    Sl = kstore.obs_ln.shape[1]
    win = window.long()
    win_valid = kstore.valid[win]
    ar = torch.arange(W, device=dev)
    dup = torch.any((window[:, None] == window[None, :]) & (ar[None, :] < ar[:, None]), dim=1)
    row_ok = win_valid & ~dup
    po_pose = torch.repeat_interleave(ar.to(torch.int32), S)
    po_pt = kstore.obs_pt[win].reshape(-1)
    po_mask = (po_pt >= 0) & torch.repeat_interleave(row_ok, S)
    lo_ln = kstore.obs_ln[win].reshape(-1)
    lo_mask = (lo_ln >= 0) & torch.repeat_interleave(row_ok, Sl)

    P = pstore.x.shape[0]
    L = lstore.seg.shape[0]
    ids_pt = ids_ln = None
    if pt_cap is not None and pt_cap < P:
        ids_pt, po_pt, po_mask = _compact_ids(po_pt, po_mask, P, pt_cap)
        safe = torch.clamp(ids_pt, max=P - 1).long()
        pts, pt_mask = pstore.x[safe], (ids_pt < P) & pstore.valid[safe]
    else:
        pts, pt_mask = pstore.x, pstore.valid
    if ln_cap is not None and ln_cap < L:
        ids_ln, lo_ln, lo_mask = _compact_ids(lo_ln, lo_mask, L, ln_cap)
        safe_l = torch.clamp(ids_ln, max=L - 1).long()
        lns, ln_mask = lstore.seg[safe_l], (ids_ln < L) & lstore.valid[safe_l]
    else:
        lns, ln_mask = lstore.seg, lstore.valid

    prob = ba_mod.BAProblem(
        R=kstore.R[win], t=kstore.t[win], pose_mask=win_valid, fixed_mask=fixed | ~win_valid,
        pts=pts, pt_mask=pt_mask, lns=lns, ln_mask=ln_mask,
        po_pose=po_pose, po_pt=po_pt, po_uvr=kstore.obs_uvr[win].reshape(-1, 3),
        po_stereo=kstore.obs_stereo[win].reshape(-1), po_sigma2=kstore.obs_sigma2[win].reshape(-1),
        po_mask=po_mask,
        lo_pose=torch.repeat_interleave(ar.to(torch.int32), Sl), lo_ln=lo_ln,
        lo_l=kstore.obs_l[win].reshape(-1, 3), lo_sigma2=kstore.obs_ln_sigma2[win].reshape(-1),
        lo_mask=lo_mask,
    )
    return prob, ids_pt, ids_ln


def _scatter_landmarks(pstore, lstore, ids_pt, ids_ln, pts_new, lns_new):
    P = pstore.x.shape[0]
    L = lstore.seg.shape[0]
    if ids_pt is None:
        pstore = dataclasses.replace(pstore, x=pts_new)
    else:
        safe = torch.clamp(ids_pt, max=P - 1)
        okm = ids_pt < P
        pstore = dataclasses.replace(pstore, x=scatter_set(pstore.x, safe, torch.where(okm[:, None], pts_new, pstore.x[safe.long()])))
    if ids_ln is None:
        lstore = dataclasses.replace(lstore, seg=lns_new)
    else:
        safe_l = torch.clamp(ids_ln, max=L - 1)
        okl = ids_ln < L
        lstore = dataclasses.replace(lstore, seg=scatter_set(lstore.seg, safe_l, torch.where(okl[:, None], lns_new, lstore.seg[safe_l.long()])))
    return pstore, lstore


def local_ba(cam, cfg: SlamConfig, kstore, pstore, lstore, window, fixed, iters: int | None = None):
    """Windowed BA over `window`; erases outlier observations that took part."""
    W = window.shape[0]
    S = kstore.obs_pt.shape[1]
    Sl = kstore.obs_ln.shape[1]
    prob, ids_pt, ids_ln = window_problem(kstore, pstore, lstore, window, fixed,
                                          pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap)
    result = ba_mod.solve_ba(cam, prob, cfg.opt, iters=cfg.opt.local_ba_iters if iters is None else iters)
    keep_pt = ((result.po_chi2 < cfg.opt.prune_chi2_pt) | ~prob.po_mask).reshape(W, S)
    keep_ln = ((result.lo_chi2 < cfg.opt.prune_chi2_ln) | ~prob.lo_mask).reshape(W, Sl)
    win = window.long()
    obs_pt_win = torch.where(keep_pt, kstore.obs_pt[win], torch.full_like(kstore.obs_pt[win], -1))
    obs_ln_win = torch.where(keep_ln, kstore.obs_ln[win], torch.full_like(kstore.obs_ln[win], -1))
    kstore = dataclasses.replace(
        kstore,
        R=scatter_set(kstore.R, window, result.R), t=scatter_set(kstore.t, window, result.t),
        obs_pt=scatter_set(kstore.obs_pt, window, obs_pt_win), obs_ln=scatter_set(kstore.obs_ln, window, obs_ln_win),
    )
    pstore, lstore = _scatter_landmarks(pstore, lstore, ids_pt, ids_ln, result.pts, result.lns)
    return kstore, pstore, lstore


def local_inertial_ba(cam, cfg: SlamConfig, kstore, pstore, lstore, window, fixed, preint_chain, imu_mask,
                      gravity_w, ext=None):
    """Visual-inertial windowed BA over a temporal keyframe window: factor i
    of `preint_chain` ([W-1] stacked) spans window[i] -> window[i+1]."""
    W = window.shape[0]
    dev = window.device
    ar = torch.arange(W, device=dev)
    dup = torch.any((window[:, None] == window[None, :]) & (ar[None, :] < ar[:, None]), dim=1)
    row_ok = kstore.valid[window.long()] & ~dup
    base, ids_pt, ids_ln = window_problem(kstore, pstore, lstore, window, fixed,
                                          pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap)
    if ext is None:
        ext = inr.Extrinsics.identity(dev)
    win = window.long()
    prob = vib.VIBAProblem(base=base, v=kstore.v_w[win], bg=kstore.bg[win], ba=kstore.ba[win], preint=preint_chain,
                           imu_mask=imu_mask & row_ok[1:] & row_ok[:-1], gravity_w=gravity_w,
                           R_cb=ext.R_cb, t_cb=ext.t_cb)
    R, t, v, bg, ba_, pts, lns = vib.solve_vi_ba(cam, prob, cfg.opt, cfg.imu)
    kstore = dataclasses.replace(
        kstore, R=scatter_set(kstore.R, window, R), t=scatter_set(kstore.t, window, t),
        v_w=scatter_set(kstore.v_w, window, v), bg=scatter_set(kstore.bg, window, bg),
        ba=scatter_set(kstore.ba, window, ba_))
    pstore, lstore = _scatter_landmarks(pstore, lstore, ids_pt, ids_ln, pts, lns)
    return kstore, pstore, lstore


def global_ba(cam, cfg: SlamConfig, kstore, pstore, lstore, iters: int | None = None):
    """Full-map BA over every keyframe slot, slot 0 fixed. Small maps
    (K <= 4 W) run the joint Schur solve; larger ones the memory-bounded
    alternating solver, which erases the observations it finds to be
    outliers (every amortized chunk prunes, as in the reference)."""
    K = kstore.R.shape[0]
    dev = kstore.R.device
    iters = cfg.opt.gba_iters if iters is None else iters
    window = torch.arange(K, dtype=torch.int32, device=dev)
    fixed = window == 0
    if K <= 4 * cfg.opt.local_ba_window:
        return local_ba(cam, cfg, kstore, pstore, lstore, window, fixed, iters=iters)
    prob, _, _ = window_problem(kstore, pstore, lstore, window, fixed)
    result = ba_mod.solve_ba_alternating(cam, prob, cfg.opt, iters=iters)
    keep_pt = (result.po_chi2 < cfg.opt.prune_chi2_pt).reshape(K, -1)
    keep_ln = (result.lo_chi2 < cfg.opt.prune_chi2_ln).reshape(K, -1)
    kstore = dataclasses.replace(
        kstore, R=result.R, t=result.t,
        obs_pt=torch.where(keep_pt, kstore.obs_pt, torch.full_like(kstore.obs_pt, -1)),
        obs_ln=torch.where(keep_ln, kstore.obs_ln, torch.full_like(kstore.obs_ln, -1)))
    return kstore, dataclasses.replace(pstore, x=result.pts), dataclasses.replace(lstore, seg=result.lns)


def _device_cull_keyframes(cfg: SlamConfig, kstore, pstore, n_kf: int):
    """Invalidate redundant keyframes; KF 0 and the active window are protected."""
    K = kstore.valid.shape[0]
    ids = torch.arange(K, device=kstore.valid.device)
    in_scope = (ids >= 1) & (ids < n_kf - cfg.opt.local_ba_window)
    has = kstore.obs_pt >= 0
    n_obs = pstore.n_obs[torch.clamp(kstore.obs_pt, min=0).long()]
    red = torch.sum(((n_obs >= cfg.map.cull_min_obs + 1) & has).to(torch.int32), dim=1)
    tot = torch.clamp(torch.sum(has.to(torch.int32), dim=1), min=1)
    cull = in_scope & kstore.valid & (red >= cfg.map.kf_cull_redundancy * tot)
    return dataclasses.replace(kstore, valid=kstore.valid & ~cull)


def _covis_window(cfg: SlamConfig, kstore, kf_slot: int, n_kf: int):
    """BA window: the new keyframe + its W-1 most covisible keyframes (the
    temporal predecessor always included); the two oldest members fixed."""
    W = cfg.opt.local_ba_window
    K = kstore.covis.shape[0]
    dev = kstore.covis.device
    ids = torch.arange(K, dtype=torch.int32, device=dev)
    eligible = kstore.valid & (ids < n_kf) & (ids != kf_slot)
    score = torch.where(eligible, kstore.covis[kf_slot].float(), torch.full((K,), -1.0, device=dev))
    if kf_slot > 0:
        score = score.clone()
        score[kf_slot - 1] += 1e6
    top_s, top_i = top_k(score, W - 1)
    neighbors = torch.where(top_s > 0, top_i.to(torch.int32), torch.full((W - 1,), kf_slot, dtype=torch.int32, device=dev))
    window = torch.cat([torch.tensor([kf_slot], dtype=torch.int32, device=dev), neighbors])
    order = torch.argsort(window, stable=True)
    fixed = torch.zeros(W, dtype=torch.bool, device=dev)
    fixed[order[0]] = True
    fixed[order[1]] = window[order[1]] != kf_slot
    return window, fixed


def vocab_query(db, bow_pt, bow_ln, exclude_mask, n_best: int = 3, covis=None):
    return vocab_mod.query(db, bow_pt, bow_ln, exclude_mask, n_best=n_best, covis=covis)


# ---------------------------------------------------------------------------
# The fused steps: visual, and stereo-inertial after IMU initialization
# ---------------------------------------------------------------------------


def _keyframe_decision(cfg: SlamConfig, ok, n_in, n_kf: int, frames_since_kf: int, last_kf_inliers, allow_mapping):
    """The frame's one device->host read (ok, inlier count, the reference
    keyframe's inliers) and the keyframe decision made from it on the host.
    Returns (need_kf, frames since keyframe incl. this one, last_kf_inliers
    as a device int32)."""
    last_kf_inliers = torch.as_tensor(last_kf_inliers, dtype=torch.int32, device=ok.device)
    ok_h, n_in_h, last_h = torch.stack([ok.to(torch.int32), n_in.to(torch.int32), last_kf_inliers]).tolist()
    fs = frames_since_kf + 1
    tc = cfg.tracking
    need_kf = (bool(ok_h) and bool(allow_mapping) and n_in_h >= tc.kf_min_inliers
               and fs > max(tc.kf_min_interval, 1)
               and (fs >= tc.kf_max_interval or n_in_h < tc.kf_ref_ratio * max(last_h, 1))
               and n_kf < cfg.map.max_keyframes)
    return need_kf, fs, last_kf_inliers


def _index_keyframe(cfg: SlamConfig, voc_pt, voc_ln, frame, n_kf: int, kstore, pstore, bow_db, kf_view):
    """What follows a keyframe's insertion and BA on both fused paths: the
    BoW add and loop-candidate query, the view ring, the local-map refresh."""
    dev = kstore.R.device
    n_kf2 = n_kf + 1
    bow_p = voc_pt.bow(frame.feats.desc, frame.feats.valid & (kstore.obs_pt[n_kf] >= 0))
    bow_l = voc_ln.bow(frame.lines.desc, frame.lines.valid)
    bow_db = bow_db.add(n_kf, bow_p, bow_l)
    K = bow_db.valid.shape[0]
    excl = (torch.arange(K, device=dev) >= max(n_kf2 - cfg.loop.min_kf_gap, 0)) | (kstore.covis[n_kf] > 10)
    slots, scores = vocab_query(bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis)
    if n_kf < cfg.loop.min_kf_gap:
        slots, scores = torch.full_like(slots, -1), torch.full_like(scores, -1.0)
    new_view = (frame.feats.uv, frame.feats.desc, frame.feats.valid,
                torch.tensor(n_kf, dtype=torch.int32, device=dev))
    kf_view2 = tuple(torch.cat([nv[None], old[:-1]], dim=0) for nv, old in zip(new_view, kf_view))
    local_pt2 = _local_map_ids(cfg, kstore, pstore, n_kf)
    return bow_db, slots, scores, kf_view2, local_pt2


def _no_keyframe(dev):
    """(n_new, loop_slot, loop_score) of a frame that made no keyframe."""
    return (torch.zeros((), dtype=torch.int32, device=dev),
            torch.full((N_LOOP_CANDS,), -1, dtype=torch.int32, device=dev),
            torch.full((N_LOOP_CANDS,), -1.0, device=dev))


def _step_outputs(ok, n_in, n_kf2: int, need_kf: bool, fs2: int, last_in2, n_new, loop_slot, loop_score,
                  pstore, lstore, kstore, R_new, t_new):
    """(counters, stats vector, trajectory record relative to the newest keyframe)."""
    dev = R_new.device
    f32 = torch.float32
    host = torch.tensor([n_kf2, float(need_kf), fs2, n_kf2 - 1 if need_kf else -1], dtype=f32).to(dev)
    stats = torch.cat([
        torch.stack([ok.to(f32), n_in.to(f32), host[0], host[1], n_new.to(f32),
                     torch.sum(pstore.valid.to(f32)), torch.sum(lstore.valid.to(f32)), host[2],
                     last_in2.to(f32)]),
        loop_slot.to(f32), loop_score.to(f32), host[3:]])
    counters = (n_kf2, fs2, last_in2.to(torch.int32))
    ref = max(n_kf2 - 1, 0)
    R_cr = lie._mm(R_new, kstore.R[ref].T)
    t_cr = t_new - lie._einsum("ij,j->i", R_cr, kstore.t[ref])
    return counters, stats, (ref, R_cr, t_cr)


def make_step_visual(cam, cfg: SlamConfig, voc_pt, voc_ln, build):
    """Per-frame program for the stereo visual path. `build(img_l, img_r)`
    -> FrameData. Returns

      step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel,
           n_kf, frames_since_kf, last_kf_inliers, allow_mapping,
           pstore, lstore, kstore, bow_db, kf_view, local_pt)
      -> (R, t, R_prev, t_prev, vel_xi, has_vel, pstore, lstore, kstore,
          bow_db, kf_view, local_pt, pt_idx, pt_in, ln_idx, ln_in,
          counters, stats, rel)

    with the reference's argument and result order. `n_kf` and
    `frames_since_kf` are host ints; `last_kf_inliers` is an int or a
    0-d device tensor; `has_vel` a 0-d device bool. `counters` =
    (n_kf, frames_since_kf: host ints, last_kf_inliers: device int32)
    and `rel` = (ref slot: host int, R_cr, t_cr)."""

    def kf_branch(frame, stamp, R, t, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore, lstore, kstore, bow_db,
                  kf_view, local_pt):
        tri_depth = None
        if cam.bf > 0:
            tri_depth = (far_point_depths(cam, cfg, frame, R, t, kf_view, kstore) if n_kf > 0
                         else torch.full_like(frame.depth, -1.0))
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, stamp, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore, lstore, kstore, tri_depth)
        n_kf2 = n_kf + 1
        if n_kf2 >= 3:
            window, fixed = _covis_window(cfg, kstore, n_kf, n_kf2)
            kstore, pstore, lstore = local_ba(cam, cfg, kstore, pstore, lstore, window, fixed)
        kstore = _device_cull_keyframes(cfg, kstore, pstore, n_kf2)
        R2, t2 = kstore.R[n_kf], kstore.t[n_kf]
        bow_db, slots, scores, kf_view2, local_pt2 = _index_keyframe(cfg, voc_pt, voc_ln, frame, n_kf, kstore,
                                                                      pstore, bow_db, kf_view)
        return R2, t2, pstore, lstore, kstore, bow_db, n_kf2, n_new, slots, scores, kf_view2, local_pt2

    def step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel, n_kf, frames_since_kf, last_kf_inliers,
             allow_mapping, pstore, lstore, kstore, bow_db, kf_view, local_pt):
        frame = build(*img_args)
        dR, dt = lie.se3_exp(vel_xi)
        use_mm = has_vel & bool(cfg.tracking.motion_model)
        R0 = torch.where(use_mm, lie._mm(dR, R), R)
        t0 = torch.where(use_mm, lie._einsum("ij,j->i", dR, t) + dt, t)
        (R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore) = track_step(
            cam, cfg, frame, R0, t0, pstore, lstore, wide=~use_mm, local_pt_ids=local_pt)
        ok = n_in >= cfg.tracking.min_inliers_track
        R_new = torch.where(ok, R1, R0)
        t_new = torch.where(ok, t1, t0)
        R_rel = lie._mm(R_new, R.T)
        t_rel = t_new - lie._einsum("ij,j->i", R_rel, t)
        vel_xi = torch.where(ok, lie.se3_log(R_rel, t_rel), vel_xi)
        has_vel = ok | has_vel

        need_kf, fs, last_kf_inliers = _keyframe_decision(cfg, ok, n_in, n_kf, frames_since_kf, last_kf_inliers,
                                                          allow_mapping)
        if need_kf:
            (R_new, t_new, pstore, lstore, kstore, bow_db, n_kf2, n_new, loop_slot, loop_score, kf_view,
             local_pt) = kf_branch(frame, stamp, R_new, t_new, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore,
                                   lstore, kstore, bow_db, kf_view, local_pt)
            fs2 = 0
            last_in2 = n_in + n_new
        else:
            n_kf2, fs2, last_in2 = n_kf, fs, last_kf_inliers
            n_new, loop_slot, loop_score = _no_keyframe(R.device)
        counters, stats, rel = _step_outputs(ok, n_in, n_kf2, need_kf, fs2, last_in2, n_new, loop_slot, loop_score,
                                             pstore, lstore, kstore, R_new, t_new)
        return (R_new, t_new, R, t, vel_xi, has_vel, pstore, lstore, kstore, bow_db, kf_view, local_pt,
                pt_idx, pt_in, ln_idx, ln_in, counters, stats, rel)

    return step


def make_step_vi(cam, cfg: SlamConfig, voc_pt, voc_ln, build):
    """Per-frame program for the stereo-inertial path after IMU
    initialization, the inertial analog of make_step_visual: build ->
    preintegrate -> IMU prediction -> inertial tracking -> on a keyframe:
    insertion, the chain factor KF(k-1) -> KF(k), temporal-window
    visual-inertial BA, BoW add / loop query, view ring, local map. Returns

      step(img_args, imu_args, stamp, R, t, v_w, bg, ba, gravity_w,
           preint_acc, ext, n_kf, frames_since_kf, last_kf_inliers,
           allow_mapping, wide, pstore, lstore, kstore, bow_db, kf_view,
           local_pt, pints)
      -> (R, t, R_prev, t_prev, v_w, bg, ba, preint_acc, pstore, lstore,
          kstore, bow_db, kf_view, local_pt, pints, pt_idx, pt_in, ln_idx,
          ln_in, counters, stats, rel)

    with the reference's argument and result order. `imu_args` is the packed
    [T, 8] batch g | a | dt | mask; `wide` a host bool; the counters are as
    in make_step_visual. As there, the reference's two `lax.cond`s are host
    `if`s and the frame makes one device->host read."""

    def kf_branch(frame, stamp, R, t, v_w, bg, ba, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore, lstore, kstore,
                  bow_db, kf_view, pints, preint_acc, gravity_w, ext):
        dev = R.device
        tri_depth = None
        if cam.bf > 0:
            tri_depth = (far_point_depths(cam, cfg, frame, R, t, kf_view, kstore) if n_kf > 0
                         else torch.full_like(frame.depth, -1.0))
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, stamp, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore, lstore, kstore, tri_depth)
        n_kf2 = n_kf + 1
        # inertial state on the new keyframe row, and the chain factor KF(k-1) -> KF(k)
        new = {}
        for name, val in (("v_w", v_w), ("bg", bg), ("ba", ba)):
            arr = getattr(kstore, name).clone()
            arr[n_kf] = val
            new[name] = arr
        kstore = dataclasses.replace(kstore, **new)
        pints = pints.set(n_kf, preint_acc, valid=(preint_acc.dt > 1e-6) & (n_kf > 0))

        # temporal-window VI BA: the last W keyframes, padded with the newest
        W = cfg.opt.local_ba_window
        lo = max(n_kf2 - W, 0)
        window = torch.clamp(lo + torch.arange(W, dtype=torch.int32, device=dev), 0, max(n_kf2 - 1, 0))
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), window[1:] <= window[:-1]])
        # the first local_ba_fixed poses are pinned (a 1-pose gauge lets the
        # window's bias/velocity states wander)
        fixed = (torch.arange(W, device=dev) < max(cfg.opt.local_ba_fixed, 1)) | dup
        if n_kf2 >= 3:
            stacked = pints.gather(window[1:])
            imu_mask = pints.valid[window[1:].long()] & (window[1:] == window[:-1] + 1)
            kstore, pstore, lstore = local_inertial_ba(cam, cfg, kstore, pstore, lstore, window, fixed, stacked,
                                                       imu_mask, gravity_w, ext)
        # continue from the refined keyframe state. No keyframe culling here:
        # it would break the preintegration chain's adjacency
        R2, t2 = kstore.R[n_kf], kstore.t[n_kf]
        v2, bg2, ba2 = kstore.v_w[n_kf], kstore.bg[n_kf], kstore.ba[n_kf]
        bow_db, slots, scores, kf_view2, local_pt2 = _index_keyframe(cfg, voc_pt, voc_ln, frame, n_kf, kstore,
                                                                      pstore, bow_db, kf_view)
        # the accumulator starts again, linearized at the refined biases
        acc2 = imu_ops.identity_with_bias(bg2, ba2)
        return (R2, t2, v2, bg2, ba2, pstore, lstore, kstore, bow_db, n_kf2, n_new, slots, scores, kf_view2,
                local_pt2, pints, acc2)

    def step(img_args, imu_args, stamp, R, t, v_w, bg, ba, gravity_w, preint_acc, ext, n_kf, frames_since_kf,
             last_kf_inliers, allow_mapping, wide, pstore, lstore, kstore, bow_db, kf_view, local_pt, pints):
        frame = build(*img_args)
        # this frame's preintegration and the per-keyframe accumulator
        p = imu_ops.preintegrate(imu_args[:, 0:3], imu_args[:, 3:6], imu_args[:, 6], imu_args[:, 7] > 0.5,
                                 bg, ba, cfg.imu)
        acc = imu_ops.compose(preint_acc, p)
        prev_state = inr.body_state_from_camera(R, t, v_w, bg, ba, ext)
        Rp, vp, pp = imu_ops.predict_state(prev_state.R_wb, prev_state.v_w, prev_state.p_w, p, bg, ba, gravity_w)
        init_state = inr.BodyState(R_wb=Rp, p_w=pp, v_w=vp, bg=bg, ba=ba)
        (st2, R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore) = track_step_inertial(
            cam, cfg, frame, p, prev_state, init_state, gravity_w, ext, pstore, lstore, local_pt, wide=wide)
        ok = n_in >= cfg.tracking.min_inliers_track
        # on failure hold the IMU dead-reckoned state, its velocity clamped
        # (bias and gravity error integrate without bound during loss)
        R_pred, t_pred = inr.camera_pose(init_state, ext)
        R_new = torch.where(ok, R1, R_pred)
        t_new = torch.where(ok, t1, t_pred)
        vp_safe = vp * torch.clamp(5.0 / torch.clamp(torch.linalg.norm(vp), min=1e-9), max=1.0)
        v_new = torch.where(ok, st2.v_w, vp_safe)
        bg_new = torch.where(ok, st2.bg, bg)
        ba_new = torch.where(ok, st2.ba, ba)

        need_kf, fs, last_kf_inliers = _keyframe_decision(cfg, ok, n_in, n_kf, frames_since_kf, last_kf_inliers,
                                                          allow_mapping)
        if need_kf:
            (R_new, t_new, v_new, bg_new, ba_new, pstore, lstore, kstore, bow_db, n_kf2, n_new, loop_slot,
             loop_score, kf_view, local_pt, pints, acc) = kf_branch(
                frame, stamp, R_new, t_new, v_new, bg_new, ba_new, pt_idx, pt_in, ln_idx, ln_in, n_kf, pstore,
                lstore, kstore, bow_db, kf_view, pints, acc, gravity_w, ext)
            fs2 = 0
            last_in2 = n_in + n_new
        else:
            n_kf2, fs2, last_in2 = n_kf, fs, last_kf_inliers
            n_new, loop_slot, loop_score = _no_keyframe(R.device)
        counters, stats, rel = _step_outputs(ok, n_in, n_kf2, need_kf, fs2, last_in2, n_new, loop_slot, loop_score,
                                             pstore, lstore, kstore, R_new, t_new)
        return (R_new, t_new, R, t, v_new, bg_new, ba_new, acc, pstore, lstore, kstore, bow_db, kf_view, local_pt,
                pints, pt_idx, pt_in, ln_idx, ln_in, counters, stats, rel)

    return step
