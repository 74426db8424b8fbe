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

Control flow and CUDA graphs. Each fused step is one program in three
parts (`Segments`, `visual_segments`, `vi_segments`): T builds the frame,
predicts (motion model, or preintegration + `compose` + IMU prediction) and
tracks; `Segments.decide` is the reference's keyframe decision `need_kf`
(tracker.py:1176-1183, :1380), computed on the device as the reference
computes it (`need_keyframe`); K is the keyframe branch, in two variants:
with windowed BA and without (the reference's second cond, `n_kf2 >= 3`,
:1102, :1292). The keyframe counters are 0-d device int32s, as in the
reference (`n_kf`, `fs` frames since the keyframe, `last` its inliers); T
moves `fs` and K writes all three, as the reference returns them (:1190-1191,
:1395-1396). Every per-frame value enters as a tensor (the stamp, the
counters, the mapping and widened-window flags) and every constant comes
from ops.consts, so the program captured at one frame is right at the next.
On a GPU frontend.graphs captures the whole step once as one CUDA graph: T,
the decision, and K's two variants as the bodies of conditional IF nodes on
`need_kf & (n_kf + 1 >= 3)` and `need_kf & (n_kf + 1 < 3)`, both writing
T's buffers. `run_segments` composes the same program eagerly (the CPU,
`cuda_graphs=False`, and `make_step_visual` / `make_step_vi`): there the
host reads the decision to take the branch. GN and BA `fori_loop`s are
Python loops (solve.gn, solve.ba), unrolled in the graphs.

Index semantics. JAX clamps gathers and wraps negative scatter indices;
every gather here clamps explicitly (`clamp(idx, min=0)`), sentinel
padding (`_local_map_ids`, `_compact_ids`) is masked before use, and
repeated scatter indices go through `ops.indexing.scatter_set`
(last write wins, as on XLA's CPU backend).
"""

from __future__ import annotations

import dataclasses
import numbers
from typing import Callable

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend.frame import FrameData
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie, matching
from pli_slam_tpu_torch.ops.consts import device_const
from pli_slam_tpu_torch.ops.indexing import nanmedian, row, scatter_add, scatter_set, set_row, top_k, unique_fixed
from pli_slam_tpu_torch.ops.kernels.hamming import gated_match
from pli_slam_tpu_torch.ops.lines import _deg2rad_f32
from pli_slam_tpu_torch.solve import ba as ba_mod
from pli_slam_tpu_torch.solve import gn
from pli_slam_tpu_torch.solve import imu_init as imu_init_mod
from pli_slam_tpu_torch.solve import inertial as inr
from pli_slam_tpu_torch.solve import pnp, sim3
from pli_slam_tpu_torch.solve import triangulate as tri
from pli_slam_tpu_torch.solve import twoview
from pli_slam_tpu_torch.solve import vi_ba as vib
from pli_slam_tpu_torch.worldmap import stores as st
from pli_slam_tpu_torch.worldmap import vocab as vocab_mod

N_TRI_VIEWS = 3
ST_OK, ST_NIN, ST_NKF, ST_KF_CREATED, ST_NNEW, ST_NPTS, ST_NLNS = 0, 1, 2, 3, 4, 5, 6
ST_FSKF, ST_LASTKFIN, ST_LOOP_SLOT, ST_LOOP_SCORE, ST_KF_SLOT = 7, 8, 9, 12, 15
N_STATS = 16
N_LOOP_CANDS = 3


def _f32(x) -> float:
    return float(np.float32(x))


def _dev_int(x, device) -> torch.Tensor:
    """A keyframe slot or count as a 0-d int32 tensor on `device`: device
    counters pass through, host ints (the host paths) are written by a fill
    kernel."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


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


def mono_init_match(cfg: SlamConfig, prev_frame: FrameData, frame: FrameData):
    """Stage `mono_init_match`: the two-view initialization's mutual matches
    between the held anchor frame and the current one (ratio 0.9). Returns
    (idx [N] current-frame features, ok [N], the hypotheses' sampling
    weights `mask_probs(ok)`)."""
    dist = matching.hamming_matrix(prev_frame.feats.desc, frame.feats.desc)
    idx, _, ok = matching.match_nn(dist, prev_frame.feats.valid, frame.feats.valid, max_dist=cfg.match.orb_th_low,
                                   ratio=0.9)
    ok = matching.mutual_consistency(idx, ok, dist, prev_frame.feats.valid, frame.feats.valid)
    return idx, ok, sim3.mask_probs(ok)


def mono_init(cam, prev_frame: FrameData, frame: FrameData, idx, ok, idx_f, idx_h):
    """Stage `mono_init`: the two-view reconstruction on the drawn F / H
    hypotheses (`idx_f` [H, 8], `idx_h` [H, 4]) and the median-depth
    normalization. Returns (R, t: T_c2c1 with the map scaled to a median
    inlier depth of 1, depth1 [N] per anchor feature in that scale (-1 where
    none), read): `read` is int32 (success, inliers), the stage's one read."""
    uv2 = frame.feats.uv[torch.clamp(idx, min=0).long()]
    rec = twoview.reconstruct_two_views(cam, prev_frame.feats.uv, uv2, ok, idx_f, idx_h)
    z = rec["points"][:, 2]
    front = rec["inliers"] & (z > 0)
    med = nanmedian(z, front)  # as jnp.nanmedian: an even count averages the middle two
    med = torch.where(torch.isfinite(med) & (med > 1e-6), med, torch.ones_like(med))
    scale = 1.0 / med
    depth1 = torch.where(front, z * scale, torch.full_like(z, -1.0))
    read = torch.stack([rec["success"].to(torch.int32), rec["n_inliers"].to(torch.int32)])
    return rec["R"], rec["t"] * scale, depth1, read


def _mono_reconstruct(cam, cfg: SlamConfig, prev_frame: FrameData, frame: FrameData, draw, seed: int):
    """Two-view initialization between the held anchor frame and the
    current one: `mono_init_match`, the F / H hypotheses drawn with
    `draw(seed, probs, shape)` from the mutual matches, `mono_init`.
    Returns (success, R, t, depth1, n_inliers) as `mono_init` gives them."""
    idx, ok, _ = mono_init_match(cfg, prev_frame, frame)
    idx_f, idx_h = twoview.draw_hypotheses(draw, seed, ok)
    R, t, depth1, read = mono_init(cam, prev_frame, frame, idx, ok, idx_f, idx_h)
    return read[0] > 0, R, t, depth1, read[1]


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


def mono_depths(cam, cfg: SlamConfig, frame: FrameData, R, t, kf_uv, kf_desc, kf_valid, kf_slot, kf_R, kf_t):
    """Stage `mono_depths`: a mono keyframe's depth channel
    (`_mono_triangulated_depths`) against the view of keyframe `kf_slot` (a
    0-d device int), whose pose is read from the store's `kf_R` / `kf_t`."""
    return _mono_triangulated_depths(cam, cfg, frame, R, t, kf_uv, kf_desc, kf_valid, row(kf_R, kf_slot),
                                     row(kf_t, kf_slot))


# ---------------------------------------------------------------------------
# Local map, far points, keyframe insertion
# ---------------------------------------------------------------------------


def _local_map_ids(cfg: SlamConfig, kstore: st.KeyFrameStore, pstore: st.PointStore, kf_slot):
    """Local-map point ids [C] (-1 padded): landmarks observed by `kf_slot`
    (a host int or a 0-d device int) and its top covisible neighbours; the
    smallest ids are kept on overflow."""
    K = kstore.covis.shape[0]
    dev = kstore.covis.device
    C = min(cfg.map.local_map_points, cfg.map.max_points)
    J = min(cfg.map.local_map_kfs, K)
    kf = _dev_int(kf_slot, dev)
    ids_k = torch.arange(K, device=dev)
    covis_row = row(kstore.covis, kf)
    w = torch.where(kstore.valid & (ids_k != kf), covis_row, torch.full_like(covis_row, -1))
    nb_w, nb = top_k(w, max(J - 1, 1))
    rows = torch.cat([kf.long().reshape(1), nb])
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


def insert_keyframe(cam, cfg: SlamConfig, frame: FrameData, R, t, stamp, pt_idx, pt_in, ln_idx, ln_in,
                    kf_slot, pstore: st.PointStore, lstore: st.LineStore, kstore: st.KeyFrameStore,
                    tri_depth=None):
    """Create keyframe `kf_slot`: fuse-before-create and allocate landmarks,
    maintain descriptor banks, covisibility and incidence bits, write the
    keyframe row, cull young bad landmarks. `stamp` is a float or a 0-d
    float32 tensor, `kf_slot` a host int or a 0-d device int (the fused
    steps pass device values, so a captured graph reads them at replay).
    Returns (pstore, lstore, kstore, n_new)."""
    dev = R.device
    i32 = torch.int32
    kf = _dev_int(kf_slot, dev)
    stamp = (stamp.to(device=dev, dtype=torch.float32) if isinstance(stamp, torch.Tensor)
             else torch.full((), _f32(stamp), dtype=torch.float32, device=dev))
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
    if cap < N:  # the cap applies from the second keyframe on
        create_score = torch.where(want_new, 1.0 / torch.clamp(frame.depth, min=1e-3), torch.full_like(frame.depth, -1.0))
        kth = top_k(create_score, cap)[0][-1]
        keep = (create_score >= torch.clamp(kth, min=1e-9)) & (create_score > 0)
        want_new = want_new & (keep | (kf == 0))
    slots, ok_new = st.alloc_slots(~pstore.valid, want_new)
    safe_slots = torch.clamp(slots, min=0)
    ss = safe_slots.long()
    kf_t = kf.expand(slots.shape)
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
    kf_l = kf.expand(lslots.shape)
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
                            torch.where(reobs_l, kf.expand(ln_idx.shape), lstore.last_kf[safe_ln.long()])),
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
    kfl = kf.long().reshape(1)
    covis_row = covis_row.index_fill(0, kfl, 0)
    covis = kstore.covis.index_copy(0, kfl, covis_row[None]).index_copy(1, kfl, covis_row[:, None])
    kstore = dataclasses.replace(kstore, covis=covis)
    bit = torch.bitwise_left_shift(torch.ones((), dtype=torch.int64, device=dev), torch.remainder(kfl[0], 32))
    bit_val = torch.where(bit >= 1 << 31, bit - (1 << 32), bit).to(i32)  # bit 31 is the int32 sign bit
    col = torch.arange(KW, device=dev)[None, :] == torch.div(kf, 32, rounding_mode="floor")
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
    fields = dict(R=R, t=t, stamp=stamp, valid=True, obs_pt=lm_id, obs_uvr=uvr,
                  obs_sigma2=frame.sigma2, obs_stereo=frame.stereo_ok, obs_ln=lml_id, obs_l=frame.lines.line_coeffs(),
                  obs_ln_sigma2=torch.full_like(frame.lines.angle, cfg.lines.sigma_px ** 2))
    kstore = dataclasses.replace(k, **{name: set_row(getattr(k, name), kf, val) for name, val in fields.items()})

    # landmark culling (young low found-ratio landmarks)
    ratio = pstore.found.float() / torch.clamp(pstore.visible.float(), min=1.0)
    young = (kf - pstore.first_kf) <= 3
    bad = pstore.valid & young & (pstore.visible > 8) & (ratio < cfg.map.cull_found_ratio)
    pstore = dataclasses.replace(pstore, valid=pstore.valid & ~bad)
    ratio_l = lstore.found.float() / torch.clamp(lstore.visible.float(), min=1.0)
    young_l = (kf - lstore.first_kf) <= 3
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


def _covis_window(cfg: SlamConfig, kstore, kf_slot, n_kf):
    """BA window: the new keyframe + its W-1 most covisible keyframes (the
    temporal predecessor always included); the two oldest members fixed.
    `kf_slot` and `n_kf` are host ints or 0-d device ints."""
    W = cfg.opt.local_ba_window
    K = kstore.covis.shape[0]
    dev = kstore.covis.device
    kf, n = _dev_int(kf_slot, dev), _dev_int(n_kf, dev)
    ids = torch.arange(K, dtype=torch.int32, device=dev)
    eligible = kstore.valid & (ids < n) & (ids != kf)
    score = torch.where(eligible, row(kstore.covis, kf).float(), torch.full((K,), -1.0, device=dev))
    score = score + torch.where(ids == kf - 1, 1e6, 0.0)  # the temporal predecessor (none for slot 0)
    top_s, top_i = top_k(score, W - 1)
    neighbors = torch.where(top_s > 0, top_i.to(torch.int32), kf.expand(W - 1))
    window = torch.cat([kf.reshape(1), neighbors])
    order = torch.argsort(window, stable=True)
    ar = torch.arange(W, device=dev)
    fixed = (ar == order[0]) | ((ar == order[1]) & (window.index_select(0, order[1:2]) != kf))
    return window, fixed


def vocab_query(db, bow_pt, bow_ln, exclude_mask, n_best: int = 3, covis=None):
    return vocab_mod.query(db, bow_pt, bow_ln, exclude_mask, n_best=n_best, covis=covis)


# ---------------------------------------------------------------------------
# The host-orchestrated frames' stages (frontend.graphs.StageProgram)
# ---------------------------------------------------------------------------


def _motion_twist(R, t, R_prev, t_prev):
    """The motion model's velocity twist: T_cw composed with the previous T_wc."""
    R_rel = lie._mm(R, R_prev.T)
    return lie.se3_log(R_rel, t - lie._einsum("ij,j->i", R_rel, t_prev))


def _motion_prediction(cfg: SlamConfig, R, t, vel_xi, has_vel):
    """The motion model's predicted pose (R0, t0) and whether it applies
    (`use_mm`, a 0-d device bool: a velocity exists and the model is on)."""
    dR, dt = lie.se3_exp(vel_xi)
    use_mm = has_vel & bool(cfg.tracking.motion_model)
    return (torch.where(use_mm, lie._mm(dR, R), R), torch.where(use_mm, lie._einsum("ij,j->i", dR, t) + dt, t),
            use_mm)


def _imu_prediction(R, t, v_w, bg, ba, ext, preint, gravity_w):
    """The IMU prediction across `preint`: the body state before (prev), the
    predicted one (init) and the dead-reckoned camera pose and velocity
    (the velocity clamped to 5 m/s: bias and gravity error integrate
    without bound while tracking is lost)."""
    prev = inr.body_state_from_camera(R, t, v_w, bg, ba, ext)
    R_pred, v_pred, p_pred = imu_ops.predict_state(prev.R_wb, prev.v_w, prev.p_w, preint, bg, ba, gravity_w)
    init = inr.BodyState(R_wb=R_pred, p_w=p_pred, v_w=v_pred, bg=bg, ba=ba)
    R0, t0 = inr.camera_pose(init, ext)
    v0 = v_pred * torch.clamp(5.0 / torch.clamp(torch.linalg.norm(v_pred), min=1e-9), max=1.0)
    return prev, init, R0, t0, v0


def _track_read(n_in, pstore, lstore):
    """The host path's tracking read: (inliers, valid points, valid lines) as int32."""
    i32 = torch.int32
    return torch.stack([n_in.to(i32), torch.sum(pstore.valid, dtype=i32), torch.sum(lstore.valid, dtype=i32)])


def preintegrate_packed(cfg: SlamConfig, imu, bg, ba):
    """This frame's preintegration (the reference's `_preintegrate`) from the
    packed [T, 8] batch g | a | dt | mask."""
    return imu_ops.preintegrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], imu[:, 7] > 0.5, bg, ba, cfg.imu)


def host_track(cam, cfg: SlamConfig, frame: FrameData, R, t, vel_xi, has_vel, pstore, lstore):
    """A host-path frame's visual tracking (the reference's `_track`, with the
    motion-model prediction before it and the model's new twist after it):
    the prediction (R0, t0), the solved pose (R, t), the twist from the
    previous pose (R, t here) to the solved one, the matches, the stores and
    `read` (`_track_read`)."""
    R0, t0, use_mm = _motion_prediction(cfg, R, t, vel_xi, has_vel)
    R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore = track_step(cam, cfg, frame, R0, t0, pstore, lstore,
                                                                            wide=~use_mm)
    return dict(R0=R0, t0=t0, R=R1, t=t1, vel_xi=_motion_twist(R1, t1, R, t), matches=(pt_idx, pt_in, ln_idx, ln_in),
                pstore=pstore, lstore=lstore, read=_track_read(n_in, pstore, lstore))


def host_track_inertial(cam, cfg: SlamConfig, frame: FrameData, preint, R, t, v_w, bg, ba, gravity_w, ext, pstore,
                        lstore):
    """A host-path frame's inertial tracking with the IMU initialized (the
    reference's `_track_inertial`, with the IMU prediction before it): the
    solved state, the dead-reckoned one (R0, t0, v0: the velocity clamped
    to 5 m/s), the motion model's twist, the matches, the stores and `read`."""
    prev, init, R0, t0, v0 = _imu_prediction(R, t, v_w, bg, ba, ext, preint, gravity_w)
    st2, R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore = track_step_inertial(
        cam, cfg, frame, preint, prev, init, gravity_w, ext, pstore, lstore)
    return dict(R0=R0, t0=t0, v0=v0, R=R1, t=t1, v_w=st2.v_w, bg=st2.bg, ba=st2.ba, vel_xi=_motion_twist(R1, t1, R, t),
                matches=(pt_idx, pt_in, ln_idx, ln_in), pstore=pstore, lstore=lstore,
                read=_track_read(n_in, pstore, lstore))


def host_insert(cam, cfg: SlamConfig, frame: FrameData, R, t, stamp, matches, kf_slot, pstore, lstore, kstore, v_w,
                bg, ba, snap):
    """`insert_keyframe` (the reference's `_insert`) at `kf_slot` (a 0-d
    device int), then where `snap` (a 0-d device bool: an inertial sensor's
    keyframe) the inertial state into the new keyframe's row. Returns
    (pstore, lstore, kstore, n_new)."""
    pstore, lstore, kstore, n_new = insert_keyframe(cam, cfg, frame, R, t, stamp, *matches, kf_slot, pstore, lstore,
                                                    kstore)
    kstore = dataclasses.replace(kstore, **{
        name: set_row(getattr(kstore, name), kf_slot, torch.where(snap, val, row(getattr(kstore, name), kf_slot)))
        for name, val in (("v_w", v_w), ("bg", bg), ("ba", ba))})
    return pstore, lstore, kstore, n_new


def host_bow(cfg: SlamConfig, voc_pt, voc_ln, bow_db, kstore, desc, fvalid, ldesc, lvalid, kf_slot, n_kf, n_new,
             pvalid, lvalid_store):
    """The host path's BoW add and loop-candidate query (the reference's
    jitted `_bow_kf`, tracker.py:1566-1579): the exclusion of the newest
    keyframes and the `kf_slot >= min_kf_gap` gate from the device ints
    `kf_slot` and `n_kf`. Returns (bow_db, slots, scores, read): `read` is
    the keyframe's one host read, int32 (new landmarks, valid points, valid
    lines, the candidates' slots, their scores' float32 bits)."""
    bow_p = voc_pt.bow(desc, fvalid & (row(kstore.obs_pt, kf_slot) >= 0))
    bow_l = voc_ln.bow(ldesc, lvalid)
    bow_db = bow_db.add(kf_slot, bow_p, bow_l)
    K = bow_db.valid.shape[0]
    excl = torch.arange(K, device=kstore.obs_pt.device) >= torch.clamp(n_kf - cfg.loop.min_kf_gap, min=0)
    slots, scores = vocab_query(bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis)
    can = kf_slot >= cfg.loop.min_kf_gap
    slots, scores = torch.where(can, slots, -1), torch.where(can, scores, -1.0)
    i32 = torch.int32
    read = torch.cat([torch.stack([n_new.to(i32), torch.sum(pvalid, dtype=i32), torch.sum(lvalid_store, dtype=i32)]),
                      slots.to(i32), scores.view(i32)])
    return bow_db, slots, scores, read


def keyframe_read(read: np.ndarray) -> tuple[int, int, int, list[tuple[int, float]]]:
    """`host_bow`'s read on the host: (new landmarks, valid points, valid
    lines, the loop candidates as (slot, score) pairs, best first)."""
    if read.dtype != np.int32 or read.shape != (3 + 2 * N_LOOP_CANDS,):
        raise ValueError(f"a keyframe read is {3 + 2 * N_LOOP_CANDS} int32, not {read.shape} {read.dtype}")
    slots, scores = read[3:3 + N_LOOP_CANDS].tolist(), read[3 + N_LOOP_CANDS:].view(np.float32).tolist()
    return int(read[0]), int(read[1]), int(read[2]), list(zip(slots, scores))


def cull_keyframes(cfg: SlamConfig, kstore, pstore, n_kf):
    """Keyframe culling over every slot (`n_kf` a 0-d device int): slots 1 ..
    n_kf - W - 1 whose landmarks are >= kf_cull_redundancy seen by more than
    cull_min_obs keyframes are invalidated; KF 0 and the active window are
    kept. The quotient redundant / max(has, 1) is the reference's
    (tracker.py:2436-2454), row for row, with the rows outside that range
    masked instead of sliced away."""
    K = kstore.valid.shape[0]
    ids = torch.arange(K, device=kstore.valid.device)
    in_scope = (ids >= 1) & (ids < n_kf - cfg.opt.local_ba_window)
    has = kstore.obs_pt >= 0
    n_obs = pstore.n_obs[torch.clamp(kstore.obs_pt, min=0).long()]
    redundant = torch.sum((n_obs >= cfg.map.cull_min_obs + 1) & has, dim=1) / torch.clamp(torch.sum(has, dim=1), min=1)
    cull = (redundant >= cfg.map.kf_cull_redundancy) & kstore.valid & in_scope
    return dataclasses.replace(kstore, valid=kstore.valid & ~cull)


# ---------------------------------------------------------------------------
# The rare paths' stages (frontend.graphs.StageProgram): relocalization and
# the inertial and whole-map BA chunks (the loop closer's: frontend.loop_closing)
# ---------------------------------------------------------------------------


def reloc_match(cfg: SlamConfig, mono: bool, frame: FrameData, pstore):
    """Relocalization's pose-free matching (the reference's `_pnp_reloc_j`,
    before its draw): the frame's descriptors against the whole point store,
    mutual nearest neighbours under ratio 0.8, with a stereo depth unless
    `mono`. Returns (idx [N] store rows, okm [N], the RANSAC's sampling
    weights `mask_probs(okm)`)."""
    dist = matching.hamming_matrix(frame.feats.desc, pstore.desc)
    idx, _, okm = matching.match_nn(dist, frame.feats.valid, pstore.valid, max_dist=cfg.match.orb_th_low, ratio=0.8)
    okm = matching.mutual_consistency(idx, okm, dist, frame.feats.valid, pstore.valid)
    if not mono:
        okm = okm & (frame.depth > 0)
    return idx, okm, sim3.mask_probs(okm)


def reloc_pnp(cam, cfg: SlamConfig, mono: bool, voc_pt, voc_ln, frame: FrameData, x_store, idx, okm, hyp, bow_db):
    """Relocalization's PnP on the drawn hypotheses `hyp` ([H,3] stereo, [H,6]
    mono: the 6-point DLT) with the GN polish, and the frame's BoW query over
    the whole database (the reference's `_bow_query_frame`). Returns (R, t,
    read): `read` is the stage's one host read, int32 (the RANSAC's ok, the
    candidates' slots, their scores' float32 bits; `reloc_read`)."""
    R, t, _, _, ok = pnp.solve_pnp(cam, x_store[idx.long()], frame.feats.uv, frame.u_right, frame.stereo_ok,
                                   frame.depth, frame.sigma2, okm, hyp, cfg.opt, inlier_px=8.0, min_inliers=12,
                                   mono=mono)
    excl = torch.zeros(bow_db.valid.shape[0], dtype=torch.bool, device=bow_db.valid.device)
    slots, scores = vocab_query(bow_db, voc_pt.bow(frame.feats.desc, frame.feats.valid),
                                voc_ln.bow(frame.lines.desc, frame.lines.valid), excl, n_best=cfg.loop.bow_candidates)
    i32 = torch.int32
    return R, t, torch.cat([ok.to(i32).reshape(1), slots.to(i32), scores.view(i32)])


def reloc_read(read: np.ndarray, n_best: int) -> tuple[bool, list[tuple[int, float]]]:
    """`reloc_pnp`'s read on the host: (the PnP seed's ok, the BoW candidates
    as (slot, score) pairs, best first)."""
    if read.dtype != np.int32 or read.shape != (1 + 2 * n_best,):
        raise ValueError(f"a relocalization read is {1 + 2 * n_best} int32, not {read.shape} {read.dtype}")
    slots, scores = read[1:1 + n_best].tolist(), read[1 + n_best:].view(np.float32).tolist()
    return bool(read[0]), list(zip(slots, scores))


def reloc_track(cam, cfg: SlamConfig, frame: FrameData, R0, t0, pstore, lstore, wide):
    """One relocalization seed's wide re-track (the reference's `_track` with
    `wide` set): (R, t, inliers, pstore, lstore)."""
    R, t, *_, n_in, pstore, lstore = track_step(cam, cfg, frame, R0, t0, pstore, lstore, wide=wide)
    return R, t, n_in, pstore, lstore


def reloc_pick(kstore, n_kf, n_ins, Rs, ts):
    """The best of the seeds' re-tracks (`n_ins`, `Rs`, `ts`: one entry per
    seed, in the seeds' order) and the keyframe nearest to its pose by |t_cw|
    among the valid slots below `n_kf` (a 0-d device int). The best is the
    first maximum, as a host loop with a strict `>` from 0 finds it; a best
    count of 0 means no seed held. Returns (R, t, read): `read` is int32
    (best count, the seed, the nearest keyframe)."""
    n = torch.stack([x.reshape(()) for x in n_ins])
    best = torch.argmax(n)
    R, t = row(torch.stack(Rs), best), row(torch.stack(ts), best)
    K = kstore.t.shape[0]
    ids = torch.arange(K, device=kstore.t.device)
    d = torch.linalg.norm(kstore.t - t[None], dim=1)
    d = torch.where(kstore.valid & (ids < n_kf), d, torch.full_like(d, float("inf")))
    i32 = torch.int32
    return R, t, torch.stack([row(n, best).to(i32), best.to(i32), torch.argmin(d).to(i32)])


def kf_chain(pints, window):
    """The preintegration chain of a window of keyframe slots on the device:
    factor i spans window[i] -> window[i+1] and holds only between adjacent
    slots with a recorded accumulator. Returns (stacked [W-1], imu_mask [W-1])."""
    nxt = window[1:]
    adjacent = nxt == window[:-1] + 1
    return pints.gather(nxt), pints.valid.index_select(0, nxt.long()) & adjacent


def vi_ba_window(cam, cfg: SlamConfig, kstore, pstore, lstore, pints, window, fixed, gravity_w, ext):
    """Visual-inertial BA over the keyframe window `window` ([W] int32 slots;
    `fixed` [W] bool): the chain gathered on the device (`kf_chain`), slots
    culled since the window was drawn pinned. Returns (kstore, pstore, lstore)."""
    stacked, imu_mask = kf_chain(pints, window)
    fixed = fixed | ~kstore.valid.index_select(0, window.long())
    return local_inertial_ba(cam, cfg, kstore, pstore, lstore, window, fixed, stacked, imu_mask, gravity_w, ext)


def imu_init_width(n: int, capacity: int) -> int:
    """The padded keyframe width of the scale refinement over `n`
    keyframes: 8, 16 or 32 as the "vi_ba" stage's whole-map windows, then
    powers of two up to the keyframe store's `capacity`."""
    width = 8
    while width < n:
        width *= 2
    return min(width, capacity)


def imu_init(cfg: SlamConfig, mono: bool, kstore, pints, ext, n_kf, gravity_w, bg, ba, width: int, fix_scale: bool,
             fix_bias: bool):
    """Stage `imu_init`: the IMU initialization's inertial-only MAP problem
    (the reference's `_inertial_opt_j` and the work around it) over the
    first `n_kf` keyframes (a 0-d device int), padded to `width` slots.

    - the chain: `kf_chain` over slots 0..width-1, factors past `n_kf` masked;
    - the seeds: with `fix_bias` False (the initialization) the gyro bias
      from visual against preintegrated rotations (over the masked chain,
      in its order), the gravity direction from the summed velocity deltas, the
      central-difference velocities, a zero accelerometer bias, priors 1e2
      and 1e6 (mono) or 1e5; with `fix_bias` (VIBA1 / VIBA2's scale
      refinement) the current gravity `gravity_w`, the keyframes' velocities
      and the biases `bg` / `ba`, the default priors;
    - `solve.imu_init.inertial_optimization` (`fix_scale`, `fix_bias`).

    The padded slots' velocities meet no unmasked factor, so their Jacobian
    columns are zero and the damped solve leaves them at their zero seed;
    the real block's arithmetic is otherwise the unpadded problem's, in a
    system of another size, whose rounding differs (the tracker pads the
    scale refinement only, and runs the initialization at `width` = n_kf).
    Returns (g_w, bg, ba, v [width, 3], read): `read` is float32 (live chain
    factors, scale, 1 if g_w is finite, the first and the last iteration's
    cost), the stage's one read."""
    dev = kstore.R.device
    window = device_const(("slots", width), dev, lambda: torch.arange(width, dtype=torch.int32))
    stacked, imu_mask = kf_chain(pints, window)
    imu_mask = imu_mask & (window[1:] < n_kf)
    R_k, t_k = kstore.R[:width], kstore.t[:width]
    R_wb = torch.einsum("kji,jm->kim", R_k, ext.R_cb)
    p_wb = torch.einsum("kji,kj->ki", R_k, ext.t_cb[None] - t_k)
    g0 = device_const(("gravity_vector", cfg.imu.gravity), dev, lambda: [0.0, 0.0, -cfg.imu.gravity])
    if fix_bias:
        gw = gravity_w / torch.linalg.norm(gravity_w)
        gz = g0 / torch.linalg.norm(g0)
        v_axis = torch.linalg.cross(gz, gw)
        s_ang = torch.linalg.norm(v_axis)
        Rwg0 = torch.where(s_ang > 1e-6, lie.so3_exp(v_axis / torch.clamp(s_ang, min=1e-9)
                                                     * torch.arcsin(torch.clamp(s_ang, -1, 1))), lie._eye3(R_wb))
        live_kf = (window < n_kf)[:, None]
        v0 = torch.where(live_kf, kstore.v_w[:width], torch.zeros_like(kstore.v_w[:width]))
        bg0, ba0, priors = bg, ba, {}
    else:
        bg0 = inr.estimate_gyro_bias_chain(stacked, imu_mask, R_wb, prior_info=1.0)
        Rwg0 = imu_init_mod.gravity_dir_seed(stacked, imu_mask, R_wb, cfg.imu.gravity)
        v0 = imu_init_mod.velocity_seed(p_wb, kstore.stamp[:width], n_kf)
        ba0, priors = torch.zeros_like(bg0), dict(prior_g=1e2, prior_a=1e6 if mono else 1e5)
    Rwg, s, bg, ba, v, costs = imu_init_mod.inertial_optimization(
        stacked, imu_mask, R_wb, p_wb, v0, Rwg0, bg0, ba0, cfg.imu, fix_scale=fix_scale, fix_bias=fix_bias, **priors)
    g_w = lie._einsum("ij,j->i", Rwg, g0)
    f32 = torch.float32
    finite = torch.all(torch.isfinite(g_w)).to(f32)
    return g_w, bg, ba, v, torch.stack([imu_mask.sum().to(f32), s.to(f32), finite, costs[0], costs[-1]])


def merge_query(voc_pt, voc_ln, kstore, pstore, lstore, kf_slot, dbs):
    """Stage `merge_query`: the BoW of keyframe `kf_slot`'s observed
    landmarks (their own descriptors) against every parked map's database in
    `dbs` (a tuple; the reference's `_bow_of_kf_j` and one `_query_db_j` a
    map). Returns [len(dbs), 2] float32 (the best slot, its score), read
    once for all maps."""
    ids, lids = row(kstore.obs_pt, kf_slot), row(kstore.obs_ln, kf_slot)
    safe, lsafe = torch.clamp(ids, min=0).long(), torch.clamp(lids, min=0).long()
    bow_p = voc_pt.bow(pstore.desc[safe], (ids >= 0) & pstore.valid[safe])
    bow_l = voc_ln.bow(lstore.desc[lsafe], (lids >= 0) & lstore.valid[lsafe])
    rows = []
    for db in dbs:
        excl = torch.zeros(db.valid.shape[0], dtype=torch.bool, device=db.valid.device)
        slots, scores = vocab_mod.query(db, bow_p, bow_l, excl, n_best=1)
        rows.append(torch.stack([slots[0].float(), scores[0]]))
    return torch.stack(rows)


def rebuild_bow(voc_pt, voc_ln, kstore, pstore, lstore):
    """Stage `rebuild_bow`: the BoW database recomputed from the landmark
    stores (after a merge)."""
    ids, lids = kstore.obs_pt, kstore.obs_ln
    safe, lsafe = torch.clamp(ids, min=0).long(), torch.clamp(lids, min=0).long()
    bow_p = voc_pt.bow_rows(pstore.desc[safe], (ids >= 0) & pstore.valid[safe])
    bow_l = voc_ln.bow_rows(lstore.desc[lsafe], (lids >= 0) & lstore.valid[lsafe])
    zero = torch.zeros((), device=kstore.valid.device)
    return vocab_mod.BowDatabase(hist_pt=torch.where(kstore.valid[:, None], bow_p, zero),
                                 hist_ln=torch.where(kstore.valid[:, None], bow_l, zero), valid=kstore.valid)


# ---------------------------------------------------------------------------
# The fused steps: visual, and stereo-inertial after IMU initialization
# ---------------------------------------------------------------------------


def need_keyframe(cfg: SlamConfig, ok, n_in, last_kf_inliers, n_kf, frames_since_kf, allow_mapping) -> torch.Tensor:
    """The keyframe decision on the device, as the reference's fused steps
    compute it (tracker.py:1176-1183): `frames_since_kf` already counts this
    frame; every argument is a 0-d tensor (`ok` and `allow_mapping` bool, the
    counts int32). `kf_ref_ratio * max(last, 1)` is float32, as a Python float
    times an int32 array is in JAX."""
    tc = cfg.tracking
    fs = frames_since_kf
    ratio = n_in.to(torch.float32) < _f32(tc.kf_ref_ratio) * torch.clamp(last_kf_inliers, min=1).to(torch.float32)
    return (ok & allow_mapping & (n_in >= tc.kf_min_inliers) & (fs > max(tc.kf_min_interval, 1))
            & ((fs >= tc.kf_max_interval) | ratio) & (n_kf < cfg.map.max_keyframes))


def _index_keyframe(cfg: SlamConfig, voc_pt, voc_ln, frame, n_kf, kstore, pstore, bow_db, kf_view):
    """What follows a keyframe's insertion and BA on both fused paths: the
    BoW add and loop-candidate query, the view ring, the local-map refresh.
    `n_kf` (the new keyframe's slot) is a 0-d device int."""
    dev = kstore.R.device
    n_kf = _dev_int(n_kf, dev)
    n_kf2 = n_kf + 1
    bow_p = voc_pt.bow(frame.feats.desc, frame.feats.valid & (row(kstore.obs_pt, n_kf) >= 0))
    bow_l = voc_ln.bow(frame.lines.desc, frame.lines.valid)
    bow_db = bow_db.add(n_kf, bow_p, bow_l)
    K = bow_db.valid.shape[0]
    excl = ((torch.arange(K, device=dev) >= torch.clamp(n_kf2 - cfg.loop.min_kf_gap, min=0))
            | (row(kstore.covis, n_kf) > 10))
    slots, scores = vocab_query(bow_db, bow_p, bow_l, excl, n_best=N_LOOP_CANDS, covis=kstore.covis)
    young = n_kf < cfg.loop.min_kf_gap  # no loop candidates before min_kf_gap keyframes
    slots, scores = torch.where(young, -1, slots), torch.where(young, -1.0, scores)
    new_view = (frame.feats.uv, frame.feats.desc, frame.feats.valid, n_kf)
    kf_view2 = tuple(torch.cat([nv[None], old[:-1]], dim=0) for nv, old in zip(new_view, kf_view))
    local_pt2 = _local_map_ids(cfg, kstore, pstore, n_kf)
    return bow_db, slots, scores, kf_view2, local_pt2


def _no_keyframe(dev):
    """(n_new, loop_slot, loop_score) of a frame that made no keyframe."""
    return (torch.zeros((), dtype=torch.int32, device=dev),
            torch.full((N_LOOP_CANDS,), -1, dtype=torch.int32, device=dev),
            torch.full((N_LOOP_CANDS,), -1.0, device=dev))


def _step_outputs(ok, n_in, n_kf2, made_kf: bool, fs2, last_in2, n_new, loop_slot, loop_score,
                  pstore, lstore, kstore, R_new, t_new):
    """(stats vector, trajectory record relative to the newest keyframe),
    all on the device; `made_kf` is a constant of the segment."""
    f32 = torch.float32
    kf_slot = n_kf2 - 1 if made_kf else torch.full_like(n_kf2, -1)
    stats = torch.cat([
        torch.stack([ok.to(f32), n_in.to(f32), n_kf2.to(f32), torch.full((), float(made_kf), device=ok.device),
                     n_new.to(f32), torch.sum(pstore.valid.to(f32)), torch.sum(lstore.valid.to(f32)), fs2.to(f32),
                     last_in2.to(f32)]),
        loop_slot.to(f32), loop_score.to(f32), kf_slot.to(f32)[None]])
    ref = torch.clamp(n_kf2 - 1, min=0)
    R_cr = lie._mm(R_new, row(kstore.R, ref).T)
    t_cr = t_new - lie._einsum("ij,j->i", R_cr, row(kstore.t, ref))
    return stats, (ref, R_cr, t_cr)


@dataclasses.dataclass(frozen=True)
class Segments:
    """A fused step as one program: T, the decision, K.

    `track(inputs, state) -> (new_state, out, carry)` is T: the frame build,
    the motion-model or IMU prediction and tracking, with the stats vector
    and trajectory record of a frame that makes no keyframe, and `fs` moved
    on. `decide(inputs, state, carry)` is the keyframe decision on T's state,
    a 0-d bool. `keyframe(inputs, state, carry, with_ba) -> (new_state, out)`
    is K: the keyframe branch on T's state and `carry`, windowed BA when
    `with_ba` (the reference's `n_kf2 >= 3` cond: a constant of the variant),
    and the stats and record of a keyframe frame; it writes every `out` entry
    and every state entry T writes, so either branch leaves one set of
    buffers. `state` maps names to tensors, stores and tuples; `new_state`
    holds the entries a part changes. Every value that varies between frames
    enters as a tensor -- the keyframe counters `n_kf`, `fs` (frames since the
    keyframe) and `last` (its inliers) are 0-d device int32s, the stamp a 0-d
    float32, `allow` (mapping allowed) a 0-d bool -- so the program traced or
    captured at one frame is right at the next."""

    cfg: SlamConfig
    track: Callable
    keyframe: Callable

    def decide(self, inputs, state, carry) -> torch.Tensor:
        return need_keyframe(self.cfg, carry["ok"], carry["n_in"], state["last"], state["n_kf"], state["fs"],
                             inputs["allow"])


def run_segments(segs: Segments, inputs: dict, state: dict):
    """T, the decision and K, eagerly: the program that frontend.graphs
    captures, composed on the host, which reads the decision (and the
    keyframe count, for K's variant) to take the branch. Returns (state,
    out of the last part run, T's carry, need_kf as a 0-d device bool)."""
    new, out, carry = segs.track(inputs, state)
    state = {**state, **new}
    need_kf = segs.decide(inputs, state, carry)
    need, n_kf = torch.stack([need_kf.to(torch.int32), state["n_kf"]]).tolist()
    if need:
        new, out = segs.keyframe(inputs, state, carry, n_kf + 1 >= 3)
        state = {**state, **new}
    return state, out, carry, need_kf


def scalar_inputs(inputs: dict, device) -> dict:
    """A segment's inputs with the per-frame scalars (stamp, flags) as 0-d
    tensors on `device`: bools as bool, other numbers as float32 (rounded
    as the reference's jit rounds a Python float)."""
    def conv(v):
        if isinstance(v, (bool, np.bool_)):
            return torch.full((), bool(v), dtype=torch.bool, device=device)
        if isinstance(v, numbers.Number):
            return torch.full((), float(v), dtype=torch.float32, device=device)
        return v

    return {k: conv(v) for k, v in inputs.items()}


def _tri_depth(cam, cfg, frame, R, t, kf_view, kstore, n_kf):
    """The far-point channel of a keyframe: views before KF0 carry no
    valid features, so the first keyframe takes none (reference :1086-1090)."""
    if cam.bf <= 0:
        return None
    return torch.where(n_kf > 0, far_point_depths(cam, cfg, frame, R, t, kf_view, kstore),
                       torch.full_like(frame.depth, -1.0))


def visual_segments(cam, cfg: SlamConfig, voc_pt, voc_ln, build) -> Segments:
    """T and K of the stereo / RGB-D visual step. inputs: `img` (the
    arguments of `build`), `stamp`, `allow`. state: R, t, R_prev, t_prev, vel_xi,
    has_vel, n_kf, fs, last, pstore, lstore, kstore, bow_db, kf_view,
    local_pt."""

    def track(inputs, state):
        frame = build(*inputs["img"])
        R, t = state["R"], state["t"]
        R0, t0, use_mm = _motion_prediction(cfg, R, t, state["vel_xi"], state["has_vel"])
        (R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore) = track_step(
            cam, cfg, frame, R0, t0, state["pstore"], state["lstore"], wide=~use_mm, local_pt_ids=state["local_pt"])
        ok = n_in >= cfg.tracking.min_inliers_track
        R_new = torch.where(ok, R1, R0)
        t_new = torch.where(ok, t1, t0)
        vel_xi = torch.where(ok, _motion_twist(R_new, t_new, R, t), state["vel_xi"])
        fs, last = state["fs"] + 1, state["last"]
        stats, (ref, R_cr, t_cr) = _step_outputs(ok, n_in, state["n_kf"], False, fs, last, *_no_keyframe(R.device),
                                                 pstore, lstore, state["kstore"], R_new, t_new)
        new = dict(R=R_new, t=t_new, R_prev=R, t_prev=t, vel_xi=vel_xi, has_vel=ok | state["has_vel"],
                   pstore=pstore, lstore=lstore, fs=fs)
        out = dict(stats=stats, ref=ref, rel_R=R_cr, rel_t=t_cr)
        carry = dict(frame=frame, pt_idx=pt_idx, pt_in=pt_in, ln_idx=ln_idx, ln_in=ln_in, n_in=n_in, ok=ok)
        return new, out, carry

    def keyframe(inputs, state, carry, with_ba):
        frame, n_kf, R, t = carry["frame"], state["n_kf"], state["R"], state["t"]
        tri_depth = _tri_depth(cam, cfg, frame, R, t, state["kf_view"], state["kstore"], n_kf)
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, inputs["stamp"], carry["pt_idx"], carry["pt_in"], carry["ln_idx"], carry["ln_in"],
            n_kf, state["pstore"], state["lstore"], state["kstore"], tri_depth)
        n_kf2 = n_kf + 1
        if with_ba:
            window, fixed = _covis_window(cfg, kstore, n_kf, n_kf2)
            kstore, pstore, lstore = local_ba(cam, cfg, kstore, pstore, lstore, window, fixed)
        kstore = _device_cull_keyframes(cfg, kstore, pstore, n_kf2)
        R2, t2 = row(kstore.R, n_kf), row(kstore.t, n_kf)
        bow_db, slots, scores, kf_view2, local_pt2 = _index_keyframe(cfg, voc_pt, voc_ln, frame, n_kf, kstore,
                                                                      pstore, state["bow_db"], state["kf_view"])
        fs2, last2 = torch.zeros_like(state["fs"]), carry["n_in"] + n_new
        stats, (ref, R_cr, t_cr) = _step_outputs(carry["ok"], carry["n_in"], n_kf2, True, fs2, last2, n_new, slots,
                                                 scores, pstore, lstore, kstore, R2, t2)
        new = dict(R=R2, t=t2, pstore=pstore, lstore=lstore, kstore=kstore, bow_db=bow_db, kf_view=kf_view2,
                   local_pt=local_pt2, n_kf=n_kf2, fs=fs2, last=last2)
        return new, dict(stats=stats, ref=ref, rel_R=R_cr, rel_t=t_cr)

    return Segments(cfg=cfg, track=track, keyframe=keyframe)


def make_step_visual(cam, cfg: SlamConfig, voc_pt, voc_ln, build):
    """Per-frame program for the stereo visual path. `build(img_l, img_r)`
    -> FrameData. Returns

      step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel,
           n_kf, frames_since_kf, last_kf_inliers, allow_mapping,
           pstore, lstore, kstore, bow_db, kf_view, local_pt)
      -> (R, t, R_prev, t_prev, vel_xi, has_vel, pstore, lstore, kstore,
          bow_db, kf_view, local_pt, pt_idx, pt_in, ln_idx, ln_in,
          counters, stats, rel)

    with the reference's argument and result order: `visual_segments` run
    by `run_segments`. The counters may be host ints or 0-d device ints
    (chained from the last call's `counters` without a host read),
    `allow_mapping` a bool or a 0-d device bool;
    `counters` = (n_kf, frames_since_kf, last_kf_inliers) and `rel` =
    (ref slot, R_cr, t_cr) come back on the device, as in the reference."""
    segs = visual_segments(cam, cfg, voc_pt, voc_ln, build)

    def step(img_args, stamp, R, t, R_prev, t_prev, vel_xi, has_vel, n_kf, frames_since_kf, last_kf_inliers,
             allow_mapping, pstore, lstore, kstore, bow_db, kf_view, local_pt):
        dev = R.device
        state = dict(R=R, t=t, R_prev=R_prev, t_prev=t_prev, vel_xi=vel_xi, has_vel=has_vel,
                     n_kf=_dev_int(n_kf, dev), fs=_dev_int(frames_since_kf, dev), last=_dev_int(last_kf_inliers, dev),
                     pstore=pstore, lstore=lstore, kstore=kstore, bow_db=bow_db, kf_view=kf_view, local_pt=local_pt)
        inputs = scalar_inputs(dict(img=tuple(img_args), stamp=stamp, allow=allow_mapping), dev)
        s, out, c, _ = run_segments(segs, inputs, state)
        return (s["R"], s["t"], s["R_prev"], s["t_prev"], s["vel_xi"], s["has_vel"], s["pstore"], s["lstore"],
                s["kstore"], s["bow_db"], s["kf_view"], s["local_pt"], c["pt_idx"], c["pt_in"], c["ln_idx"], c["ln_in"],
                (s["n_kf"], s["fs"], s["last"]), out["stats"], (out["ref"], out["rel_R"], out["rel_t"]))

    return step


def vi_segments(cam, cfg: SlamConfig, voc_pt, voc_ln, build) -> Segments:
    """T and K of the stereo-inertial step after IMU initialization.
    inputs: `img`, `imu` (the packed [T, 8] batch g | a | dt | mask),
    `stamp`, `allow`, `wide` (0-d bool: the tripled round-1 window after a
    map-changing event). state: R, t, R_prev, t_prev, v_w, bg, ba,
    gravity_w, preint_acc, ext, n_kf, fs, last, pstore, lstore, kstore,
    bow_db, kf_view, local_pt, pints."""

    def track(inputs, state):
        frame = build(*inputs["img"])
        imu_args = inputs["imu"]
        R, t, bg, ba, ext, gravity_w = state["R"], state["t"], state["bg"], state["ba"], state["ext"], state["gravity_w"]
        # this frame's preintegration and the per-keyframe accumulator
        p = preintegrate_packed(cfg, imu_args, bg, ba)
        acc = imu_ops.compose(state["preint_acc"], p)
        prev_state, init_state, R_pred, t_pred, vp_safe = _imu_prediction(R, t, state["v_w"], bg, ba, ext, p,
                                                                          gravity_w)
        (st2, R1, t1, pt_idx, pt_in, ln_idx, ln_in, n_in, pstore, lstore) = track_step_inertial(
            cam, cfg, frame, p, prev_state, init_state, gravity_w, ext, state["pstore"], state["lstore"],
            state["local_pt"], wide=inputs["wide"])
        ok = n_in >= cfg.tracking.min_inliers_track
        # on failure hold the IMU dead-reckoned state
        R_new = torch.where(ok, R1, R_pred)
        t_new = torch.where(ok, t1, t_pred)
        fs, last = state["fs"] + 1, state["last"]
        stats, (ref, R_cr, t_cr) = _step_outputs(ok, n_in, state["n_kf"], False, fs, last, *_no_keyframe(R.device),
                                                 pstore, lstore, state["kstore"], R_new, t_new)
        new = dict(R=R_new, t=t_new, R_prev=R, t_prev=t, v_w=torch.where(ok, st2.v_w, vp_safe),
                   bg=torch.where(ok, st2.bg, bg), ba=torch.where(ok, st2.ba, ba), preint_acc=acc,
                   pstore=pstore, lstore=lstore, fs=fs)
        out = dict(stats=stats, ref=ref, rel_R=R_cr, rel_t=t_cr)
        carry = dict(frame=frame, pt_idx=pt_idx, pt_in=pt_in, ln_idx=ln_idx, ln_in=ln_in, n_in=n_in, ok=ok)
        return new, out, carry

    def keyframe(inputs, state, carry, with_ba):
        frame, n_kf, R, t = carry["frame"], state["n_kf"], state["R"], state["t"]
        dev = R.device
        tri_depth = _tri_depth(cam, cfg, frame, R, t, state["kf_view"], state["kstore"], n_kf)
        pstore, lstore, kstore, n_new = insert_keyframe(
            cam, cfg, frame, R, t, inputs["stamp"], carry["pt_idx"], carry["pt_in"], carry["ln_idx"], carry["ln_in"],
            n_kf, state["pstore"], state["lstore"], state["kstore"], tri_depth)
        n_kf2 = n_kf + 1
        # inertial state on the new keyframe row, and the chain factor KF(k-1) -> KF(k)
        kstore = dataclasses.replace(kstore, **{name: set_row(getattr(kstore, name), n_kf, state[name])
                                               for name in ("v_w", "bg", "ba")})
        acc = state["preint_acc"]
        pints = state["pints"].set(n_kf, acc, valid=(acc.dt > 1e-6) & (n_kf > 0))

        # temporal-window VI BA: the last W keyframes, padded with the newest
        W = cfg.opt.local_ba_window
        lo = torch.clamp(n_kf2 - W, min=0)
        window = torch.minimum(lo + torch.arange(W, dtype=torch.int32, device=dev), torch.clamp(n_kf2 - 1, min=0))
        dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), window[1:] <= window[:-1]])
        # the first local_ba_fixed poses are pinned (a 1-pose gauge lets the
        # window's bias/velocity states wander)
        fixed = (torch.arange(W, device=dev) < max(cfg.opt.local_ba_fixed, 1)) | dup
        if with_ba:
            stacked = pints.gather(window[1:])
            imu_mask = pints.valid[window[1:].long()] & (window[1:] == window[:-1] + 1)
            kstore, pstore, lstore = local_inertial_ba(cam, cfg, kstore, pstore, lstore, window, fixed, stacked,
                                                       imu_mask, state["gravity_w"], state["ext"])
        # continue from the refined keyframe state. No keyframe culling here:
        # it would break the preintegration chain's adjacency
        R2, t2 = row(kstore.R, n_kf), row(kstore.t, n_kf)
        v2, bg2, ba2 = row(kstore.v_w, n_kf), row(kstore.bg, n_kf), row(kstore.ba, n_kf)
        bow_db, slots, scores, kf_view2, local_pt2 = _index_keyframe(cfg, voc_pt, voc_ln, frame, n_kf, kstore,
                                                                      pstore, state["bow_db"], state["kf_view"])
        fs2, last2 = torch.zeros_like(state["fs"]), carry["n_in"] + n_new
        stats, (ref, R_cr, t_cr) = _step_outputs(carry["ok"], carry["n_in"], n_kf2, True, fs2, last2, n_new, slots,
                                                 scores, pstore, lstore, kstore, R2, t2)
        # the accumulator starts again, linearized at the refined biases
        new = dict(R=R2, t=t2, v_w=v2, bg=bg2, ba=ba2, preint_acc=imu_ops.identity_with_bias(bg2, ba2),
                   pstore=pstore, lstore=lstore, kstore=kstore, bow_db=bow_db, kf_view=kf_view2, local_pt=local_pt2,
                   pints=pints, n_kf=n_kf2, fs=fs2, last=last2)
        return new, dict(stats=stats, ref=ref, rel_R=R_cr, rel_t=t_cr)

    return Segments(cfg=cfg, track=track, keyframe=keyframe)


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

    with the reference's argument and result order: `vi_segments` run by
    `run_segments`. `wide` is a bool or a 0-d device bool; the counters and
    `allow_mapping` are as in make_step_visual."""
    segs = vi_segments(cam, cfg, voc_pt, voc_ln, build)

    def step(img_args, imu_args, stamp, R, t, v_w, bg, ba, gravity_w, preint_acc, ext, n_kf, frames_since_kf,
             last_kf_inliers, allow_mapping, wide, pstore, lstore, kstore, bow_db, kf_view, local_pt, pints):
        dev = R.device
        state = dict(R=R, t=t, R_prev=R, t_prev=t, v_w=v_w, bg=bg, ba=ba, gravity_w=gravity_w, preint_acc=preint_acc,
                     ext=ext, n_kf=_dev_int(n_kf, dev), fs=_dev_int(frames_since_kf, dev),
                     last=_dev_int(last_kf_inliers, dev), pstore=pstore, lstore=lstore, kstore=kstore, bow_db=bow_db,
                     kf_view=kf_view, local_pt=local_pt, pints=pints)
        inputs = scalar_inputs(dict(img=tuple(img_args), imu=imu_args, stamp=stamp, allow=allow_mapping, wide=wide),
                               dev)
        s, out, c, _ = run_segments(segs, inputs, state)
        return (s["R"], s["t"], s["R_prev"], s["t_prev"], s["v_w"], s["bg"], s["ba"], s["preint_acc"], s["pstore"],
                s["lstore"], s["kstore"], s["bow_db"], s["kf_view"], s["local_pt"], s["pints"], c["pt_idx"],
                c["pt_in"], c["ln_idx"], c["ln_in"], (s["n_kf"], s["fs"], s["last"]), out["stats"],
                (out["ref"], out["rel_R"], out["rel_t"]))

    return step
