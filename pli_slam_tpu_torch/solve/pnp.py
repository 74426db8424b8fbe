"""Batched PnP RANSAC for relocalization (port of pli_slam_tpu.solve.pnp).

A fixed batch of hypotheses scored in parallel: the stereo path lifts three
observations with their depth seed and aligns them in closed form (Horn);
the depth-free path solves a 6-point DLT per hypothesis (one batched SVD:
ops.kernels.svd_small, a hand-written kernel on a GPU, `torch.linalg.svd`
on the CPU).
The winner is polished by the frame-pose GN solver (solve.gn). As in
solve.sim3, the functions take the drawn hypothesis indices; draw them with
`sim3.sample_indices(seed, sim3.mask_probs(mask), (H, k))`.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops.indexing import row
from pli_slam_tpu_torch.ops.kernels import svd_small
from pli_slam_tpu_torch.solve import gn, sim3
from pli_slam_tpu_torch.utils.config import OptimizerConfig

N_HYPOTHESES = 256  # the reference's default hypothesis batch


def _score(cam, R_h, t_h, x_w, uv, mask, inlier_px: float, min_inliers: int):
    """Reprojection inliers of every hypothesis; the best one's (R, t, inliers, n, ok)."""
    xc = torch.einsum("hij,nj->hni", R_h, x_w) + t_h[:, None, :]
    err2 = torch.sum((cam_ops.project(cam, xc) - uv[None]) ** 2, dim=-1)
    inl = (err2 < inlier_px * inlier_px) & (xc[..., 2] > 0.05) & mask[None]
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    n_in = row(counts, best)
    return row(R_h, best), row(t_h, best), row(inl, best), n_in, n_in >= min_inliers


def ransac_pnp(cam, x_w, uv, depth_seed, mask, idx, inlier_px: float = 4.0, min_inliers: int = 15):
    """Stereo PnP RANSAC. x_w [N,3] world points, uv [N,2] pixels, depth_seed
    [N], mask [N], idx [H,3] drawn triplets. Returns (R_cw, t_cw, inliers [N],
    n_inliers, ok)."""
    idx = idx.long()
    x_c_seed = cam_ops.unproject(cam, uv) * depth_seed[:, None]
    R_h, t_h, _ = sim3.horn_alignment(x_w[idx], x_c_seed[idx],
                                      torch.ones(idx.shape, dtype=x_w.dtype, device=x_w.device), with_scale=False)
    return _score(cam, R_h, t_h, x_w, uv, mask, inlier_px, min_inliers)


def ransac_pnp_dlt(cam, x_w, uv, mask, idx, inlier_px: float = 4.0, min_inliers: int = 15):
    """Depth-free PnP RANSAC (the monocular path): a 6-point DLT per
    hypothesis (idx [H,6]), the projective sign fixed on P by det(M) > 0,
    the rotation block orthonormalized. Same returns as ransac_pnp."""
    idx = idx.long()
    X = x_w[idx]  # [H,6,3]
    xn = cam_ops.unproject(cam, uv)[idx][..., :2]  # [H,6,2] normalized (u, v)
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)  # [H,6,4]
    zero = torch.zeros_like(Xh)
    # rows [X 0 -u X] and [0 X -v X] (P stacked as [p1; p2; p3])
    r1 = torch.cat([Xh, zero, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # [H,12,12]
    p = svd_small.svd(A)[2][:, -1, :]  # null vector: smallest singular value's right vector
    P = p.reshape(-1, 3, 4)
    sdet = torch.sign(torch.linalg.det(P[:, :, :3]))
    P = P * torch.where(sdet == 0, torch.ones_like(sdet), sdet)[:, None, None]
    U, S, Vt = svd_small.svd(P[:, :, :3])
    R_h = torch.einsum("hij,hjk->hik", U, Vt)
    t_h = P[:, :, 3] / torch.clamp(torch.mean(S, dim=-1), min=1e-12)[:, None]
    return _score(cam, R_h, t_h, x_w, uv, mask, inlier_px, min_inliers)


def solve_pnp(cam, x_w, uv, u_right, stereo_mask, depth_seed, sigma2, mask, idx,
              opt_cfg: OptimizerConfig | None = None, inlier_px: float = 4.0, min_inliers: int = 15,
              mono: bool = False):
    """RANSAC, then the GN polish with the noise the RANSAC gate accepted
    (sigma^2 scaled by (inlier_px / 2)^2). `idx` [H,3] (stereo) or [H,6]
    (mono). Returns (R_cw, t_cw, inliers, n_inliers, ok)."""
    opt_cfg = opt_cfg or OptimizerConfig()
    if mono:
        R0, t0, inl, _, ok = ransac_pnp_dlt(cam, x_w, uv, mask, idx, inlier_px=inlier_px, min_inliers=min_inliers)
    else:
        R0, t0, inl, _, ok = ransac_pnp(cam, x_w, uv, depth_seed, mask, idx, inlier_px=inlier_px,
                                        min_inliers=min_inliers)
    n_l = 8
    dev = x_w.device
    z3 = torch.zeros((n_l, 3), device=dev)
    obs = gn.PoseObservations(
        x_w=x_w, uvr=torch.cat([uv, u_right[:, None]], dim=-1), stereo_mask=stereo_mask, point_mask=inl,
        sigma2_pt=sigma2 * max((inlier_px / 2.0) ** 2, 1.0),
        xs_w=z3, xe_w=z3, l_obs=z3, line_mask=torch.zeros(n_l, dtype=torch.bool, device=dev),
        sigma2_ln=torch.ones(n_l, device=dev))
    res = gn.solve_pose(cam, obs, R0, t0, opt_cfg)
    return res.R_cw, res.t_cw, res.inlier_pt, res.n_inliers, ok
