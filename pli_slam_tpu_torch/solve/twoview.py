"""Monocular two-view reconstruction: batched F / H RANSAC and motion
recovery (port of pli_slam_tpu.solve.twoview).

Both model families are scored as one batch of hypotheses: 8-point
fundamental matrices and 4-point DLT homographies, each in Hartley-
normalized coordinates, every hypothesis against every correspondence.
The motion comes from the best F: the essential matrix's four (R, t)
decompositions are told apart by cheirality counts over midpoint
triangulations.

Random draws. As in solve.sim3, the function takes the drawn hypotheses
(`idx_f` [H, 8], `idx_h` [H, 4]); draw them with `draw_hypotheses`. The
reference draws F and H from the two halves of a split key; the port
calls its draw twice with the reference's seed, once per shape.

SVD signs. The essential matrix's singular vectors may come out with
other signs on another device; the proper-rotation fix makes the four
candidates the same set, and a scene with a clear winner picks the same
(R, t) whatever their order.

CUDA graphs. The function runs inside the tracker's "mono_init" stage,
captured on a GPU: `torch.linalg.eigh` and `svd` check their status on the
host there, so every decomposition goes through the port's small-SVD
kernel (ops.kernels.svd_small, float64 Jacobi inside; on the CPU its plain
versions, `torch.linalg.svd` and, for the minimal solvers' A^T A,
`torch.linalg.eigh`). The smallest eigenvector of the symmetric positive
semi-definite A^T A is its last right singular vector, so the reference's
A^T A formulation (and its float32 conditioning) stays. The best
hypothesis and candidate are picked with `ops.indexing.row`, never by
indexing with a 0-d tensor (a host read on CUDA), and the constants come
from ops.consts.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.consts import device_const
from pli_slam_tpu_torch.ops.indexing import row
from pli_slam_tpu_torch.ops.kernels import svd_small
from pli_slam_tpu_torch.solve import sim3, triangulate

N_HYPOTHESES = 256  # the reference's default hypothesis batch


def draw_hypotheses(draw, seed: int, mask: torch.Tensor, n_hypotheses: int = N_HYPOTHESES):
    """(idx_f [H, 8], idx_h [H, 4]) drawn with `draw(seed, probs, shape)`
    (`solve.sim3.sample_indices` or a tracker's `draw`) from the masked
    correspondences."""
    probs = sim3.mask_probs(mask)
    return draw(seed, probs, (n_hypotheses, 8)), draw(seed, probs, (n_hypotheses, 4))


def _normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization over the masked points. Returns (pts_n, T [3,3])."""
    w = mask.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)
    mu = torch.sum(pts * w[:, None], dim=0) / wsum
    d = torch.sum(torch.abs(pts - mu) * w[:, None], dim=0) / wsum
    s = 1.0 / torch.clamp(d, min=1e-6)
    T = torch.eye(3, dtype=pts.dtype, device=pts.device)
    T[0, 0], T[1, 1] = s[0], s[1]
    T[0, 2], T[1, 2] = -mu[0] * s[0], -mu[1] * s[1]
    return (pts - mu) * s, T


def _smallest_eigvec(AtA: torch.Tensor) -> torch.Tensor:
    """[..., 9, 9] symmetric positive semi-definite -> the eigenvector of its
    smallest eigenvalue, [..., 9] (sign free)."""
    return svd_small.smallest_eigvec(AtA)


def _eight_point_F(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """F from 8 normalized correspondences per hypothesis, [H,8,2] each -> [H,3,3] of rank 2."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, torch.ones_like(u1)], dim=-1)
    f = _smallest_eigvec(torch.einsum("hni,hnj->hij", A, A)).reshape(-1, 3, 3)
    U, S, Vh = svd_small.svd(f)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    return (U * S[:, None, :]) @ Vh


def _four_point_H(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """H from 4 correspondences per hypothesis (DLT), [H,4,2] each -> [H,3,3]."""
    u, v = x1[..., 0], x1[..., 1]
    x, y = x2[..., 0], x2[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    r1 = torch.stack([-u, -v, -one, zero, zero, zero, x * u, x * v, x], dim=-1)
    r2 = torch.stack([zero, zero, zero, -u, -v, -one, y * u, y * v, y], dim=-1)
    A = torch.stack([r1, r2], dim=2).reshape(x1.shape[0], 8, 9)  # rows of point i at 2i, 2i+1
    return _smallest_eigvec(torch.einsum("hni,hnj->hij", A, A)).reshape(-1, 3, 3)


def _homogeneous(uv: torch.Tensor) -> torch.Tensor:
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)


def _sym_transfer_err_F(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared epipolar distance, [H,3,3] x [N,2] -> [H,N]."""
    h1, h2 = _homogeneous(uv1), _homogeneous(uv2)
    l2 = torch.einsum("nj,hij->hni", h1, F)  # epilines in image 2
    l1 = torch.einsum("nj,hjk->hnk", h2, F)
    num = torch.sum(h2[None] * l2, dim=-1) ** 2
    d2_2 = num / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d2_1 = num / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d2_1 + d2_2


def _sym_transfer_err_H(H: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared transfer error, [H,3,3] x [N,2] -> [H,N]."""
    h1, h2 = _homogeneous(uv1), _homogeneous(uv2)
    p12 = torch.einsum("nj,hij->hni", h1, H)
    p21 = torch.einsum("nj,hij->hni", h2, torch.linalg.inv_ex(H).inverse)

    def dehom(p):
        return p[..., :2] / torch.clamp(torch.abs(p[..., 2:]), min=1e-9) * torch.sign(p[..., 2:])

    return torch.sum((dehom(p12) - uv2) ** 2, dim=-1) + torch.sum((dehom(p21) - uv1) ** 2, dim=-1)


def reconstruct_two_views(cam, uv1: torch.Tensor, uv2: torch.Tensor, mask: torch.Tensor, idx_f: torch.Tensor,
                          idx_h: torch.Tensor, sigma: float = 1.0) -> dict:
    """Mono initialization from matched pixels uv1, uv2 [N,2] (`mask` [N])
    and the drawn hypotheses. Returns {"success", "R", "t" (T_c2c1, unit
    translation), "points" [N,3] in the view-1 frame, "inliers" [N],
    "n_inliers", "h_ratio"} as 0-d / [N] device tensors."""
    dev = uv1.device
    n1, T1 = _normalize(uv1, mask)
    n2, T2 = _normalize(uv2, mask)
    idx_f, idx_h = idx_f.long(), idx_h.long()

    Fs = T2.T @ _eight_point_F(n1[idx_f], n2[idx_f]) @ T1
    Hs = torch.linalg.inv_ex(T2).inverse @ _four_point_H(n1[idx_h], n2[idx_h]) @ T1

    thF, thH = 3.84 * sigma * sigma, 5.99 * sigma * sigma
    errF = _sym_transfer_err_F(Fs, uv1, uv2)
    errH = _sym_transfer_err_H(Hs, uv1, uv2)
    zero = torch.zeros((), device=dev)
    # the reference's scoring: sum of (th - e) over the inliers
    scoreF = torch.sum(torch.where((errF < thF) & mask[None], thF - errF, zero), dim=1)
    scoreH = torch.sum(torch.where((errH < thH) & mask[None], thH - errH, zero), dim=1)
    bF, bH = torch.argmax(scoreF), torch.argmax(scoreH)
    SF, SH = row(scoreF, bF), row(scoreH, bH)
    ratio_h = SH / torch.clamp(SH + SF, min=1e-9)

    # motion from F (the reference takes F's motion also where H wins)
    K = device_const(("intrinsics", cam.fx, cam.fy, cam.cx, cam.cy), dev,
                     lambda: [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]])
    E = lie._mm(K.T, lie._mm(row(Fs, bF), K))
    U, _, Vt = svd_small.svd(E)
    U = U * torch.sign(torch.linalg.det(U))  # proper rotations
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = device_const("essential_W", dev, lambda: [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R_a = lie._mm(U, lie._mm(W, Vt))
    R_b = lie._mm(U, lie._mm(W.T, Vt))
    t_u = U[:, 2]
    inl_F = (row(errF, bF) < thF) & mask

    ray1 = cam_ops.unproject(cam, uv1)
    ray2 = cam_ops.unproject(cam, uv2)
    eye, z3 = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    cands = ((R_a, t_u), (R_a, -t_u), (R_b, t_u), (R_b, -t_u))
    counts, Xs = [], []
    for R_c, t_c in cands:
        X, _ = triangulate.triangulate_midpoint(eye, z3, R_c, t_c, ray1, ray2)
        x2 = lie.se3_apply(R_c, t_c, X)
        counts.append(torch.sum(((X[:, 2] > 0) & (x2[:, 2] > 0) & inl_F).to(torch.int32)))
        Xs.append(X)
    counts = torch.stack(counts)
    best = torch.argmax(counts)
    R_best = row(torch.stack([c[0] for c in cands]), best)
    t_best = row(torch.stack([c[1] for c in cands]), best)
    X_best = row(torch.stack(Xs), best)

    n_inl = torch.sum(inl_F.to(torch.int32))
    good = row(counts, best) > 0.8 * torch.clamp(n_inl, min=1)
    return {"success": good & (n_inl >= 30), "R": R_best, "t": t_best, "points": X_best, "inliers": inl_F,
            "n_inliers": n_inl, "h_ratio": ratio_h}
