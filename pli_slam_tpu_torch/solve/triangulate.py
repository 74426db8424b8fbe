"""Two-view DLT triangulation, acceptance checks, midpoint triangulation
and the epipolar gate of fisheye stereo (port of
pli_slam_tpu.solve.triangulate).

The 4x4 DLT system's smallest eigenvector is found by shifted inverse
power iteration with a closed-form (cofactor) 4x4 inverse, as in the
reference, so results follow the same arithmetic.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.consts import device_const


def triangulate_dlt(R1, t1, R2, t2, ray1, ray2):
    """(R_i, t_i): T_cw of the two views; ray_i [N,3] with z=1. Returns [N,3]."""
    P1 = torch.cat([R1, t1[:, None]], dim=1)
    P2 = torch.cat([R2, t2[:, None]], dim=1)
    A = torch.stack(
        [
            ray1[:, 0:1] * P1[2][None] - P1[0][None],
            ray1[:, 1:2] * P1[2][None] - P1[1][None],
            ray2[:, 0:1] * P2[2][None] - P2[0][None],
            ray2[:, 1:2] * P2[2][None] - P2[1][None],
        ],
        dim=1,
    )  # [N,4,4]
    AtA = torch.einsum("nij,nik->njk", A, A)
    diag_scale = torch.einsum("nii->n", AtA) / 4.0
    eye4 = torch.eye(4, dtype=A.dtype, device=A.device)
    M = AtA + 1e-6 * torch.clamp(diag_scale, min=1e-12)[:, None, None] * eye4
    Minv = _inv4x4(M)
    v = torch.ones(AtA.shape[:-2] + (4,), dtype=A.dtype, device=A.device)
    for _ in range(3):
        v = torch.einsum("nij,nj->ni", Minv, v)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)
    w = v[..., 3]
    safe = torch.abs(w) > 1e-9
    X = v[..., :3] / torch.where(safe, w, torch.ones_like(w))[..., None]
    return torch.where(safe[..., None], X, torch.zeros_like(X))


def _inv4x4(m: torch.Tensor) -> torch.Tensor:
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
            - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
            + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0])
        )

    rows = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            cof[i][j] = sign * det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
    det = sum(a[0][j] * cof[0][j] for j in range(4))
    adj = torch.stack([torch.stack([cof[j][i] for j in range(4)], -1) for i in range(4)], -2)
    det_safe = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    return adj / det_safe[..., None, None]


def triangulate_midpoint(R1, t1, R2, t2, ray1, ray2):
    """Midpoint of the closest points of the two rays (batched). Returns
    ([N,3] world points, [N] cosine of the parallax)."""
    Rw1, tw1 = lie.se3_inverse(R1, t1)
    Rw2, tw2 = lie.se3_inverse(R2, t2)
    d1 = torch.einsum("ij,nj->ni", Rw1, ray1)
    d2 = torch.einsum("ij,nj->ni", Rw2, ray2)
    d1 = d1 / torch.clamp(torch.linalg.norm(d1, dim=-1, keepdim=True), min=1e-12)
    d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=-1, keepdim=True), min=1e-12)
    # [d1 -d2][s; u] = tw2 - tw1 in least squares (2x2 normal equations)
    b = tw2 - tw1
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = -torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    b1 = torch.sum(d1 * b, dim=-1)
    b2 = -torch.sum(d2 * b, dim=-1)
    det = a11 * a22 - a12 * a12
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
    s = (b1 * a22 - b2 * a12) / det_safe
    u = (a11 * b2 - a12 * b1) / det_safe
    X = 0.5 * ((tw1 + s[..., None] * d1) + (tw2 + u[..., None] * d2))
    return X, torch.sum(d1 * d2, dim=-1)


def triangulation_checks(cam, R1, t1, R2, t2, X_w, uv1, uv2, sigma2_1, sigma2_2,
                         min_parallax_cos: float = 0.9998, max_chi2: float = 5.991):
    """Positive depth in both views, reprojection chi2 in both, parallax."""
    x1 = lie.se3_apply(R1, t1, X_w)
    x2 = lie.se3_apply(R2, t2, X_w)
    ok = (x1[..., 2] > 0.05) & (x2[..., 2] > 0.05)
    e1 = cam_ops.project(cam, x1) - uv1
    e2 = cam_ops.project(cam, x2) - uv2
    chi1 = torch.sum(e1 * e1, dim=-1) / sigma2_1
    chi2_ = torch.sum(e2 * e2, dim=-1) / sigma2_2
    ok = ok & (chi1 < max_chi2) & (chi2_ < max_chi2)
    _, tw1 = lie.se3_inverse(R1, t1)
    _, tw2 = lie.se3_inverse(R2, t2)
    r1 = X_w - tw1
    r2 = X_w - tw2
    cos_par = torch.sum(r1 * r2, dim=-1) / torch.clamp(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), min=1e-12)
    return ok & (cos_par < min_parallax_cos)


def epipolar_gate(cam, R1, t1, R2, t2, uv1, uv2, thresh: float = 3.84):
    """Pairwise epipolar predicate [N1, N2]: the squared pixel distance of
    uv2 from the epiline of uv1 below `thresh`. F = K^-T [t]x R K^-1 with
    (R, t) = T_c2w o T_wc1, on a pinhole camera with `cam`'s intrinsics."""
    R12, t12 = lie.se3_compose(R2, t2, *lie.se3_inverse(R1, t1))
    E = lie._mm(lie.hat(t12), R12)
    dev = uv1.device
    Kinv = device_const(("inverse_intrinsics", cam.fx, cam.fy, cam.cx, cam.cy), dev, lambda: torch.linalg.inv(
        torch.tensor([[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]], dtype=torch.float32,
                     device=dev)))
    F = lie._mm(Kinv.T, lie._mm(E, Kinv))
    h1 = torch.cat([uv1, torch.ones_like(uv1[:, :1])], dim=1)  # [N1, 3]
    h2 = torch.cat([uv2, torch.ones_like(uv2[:, :1])], dim=1)
    lines = torch.einsum("ij,nj->ni", F, h1)  # the epiline of uv1 in view 2
    num = torch.abs(torch.einsum("mi,ni->nm", h2, lines))  # [N1, N2]
    den = torch.sqrt(lines[:, 0] ** 2 + lines[:, 1] ** 2)[:, None]
    d2 = (num / torch.clamp(den, min=1e-9)) ** 2
    return d2 < thresh
