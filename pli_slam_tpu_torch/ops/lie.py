"""SO(3) / SE(3) / Sim(3) Lie-group operations in torch (port of
pli_slam_tpu.ops.lie).

Same conventions as the reference: rotations `[..., 3, 3]`, vectors
`[..., 3]`, SE(3) as (R, t) with T x = R x + t, twists [rho, phi]
(translation first), Sim(3) as (R, t, s) with x -> s R x + t and twists
[rho, phi, sigma]. Taylor fallbacks near theta = 0 keep float32 safe.
Quaternions are (w, x, y, z).

Every function is functional (no in-place write, no `.item()`, no Python
branch on a tensor), so `torch.func.jacfwd` and `vmap` go through them:
the IMU factor's Jacobians are taken that way (solve.inertial, solve.vi_ba,
solve.imu_init). The `torch.where` branches keep the untaken side finite
at zero perturbation (`t2_safe`, `small_s`).

TF32 is off (package `__init__`), so `_mm` / `_einsum` are full float32
like the reference's `Precision.HIGHEST`.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-6


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *ops)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v). [...,3] -> [...,3,3]."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) given t^2, Taylor near 0."""
    small = theta2 < _EPS
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (t2_safe * theta))
    return a, b, c


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    W = hat(w)
    I = _eye3(w).expand(W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [...,3,3] -> axis-angle [...,3] (near 0 and near pi safe)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_asym = vee(R - R.transpose(-1, -2)) * 0.5
    sin_norm2 = torch.sum(w_asym * w_asym, dim=-1)
    small_s = sin_norm2 < 1e-12
    sin_t = torch.sqrt(torch.where(small_s, torch.ones_like(sin_norm2), sin_norm2))
    sin_t = torch.where(small_s, torch.zeros_like(sin_t), sin_t)
    theta = torch.atan2(sin_t, cos_t)
    small_th = theta < 1e-3
    scale = torch.where(
        small_th,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small_th, torch.ones_like(sin_t), torch.clamp(sin_t, min=1e-12)),
    )
    w_generic = w_asym * scale[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    diag_k = torch.gather(diag, -1, k[..., None])[..., 0]
    a_k = torch.sqrt(torch.clamp((diag_k + 1.0) * 0.5, min=1e-12))
    one_minus_cos = torch.clamp(1.0 - cos_t, min=1e-6)
    S = (R + R.transpose(-1, -2)) * 0.5
    rows = torch.gather(S, -2, k[..., None, None].expand(S.shape[:-2] + (1, 3)))[..., 0, :]
    axis_unnorm = rows / (one_minus_cos * a_k)[..., None]
    onehot_k = torch.nn.functional.one_hot(k, 3).to(torch.bool)
    axis_unnorm = torch.where(onehot_k, a_k[..., None].expand(axis_unnorm.shape), axis_unnorm)
    norm = torch.linalg.norm(axis_unnorm, dim=-1, keepdim=True)
    axis_pi = axis_unnorm / torch.clamp(norm, min=1e-12)
    sin_norm = torch.linalg.norm(w_asym, dim=-1)
    theta_pi = math.pi - torch.asin(torch.clamp(sin_norm, 0.0, 1.0))
    dot = torch.sum(axis_pi * w_asym, dim=-1)
    axis_pi = torch.where((dot < -1e-9)[..., None], -axis_pi, axis_pi)
    w_pi = axis_pi * theta_pi[..., None]
    near_pi = (math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr of SO(3): Exp(w + dw) ~ Exp(w) Exp(Jr dw)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(w)
    I = _eye3(w).expand(W.shape)
    return I - b[..., None, None] * W + c[..., None, None] * _mm(W, W)


def so3_right_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3)."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    # coefficient of W^2: 1/t^2 - (1 + cos t)/(2 t sin t); Taylor 1/12 + t^2/720
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / t2_safe - (1.0 + torch.cos(theta)) / (2.0 * theta * torch.clamp(torch.sin(theta), min=1e-12)),
    )
    W = hat(w)
    I = _eye3(w).expand(W.shape)
    return I + 0.5 * W + cot_term[..., None, None] * _mm(W, W)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Closest rotation via SVD (reference NormalizeRotation)."""
    u, _, vt = torch.linalg.svd(R, full_matrices=False)
    det = torch.linalg.det(_mm(u, vt))
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[..., None, None]], dim=-1)
    return _mm(u, vt)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Twist [...,6] = [rho, phi] -> (R, t) with t = V(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    W = hat(phi)
    I = _eye3(xi).expand(W.shape)
    R = so3_exp(phi)
    V = I + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    t = _einsum("...ij,...j->...i", V, rho)
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < _EPS
    W = hat(phi)
    I = _eye3(R).expand(W.shape)
    half_t = theta * 0.5
    cot_half = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t) / torch.clamp(torch.sin(half_t), min=1e-12))
        / torch.clamp(theta2, min=1e-24),
    )
    Vinv = I - 0.5 * W + cot_half[..., None, None] * _mm(W, W)
    rho = _einsum("...ij,...j->...i", Vinv, t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): first apply b, then a."""
    return _mm(Ra, Rb), _einsum("...ij,...j->...i", Ra, tb) + ta


def se3_apply(R, t, x):
    return _einsum("...ij,...j->...i", R, x) + t


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack (R, t) into a homogeneous [..., 4, 4] matrix."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)), t.expand(batch + (3,))[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s), action x -> s R x + t; twists [rho, phi, sigma], sigma = log s
# ---------------------------------------------------------------------------


def sim3_exp(xi: torch.Tensor):
    """Twist [..., 7] -> (R, t, s), with the reference's Taylor branches."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3_exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    W = hat(phi)
    I = _eye3(xi).expand(W.shape)
    small_sig = torch.abs(sigma) < _EPS
    small_th = theta2 < _EPS
    one = torch.ones_like(sigma)
    a_coef = torch.where(small_sig, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                         (s - 1.0) / torch.where(small_sig, one, sigma))
    sig2t2 = sigma * sigma + theta2
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = s * sin_t
    B = s * cos_t
    den1 = torch.where(small_th, one, theta * sig2t2)
    den2 = torch.where(small_th, one, sig2t2)
    den3 = torch.where(small_th, one, theta2)
    b_gen = (A * sigma + (1.0 - B) * theta) / den1
    c_gen = (a_coef - ((B - 1.0) * sigma + A * theta) / den2) / den3
    b_small = torch.where(small_sig, 0.5 + sigma / 3.0,
                          (sigma * s - s + 1.0) / torch.where(small_sig, one, sigma * sigma))
    c_small = 1.0 / 6.0 + sigma / 8.0
    b_ = torch.where(small_th, b_small, b_gen)
    c_ = torch.where(small_th, c_small, c_gen)
    V = a_coef[..., None, None] * I + b_[..., None, None] * W + c_[..., None, None] * _mm(W, W)
    return R, _einsum("...ij,...j->...i", V, rho), s


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return _mm(Ra, Rb), sa[..., None] * _einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb


def sim3_apply(R, t, s, x):
    return s[..., None] * _einsum("...ij,...j->...i", R, x) + t


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_from_rotation(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] with w >= 0 (Shepperd)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)
    cases = torch.stack([q0, q1, q2, q3], dim=-2)
    k = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cases, -2, k[..., None, None].expand(cases.shape[:-2] + (1, 4)))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.where(q[..., :1] < 0, -q, q)


def rotation_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z), normalized first -> rotation [..., 3, 3]."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )
