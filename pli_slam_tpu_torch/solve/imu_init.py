"""Joint visual-inertial initialization: the inertial-only MAP problem
(port of pli_slam_tpu.solve.imu_init).

One dense Gauss-Newton over the packed state

    x = [ dphi_g (2), log_s (1), bg (3), ba (3), v_0..v_{K-1} (3K) ]

with the 9-dof preintegration residual between consecutive keyframes
(gravity = Rwg0 Exp([dphi; 0]) g0, keyframe positions scaled by s, poses
fixed), whitened by the Cholesky factor of the floored information, plus
bias priors. The system is tiny (K <= 32 -> dim <= 105): the whole residual
vector is differentiated in forward mode (ops.autodiff.jacfwd; the chain's
factors are one batch inside it) and solved densely per iteration. The
reference's `lax.scan` over iterations is a Python loop. Nothing reads the
device and every constant comes from ops.consts, so the tracker's
"imu_init" stage (frontend.step.imu_init) captures it into a CUDA graph.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import autodiff
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.consts import device_const
from pli_slam_tpu_torch.solve import residuals as res
from pli_slam_tpu_torch.solve.inertial import gravity_rotation
from pli_slam_tpu_torch.utils.config import ImuConfig


def inertial_optimization(preint, chain_mask, R_wb, p_wb, v0, Rwg0, bg0, ba0, imu_cfg: ImuConfig,
                          prior_g: float = 1e2, prior_a: float = 1e6, fix_scale: bool = True,
                          fix_bias: bool = False, iters: int = 15):
    """`preint`: stacked chain factors [K-1] (k -> k+1) with `chain_mask`
    [K-1]; R_wb [K,3,3] and p_wb [K,3] body poses from visual SLAM (fixed,
    positions up to scale); v0 [K,3]; Rwg0 [3,3] the initial gravity-direction
    rotation. Returns (Rwg, scale, bg, ba, v [K,3], costs [iters]);
    gravity_w = Rwg @ [0, 0, -gravity]."""
    K = R_wb.shape[0]
    D = 9 + 3 * K
    dev, dtype = R_wb.device, R_wb.dtype
    g0 = device_const(("gravity_vector", imu_cfg.gravity, dtype), dev,
                      lambda: torch.tensor([0.0, 0.0, -imu_cfg.gravity], dtype=dtype))
    # per-factor information from the floored preintegration covariance,
    # applied as its Cholesky factor so GN sees whitened residuals
    info = torch.linalg.inv_ex(preint.cov + torch.eye(9, dtype=dtype, device=dev) * 1e-6).inverse  # [K-1,9,9]
    Lw, fail = torch.linalg.cholesky_ex(info)
    Lw = torch.where((fail != 0)[:, None, None], torch.full_like(Lw, float("nan")), Lw)
    sq_g, sq_a = float(prior_g) ** 0.5, float(prior_a) ** 0.5

    def unpack(x):
        dphi = torch.nn.functional.pad(x[..., 0:2], (0, 1))
        Rwg = lie._mm(Rwg0, lie.so3_exp(dphi))
        s = torch.ones_like(x[..., 2]) if fix_scale else torch.exp(x[..., 2])
        return Rwg, s, bg0 + x[..., 3:6], ba0 + x[..., 6:9], x[..., 9:].reshape(x.shape[:-1] + (K, 3))

    def residuals(x):  # [..., D] -> [..., 9 (K-1) + 6]
        Rwg, s, bg, ba, v = unpack(x)
        g_w = imu_ops._mv(Rwg, g0)
        p = s[..., None, None] * p_wb
        r = res.imu_residual(preint, R_wb[:-1], p[..., :-1, :], v[..., :-1, :], R_wb[1:], p[..., 1:, :],
                             v[..., 1:, :], bg[..., None, :], ba[..., None, :], g_w[..., None, :])
        r_chain = imu_ops._mv(Lw, r)  # [..., K-1, 9]
        r_chain = torch.where(chain_mask[:, None], r_chain, torch.zeros_like(r_chain))
        return torch.cat([r_chain.reshape(r_chain.shape[:-2] + (-1,)), sq_g * bg, sq_a * ba], dim=-1)

    x = torch.cat([torch.zeros(9, dtype=dtype, device=dev), v0.reshape(-1)])
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    held = ([2] if fix_scale else []) + (list(range(3, 9)) if fix_bias else [])
    # held variables (the scale for stereo; the biases in scale-refinement
    # mode) keep their linearization point: unit row and column, zero gradient
    free = device_const(("map_free", D, tuple(held)), dev,
                        lambda: torch.tensor([i not in held for i in range(D)]))
    free2, held_diag = free[:, None] & free[None, :], torch.diag(~free)
    zero = torch.zeros((), dtype=dtype, device=dev)
    costs = []
    for _ in range(iters):
        r, J = autodiff.jacfwd(residuals, x)  # [R], [R, D]
        H = lie._mm(J.T, J) + 1e-6 * eyeD
        g = lie._einsum("ij,j->i", J.T, r)
        if held:
            H = torch.where(held_diag, torch.ones_like(H), torch.where(free2, H, zero))
            g = torch.where(free, g, zero)
        dx = -torch.linalg.solve_ex(H, g).result
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, torch.zeros_like(dx))
        x = x + dx
        costs.append(torch.sum(r * r))
    Rwg, s, bg, ba, v = unpack(x)
    return Rwg, s, bg, ba, v, torch.stack(costs)


def gravity_dir_seed(preint, chain_mask, R_wb, gravity: float):
    """Heuristic gravity direction from summed preintegrated velocity
    deltas, dirG = -sum R_wb dV. Returns Rwg, which maps world -z onto it."""
    dV_w = torch.einsum("kij,kj->ki", R_wb[:-1], preint.dV)
    dirG = -torch.sum(torch.where(chain_mask[:, None], dV_w, torch.zeros_like(dV_w)), dim=0)
    return gravity_rotation(dirG)


def velocity_seed(p_wb: torch.Tensor, stamps: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Central-difference keyframe velocities from positions. With `n_valid`
    (a 0-d device int) only the first `n_valid` rows are keyframes: the
    differences stop at the last of them, and the rows after it are zero."""
    K = p_wb.shape[0]
    ar = torch.arange(K, device=p_wb.device)
    if n_valid is None:
        a = torch.clamp(ar - 1, 0, K - 1)
        b = torch.clamp(ar + 1, 0, K - 1)
    else:
        last = n_valid.to(ar.dtype) - 1
        a = torch.minimum(torch.clamp(ar - 1, min=0), last)
        b = torch.minimum(ar + 1, last)
    dt = torch.clamp(stamps[b] - stamps[a], min=1e-6)
    v = (p_wb[b] - p_wb[a]) / dt[:, None]
    return v if n_valid is None else torch.where((ar < n_valid)[:, None], v, torch.zeros_like(v))
