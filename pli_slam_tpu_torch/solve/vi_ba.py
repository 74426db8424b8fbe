"""Visual-inertial windowed bundle adjustment (port of pli_slam_tpu.solve.vi_ba).

The per-pose state is 15-dof (T_cw twist, velocity, gyro bias, accel bias).
Landmarks are eliminated exactly as in solve.ba (`assemble_visual` gives the
reduced camera system of the 6-dof pose part); the preintegration and
bias-random-walk factors between consecutive window keyframes add pose-pose
blocks to the dense reduced system [15 W, 15 W].

Each IMU factor is a 15-dim residual differentiated in forward mode over
its two poses' 30 state dofs, all W-1 factors of the chain in one batch
(ops.autodiff.jacfwd; the reference's `jax.vmap(jax.jacfwd)`). Both parts
share the left-multiplicative T_cw twist; the factor converts camera->body
through the fixed extrinsics T_cb inside the residual. The reference's
`_DEBUG_CAPTURE` hook is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.ops import autodiff
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.solve import ba as ba_mod
from pli_slam_tpu_torch.solve import residuals as res
from pli_slam_tpu_torch.utils.config import ImuConfig, OptimizerConfig
from pli_slam_tpu_torch.ops.consts import device_const


@dataclasses.dataclass(frozen=True)
class VIBAProblem:
    """BAProblem + per-pose inertial state + chain preintegrations."""

    base: ba_mod.BAProblem
    v: torch.Tensor  # [W,3] world velocities
    bg: torch.Tensor  # [W,3]
    ba: torch.Tensor  # [W,3]
    preint: imu_ops.Preintegrated  # stacked [W-1, ...] chain factors
    imu_mask: torch.Tensor  # [W-1] bool: the factor between k and k+1 is valid
    gravity_w: torch.Tensor  # [3]
    R_cb: torch.Tensor  # [3,3] body->camera rotation (Extrinsics)
    t_cb: torch.Tensor  # [3]


def _imu_chain_residual(prob: VIBAProblem, R, t, v, bg, ba_, k, delta_i, delta_j, imu_cfg: ImuConfig):
    """15-dim residual of chain factor `k` under state perturbations. `k` is
    an int (one factor; deltas [..., 15]) or an index tensor [F] (those
    factors at once; deltas [..., F, 15])."""

    def perturb(Rk, tk, vk, bgk, bak, d):
        dR, dt = lie.se3_exp(d[..., :6])
        return (lie._mm(dR, Rk), imu_ops._mv(dR, tk) + dt, vk + d[..., 6:9], bgk + d[..., 9:12],
                bak + d[..., 12:15])

    Ri, ti, vi, bgi, bai = perturb(R[k], t[k], v[k], bg[k], ba_[k], delta_i)
    Rj, tj, vj, bgj, baj = perturb(R[k + 1], t[k + 1], v[k + 1], bg[k + 1], ba_[k + 1], delta_j)
    # camera -> body through T_cb: R_wb = R_cw^T R_cb, p = R_cw^T (t_cb - t_cw)
    Rit, Rjt = Ri.transpose(-1, -2), Rj.transpose(-1, -2)
    Rwi = lie._mm(Rit, prob.R_cb)
    pwi = imu_ops._mv(Rit, prob.t_cb - ti)
    Rwj = lie._mm(Rjt, prob.R_cb)
    pwj = imu_ops._mv(Rjt, prob.t_cb - tj)
    pre_k = imu_ops._map(lambda x: x[k], prob.preint)
    r_imu = res.imu_residual(pre_k, Rwi, pwi, vi, Rwj, pwj, vj, bgi, bai, prob.gravity_w)
    return torch.cat([r_imu, bgj - bgi, baj - bai], dim=-1)


def chain_linearization(prob: VIBAProblem, R, t, v, bg, ba_, imu_cfg: ImuConfig):
    """Residuals [W-1, 15] of every chain factor and their Jacobians
    [W-1, 15, 15] in the 15-dof deltas of the factor's first and second pose."""
    W = R.shape[0]
    ks = torch.arange(W - 1, device=R.device)

    def f(d):  # [..., W-1, 30] -> [..., W-1, 15]
        return _imu_chain_residual(prob, R, t, v, bg, ba_, ks, d[..., :15], d[..., 15:], imu_cfg)

    r_f, J = autodiff.jacfwd(f, torch.zeros((W - 1, 30), dtype=R.dtype, device=R.device))
    return r_f, J[..., :15], J[..., 15:]


def reduced_system(cam, prob: VIBAProblem, idx_p, idx_l, R, t, v, bg, ba_, pts, lns, cfg: OptimizerConfig,
                   imu_cfg: ImuConfig, damping, dtype):
    """The damped, gauged reduced system of one iteration in `dtype`, formed
    from the state's (float32) linearization: (Sd [15 W, 15 W], rhs [15 W],
    point blocks, line blocks, the visual cost, (r_f [W-1, 15], info
    [W-1, 15, 15]): the chain factors' residuals and their masked information)."""
    base = prob.base
    W = R.shape[0]
    D = 15
    dev = R.device

    # ---- visual part: the shared scatter-free assembly of solve.ba ------
    S6, rhs6, blk_p, blk_l, cost, _chi2_p, _chi2_l = ba_mod.assemble_visual(cam, base, idx_p, idx_l, R, t, pts, lns,
                                                                            cfg, damping, dtype)

    # ---- lift to the 15-dof system --------------------------------------
    S = torch.zeros((W, W, D, D), dtype=dtype, device=dev)
    S[:, :, :6, :6] = S6
    rhs = torch.nn.functional.pad(rhs6, (0, D - 6))

    # ---- IMU chain factors ----------------------------------------------
    dtk = torch.clamp(prob.preint.dt.to(dtype), min=1e-3)  # [W-1]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    # covariance floor: short-window preintegration covariances underflow
    # float32 to ~0, and unfloored information (~1e8+) swamps the visual blocks
    info_imu = torch.linalg.inv_ex(prob.preint.cov.to(dtype) + torch.eye(9, dtype=dtype, device=dev) * 1e-6).inverse
    info = torch.zeros((W - 1, D, D), dtype=dtype, device=dev)
    info[:, :9, :9] = info_imu
    info[:, 9:12, 9:12] = eye3 / (imu_cfg.walk_gyro ** 2 * dtk)[:, None, None]
    info[:, 12:15, 12:15] = eye3 / (imu_cfg.walk_acc ** 2 * dtk)[:, None, None]
    info = info * prob.imu_mask.to(dtype)[:, None, None]

    r_f, Ji_f, Jj_f = (x.to(dtype) for x in chain_linearization(prob, R, t, v, bg, ba_, imu_cfg))
    Hii = torch.einsum("kai,kab,kbj->kij", Ji_f, info, Ji_f)
    Hjj = torch.einsum("kai,kab,kbj->kij", Jj_f, info, Jj_f)
    Hij = torch.einsum("kai,kab,kbj->kij", Ji_f, info, Jj_f)
    gi = torch.einsum("kai,kab,kb->ki", Ji_f, info, r_f)
    gj = torch.einsum("kai,kab,kb->ki", Jj_f, info, r_f)
    ks = torch.arange(W - 1, device=dev)
    # each add hits distinct (row, column) blocks
    S[ks, ks] += Hii
    S[ks + 1, ks + 1] += Hjj
    S[ks, ks + 1] += Hij
    S[ks + 1, ks] += Hij.transpose(-1, -2)
    rhs[:-1] -= gi
    rhs[1:] -= gj

    # ---- gauge + damping ------------------------------------------------
    # Only the POSE dofs of gauge/boundary keyframes are fixed; their
    # velocities and biases stay free (hard-fixing them would anchor the
    # whole velocity chain to the boundary value through the r_v factors)
    eyeD = torch.eye(D, dtype=dtype, device=dev)
    exists = base.pose_mask.to(dtype)
    pose_free = (base.pose_mask & ~base.fixed_mask).to(dtype)
    dof_free = torch.cat([pose_free[:, None].expand(W, 6), exists[:, None].expand(W, 9)], dim=1)  # [W, D]
    S = S * dof_free[:, None, :, None] * dof_free[None, :, None, :]
    # soft priors on the boundary keyframes' inertial states: velocity
    # information 1e2, bias information 1e4
    prior = device_const(("viba_boundary_prior", R.dtype), dev,
                         lambda: torch.tensor([0.0] * 6 + [1e2] * 3 + [1e4] * 6, dtype=R.dtype)).to(dtype)
    fixed_f = (base.fixed_mask & base.pose_mask).to(dtype)
    ar = torch.arange(W, device=dev)
    S[ar, ar] += eyeD[None] * ((1.0 - dof_free)[:, None, :] + fixed_f[:, None, None] * prior[None, None, :]) \
        + damping * eyeD
    rhs = rhs * dof_free
    return S.permute(0, 2, 1, 3).reshape(W * D, W * D), rhs.reshape(-1), blk_p, blk_l, cost, (r_f, info)


def solve_step(Sd, rhs):
    """The Jacobi-equilibrated solve of `reduced_system`'s output in its
    dtype: (delta [W, 15] with each keyframe's step clamped to norm 3, bad:
    the solve failed or was not finite and delta is zero, the steps' norms
    [W] before the clamp)."""
    # Jacobi equilibration: the IMU information blocks sit ~5 orders of
    # magnitude above the visual ones
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Sd), min=1e-12))
    Sd_eq = Sd * dscale[:, None] * dscale[None, :]
    sol, fail = torch.linalg.solve_ex(Sd_eq, rhs * dscale)
    delta = (sol * dscale).reshape(-1, 15)
    bad = (fail != 0) | ~torch.all(torch.isfinite(delta))
    delta = torch.where(bad, torch.zeros((), dtype=Sd.dtype, device=Sd.device), delta)
    # trust-region style guard: clamp outsized steps
    step_norm = torch.linalg.norm(delta, dim=-1, keepdim=True)
    return delta * torch.clamp(3.0 / torch.clamp(step_norm, min=1e-9), max=1.0), bad, step_norm[:, 0]


def system_dtype(R: torch.Tensor) -> torch.dtype:
    """The default precision of `vi_ba_iteration`'s reduced system for a
    state like `R`: `ba.reduced_dtype` of its device, or the state's own
    where that is wider (a float64 state keeps a float64 system)."""
    return torch.promote_types(ba_mod.reduced_dtype(R.device), R.dtype)


def vi_ba_iteration(cam, prob: VIBAProblem, idx_p, idx_l, R, t, v, bg, ba_, pts, lns,
                    cfg: OptimizerConfig, imu_cfg: ImuConfig, damping, dtype=None):
    """One damped GN iteration. The reduced system is formed from the
    linearization, solved and the landmarks back-substituted in `dtype`
    (`system_dtype` by default: float64 on CUDA, the reference's float32
    for a float32 state elsewhere); the steps and the state keep the
    state's precision."""
    dtype = system_dtype(R) if dtype is None else dtype
    Sd, rhs, (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l), _cost, _chain = reduced_system(
        cam, prob, idx_p, idx_l, R, t, v, bg, ba_, pts, lns, cfg, imu_cfg, damping, dtype)
    delta, bad, _ = solve_step(Sd, rhs)

    # ---- back-substitute landmarks (6-dof part only) ---------------------
    dp6 = delta[:, :6]
    zero = torch.zeros((), dtype=dtype, device=R.device)
    delta_pt = torch.where(bad, zero, ba_mod.back_substitute(Wb_p, Hll_p_inv, gl_p, dp6))
    delta_ln = torch.where(bad, zero, ba_mod.back_substitute(Wb_l, Hll_l_inv, gl_l, dp6))
    delta, delta_pt, delta_ln = (x.to(R.dtype) for x in (delta, delta_pt, delta_ln))

    dR, dt = lie.se3_exp(delta[:, :6])
    R_new = lie.normalize_rotation(torch.einsum("wij,wjk->wik", dR, R))
    t_new = torch.einsum("wij,wj->wi", dR, t) + dt
    v_new = v + delta[:, 6:9]
    bg_new = bg + delta[:, 9:12]
    ba_new = ba_ + delta[:, 12:15]
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    pts_new = pts + torch.where(active_p[:, None], delta_pt, zero)
    lns_new = lns + torch.where(active_l[:, None], delta_ln, zero)
    return R_new, t_new, v_new, bg_new, ba_new, pts_new, lns_new


def solve_vi_ba(cam, prob: VIBAProblem, cfg: OptimizerConfig, imu_cfg: ImuConfig, iters: int | None = None):
    """Fixed-iteration damped GN over the visual-inertial window."""
    iters = cfg.local_ba_iters if iters is None else iters
    damping = torch.full((), cfg.damping_init, dtype=torch.float32, device=prob.base.R.device)
    idx_p, idx_l = ba_mod.prepare_indices(prob.base)
    state = (prob.base.R, prob.base.t, prob.v, prob.bg, prob.ba, prob.base.pts, prob.base.lns)
    for _ in range(iters):
        state = vi_ba_iteration(cam, prob, idx_p, idx_l, *state, cfg, imu_cfg, damping)
    return state
