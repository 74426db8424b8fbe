"""Visual-inertial state estimation: the inertial frame-pose solve and the
closed-form pieces of IMU initialization (port of pli_slam_tpu.solve.inertial).

State per frame: body pose (R_wb, p_w), velocity v_w, biases (bg, ba). The
previous state is fixed (folded into the factor's covariance floor).
Residuals: stereo point reprojection and line endpoint-to-line distances
through the fixed body->camera extrinsics T_cb, the 9-dof preintegration
factor (solve.residuals.imu_residual) and the bias random walk.

Visual Jacobians are analytic; the 15x15 IMU block is forward-mode
autodiff (ops.autodiff.jacfwd, the counterpart of the reference's
`jax.jacfwd`). GN iterations are fixed-count Python loops; the inverse and
the solve are the `_ex` variants, which report failure in `info` on the
device instead of checking it on the host, and the step guards are
`torch.where`, so a solve never makes the host wait.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.ops import autodiff
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie, robust
from pli_slam_tpu_torch.solve import residuals as res
from pli_slam_tpu_torch.solve.gn import PoseObservations
from pli_slam_tpu_torch.utils.config import ImuConfig, OptimizerConfig
from pli_slam_tpu_torch.ops.consts import device_const


@dataclasses.dataclass(frozen=True)
class BodyState:
    """Body state in the world frame."""

    R_wb: torch.Tensor  # [3,3]
    p_w: torch.Tensor  # [3]
    v_w: torch.Tensor  # [3]
    bg: torch.Tensor  # [3]
    ba: torch.Tensor  # [3]


@dataclasses.dataclass(frozen=True)
class Extrinsics:
    """Body->camera transform T_cb (the inverse of the configured Tbc)."""

    R_cb: torch.Tensor  # [3,3]
    t_cb: torch.Tensor  # [3]

    @staticmethod
    def identity(device=None) -> "Extrinsics":
        return Extrinsics(R_cb=torch.eye(3, device=device), t_cb=torch.zeros(3, device=device))

    @staticmethod
    def from_Tbc(Tbc, device=None) -> "Extrinsics":
        """From the body->camera transform T_bc: T_cb = T_bc^-1. Accepts a
        4x4 array or 16 row-major floats; None means identity."""
        if Tbc is None:
            return Extrinsics.identity(device)
        T = torch.as_tensor(Tbc, dtype=torch.float32).reshape(4, 4).to(device)
        R_bc, t_bc = T[:3, :3], T[:3, 3]
        return Extrinsics(R_cb=R_bc.T, t_cb=-lie._einsum("ij,j->i", R_bc.T, t_bc))


def body_state_from_camera(R_cw, t_cw, v_w, bg, ba, ext: Extrinsics) -> BodyState:
    """Invert camera_pose(): the body state from T_cw and T_cb."""
    R_wb = lie._mm(R_cw.T, ext.R_cb)
    p_w = lie._einsum("ij,j->i", R_cw.T, ext.t_cb - t_cw)
    return BodyState(R_wb=R_wb, p_w=p_w, v_w=v_w, bg=bg, ba=ba)


def camera_pose(state: BodyState, ext: Extrinsics):
    """T_cw from the body state: x_c = R_cb R_bw (x_w - p_w) + t_cb."""
    R_cw = lie._mm(ext.R_cb, state.R_wb.T)
    t_cw = ext.t_cb - lie._einsum("ij,j->i", R_cw, state.p_w)
    return R_cw, t_cw


def _state_from_delta(state: BodyState, delta: torch.Tensor) -> BodyState:
    """Right-multiplicative update on the rotation, additive on the rest;
    delta = [dphi, dp, dv, dbg, dba] [..., 15] (leading axes broadcast)."""
    return BodyState(
        R_wb=lie._mm(state.R_wb, lie.so3_exp(delta[..., 0:3])),
        p_w=state.p_w + delta[..., 3:6],
        v_w=state.v_w + delta[..., 6:9],
        bg=state.bg + delta[..., 9:12],
        ba=state.ba + delta[..., 12:15],
    )


def imu_terms(preint: imu_ops.Preintegrated, prev: BodyState, state: BodyState, grav):
    """The 15-dim inertial residual [r_imu, r_bg, r_ba] of `state` against the
    fixed `prev`, and its Jacobian [15, 15] in the state's 15-dof delta."""

    def r_of(x):
        st = _state_from_delta(state, x)
        r_imu = res.imu_residual(preint, prev.R_wb, prev.p_w, prev.v_w, st.R_wb, st.p_w, st.v_w, st.bg, st.ba, grav)
        return torch.cat([r_imu, st.bg - prev.bg, st.ba - prev.ba], dim=-1)

    return autodiff.jacfwd(r_of, torch.zeros(15, dtype=state.p_w.dtype, device=state.p_w.device))


def solve_pose_inertial(cam, ext: Extrinsics, obs: PoseObservations, preint: imu_ops.Preintegrated,
                        prev: BodyState, init: BodyState, opt_cfg: OptimizerConfig, imu_cfg: ImuConfig,
                        cauchy_c2: float = 5.991, gravity_w=None):
    """GN over the 15-dof current state with the previous state fixed.
    Returns (state, inlier_pt, inlier_ln, n_inliers)."""
    dev, dtype = init.p_w.device, init.p_w.dtype
    grav = imu_cfg.gravity if gravity_w is None else gravity_w
    # IMU information from the preintegration covariance PLUS the previous
    # state's uncertainty as fixed floors on the (phi, v, p) blocks: the
    # previous frame is an estimate, and with the raw ~1e-10 covariance the
    # factor would freeze the pose at the IMU prediction
    sig = (imu_cfg.prev_sigma_rot, imu_cfg.prev_sigma_vel, imu_cfg.prev_sigma_pos)
    floor = device_const(("prev_state_floor", sig, dtype), dev,
                         lambda: torch.tensor([s ** 2 for s in sig for _ in range(3)], dtype=dtype))
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye15 = torch.eye(15, dtype=dtype, device=dev)
    cov = preint.cov + torch.diag(floor) + eye9 * 1e-8
    info_imu = torch.linalg.inv_ex(cov).inverse
    dt = torch.clamp(preint.dt, min=1e-3)
    info_bg = eye3 / (imu_cfg.walk_gyro ** 2 * dt)
    info_ba = eye3 / (imu_cfg.walk_acc ** 2 * dt)
    info = torch.block_diag(info_imu, info_bg, info_ba)

    def visual_terms(state: BodyState, pt_mask, ln_mask):
        R_cw, t_cw = camera_pose(state, ext)
        r_pt, _, x_c = res.point_residuals_stereo(cam, R_cw, t_cw, obs.x_w, obs.uvr)
        ones = torch.ones_like(obs.stereo_mask)
        row = torch.stack([ones, ones, obs.stereo_mask], dim=-1).to(r_pt.dtype)
        r_pt = r_pt * row
        # chain rule to the body state: with b = R_bw (x_w - p),
        # d x_c / d dphi = R_cb hat(b) and d x_c / d dp = -R_cb R_bw
        b = lie._einsum("ij,nj->ni", state.R_wb.T, obs.x_w - state.p_w)
        Jproj = res._stereo_jproj(cam, x_c) * row[..., None]
        dxc_dphi = lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(b))
        dxc_dp = -lie._mm(ext.R_cb, state.R_wb.T)
        J_phi = -torch.einsum("nij,njk->nik", Jproj, dxc_dphi)
        J_p = -torch.einsum("nij,jk->nik", Jproj, dxc_dp)

        z = x_c[..., 2]
        m_pt = pt_mask & obs.point_mask & ~(z <= 0.05)
        chi2_pt = torch.sum(r_pt * r_pt, dim=-1) / obs.sigma2_pt
        w_pt = robust.cauchy_weight(chi2_pt, cauchy_c2) / obs.sigma2_pt
        w_pt = torch.where(m_pt, w_pt, torch.zeros_like(w_pt))

        r_ln, _, (xs_c, xe_c, Jd_xc_s, Jd_xc_e) = res.line_residuals(cam, R_cw, t_cw, obs.xs_w, obs.xe_w, obs.l_obs)
        bs = lie._einsum("ij,nj->ni", state.R_wb.T, obs.xs_w - state.p_w)
        be = lie._einsum("ij,nj->ni", state.R_wb.T, obs.xe_w - state.p_w)
        Js_phi = torch.einsum("nj,njk->nk", Jd_xc_s, lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(bs)))
        Je_phi = torch.einsum("nj,njk->nk", Jd_xc_e, lie._einsum("ij,njk->nik", ext.R_cb, lie.hat(be)))
        Js_p = torch.einsum("nj,jk->nk", Jd_xc_s, dxc_dp)
        Je_p = torch.einsum("nj,jk->nk", Jd_xc_e, dxc_dp)
        J_ln_phi = torch.stack([Js_phi, Je_phi], dim=-2)
        J_ln_p = torch.stack([Js_p, Je_p], dim=-2)
        behind_ln = (xs_c[..., 2] <= 0.05) | (xe_c[..., 2] <= 0.05)
        m_ln = ln_mask & obs.line_mask & ~behind_ln
        chi2_ln = torch.sum(r_ln * r_ln, dim=-1) / obs.sigma2_ln
        w_ln = robust.cauchy_weight(chi2_ln, cauchy_c2) / obs.sigma2_ln
        w_ln = torch.where(m_ln, w_ln, torch.zeros_like(w_ln))
        return (r_pt, J_phi, J_p, w_pt, chi2_pt, m_pt), (r_ln, J_ln_phi, J_ln_p, w_ln, chi2_ln, m_ln)

    def gn_iter(state: BodyState, pt_mask, ln_mask):
        (r_pt, J_phi, J_p, w_pt, chi2_pt, m_pt), (r_ln, J_ln_phi, J_ln_p, w_ln, chi2_ln, m_ln) = visual_terms(
            state, pt_mask, ln_mask)
        # the visual Jacobian is in [phi, p]; zero for [v, bg, ba]
        Jv_pt = torch.cat([J_phi, J_p], dim=-1)  # [N,3,6]
        Jv_ln = torch.cat([J_ln_phi, J_ln_p], dim=-1)  # [L,2,6]
        H6 = (torch.einsum("nij,n,nik->jk", Jv_pt, w_pt, Jv_pt)
              + torch.einsum("nij,n,nik->jk", Jv_ln, w_ln, Jv_ln))
        g6 = (torch.einsum("nij,n,ni->j", Jv_pt, w_pt, r_pt)
              + torch.einsum("nij,n,ni->j", Jv_ln, w_ln, r_ln))
        H = torch.nn.functional.pad(H6, (0, 9, 0, 9))
        g = torch.nn.functional.pad(g6, (0, 9))

        r_i, J_i = imu_terms(preint, prev, state, grav)
        H = H + lie._mm(J_i.T, lie._mm(info, J_i))
        g = g + lie._einsum("ij,j->i", J_i.T, lie._einsum("ij,j->i", info, r_i))

        H = H + opt_cfg.damping_init * eye15
        # Jacobi-equilibrated solve: the system mixes information scales from
        # ~1e10 (preintegrated rotation over 50 ms) down to ~1e2 (visual and
        # velocity blocks); a raw float32 factorization returns garbage there
        dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        H_eq = H * dscale[:, None] * dscale[None, :]
        sol, fail = torch.linalg.solve_ex(H_eq, g * dscale)
        delta = -(sol * dscale)
        bad = (fail != 0) | ~torch.all(torch.isfinite(delta)) | (torch.linalg.norm(delta) > 2.0)
        delta = torch.where(bad, torch.zeros_like(delta), delta)
        return _state_from_delta(state, delta), chi2_pt, m_pt, chi2_ln, m_ln

    state = init
    pt_mask = torch.ones(obs.point_mask.shape, dtype=torch.bool, device=dev)
    ln_mask = torch.ones(obs.line_mask.shape, dtype=torch.bool, device=dev)
    rounds = getattr(opt_cfg, "pose_rounds_inertial", opt_cfg.pose_rounds)
    for _ in range(rounds - 1):
        for _ in range(opt_cfg.pose_gn_iters):
            state, chi2_pt, m_pt, chi2_ln, m_ln = gn_iter(state, pt_mask, ln_mask)
        r_pt_n = torch.sqrt(torch.clamp(chi2_pt, min=0.0))
        pt_mask = robust.mad_inlier_mask(r_pt_n, m_pt, opt_cfg.mad_k) | (m_pt & (chi2_pt < cauchy_c2))
        r_ln_n = torch.sqrt(torch.clamp(chi2_ln, min=0.0))
        ln_mask = robust.mad_inlier_mask(r_ln_n, m_ln, opt_cfg.mad_k) | (m_ln & (chi2_ln < cauchy_c2))
    for _ in range(opt_cfg.pose_gn_iters_refine):
        state, chi2_pt, m_pt, chi2_ln, m_ln = gn_iter(state, pt_mask, ln_mask)

    inlier_pt = m_pt & (chi2_pt < cauchy_c2)
    inlier_ln = m_ln & (chi2_ln < 7.815)
    n = torch.sum(inlier_pt.to(torch.int32)) + torch.sum(inlier_ln.to(torch.int32))
    state = dataclasses.replace(state, R_wb=lie.normalize_rotation(state.R_wb))
    return state, inlier_pt, inlier_ln, n


def estimate_gyro_bias(preints: list, dRs_visual: list, prior_info: float = 0.0) -> torch.Tensor:
    """Gyro bias from visual against preintegrated rotations: one
    Gauss-Newton step from bg = 0 on
    sum || Log((dR_preint Exp(JRg bg))^T dR_visual) ||^2 + prior_info ||bg||^2."""
    like = preints[0].dR
    H = torch.zeros((3, 3), dtype=like.dtype, device=like.device)
    g = torch.zeros(3, dtype=like.dtype, device=like.device)
    for p, dR_vis in zip(preints, dRs_visual):
        r = lie.so3_log(lie._mm(p.dR.T, dR_vis))
        J = p.JRg
        H = H + lie._mm(J.T, J)
        g = g + lie._einsum("ij,j->i", J.T, r)
    return torch.linalg.solve_ex(H + (prior_info + 1e-9) * lie._eye3(H), g).result


def estimate_gyro_bias_chain(preint, mask: torch.Tensor, R_wb: torch.Tensor, prior_info: float = 0.0) -> torch.Tensor:
    """`estimate_gyro_bias` over a stacked chain `preint` [K] (factor i spans
    body poses i -> i + 1 of `R_wb` [K+1,3,3]) with `mask` [K], on the
    device: each factor's normal equations added in the chain's order, a
    masked factor adding exact zeros, so that the result is the list form's
    over the live factors bit for bit (no host read: the count is static)."""
    zero = torch.zeros((), dtype=R_wb.dtype, device=R_wb.device)
    H = torch.zeros((3, 3), dtype=R_wb.dtype, device=R_wb.device)
    g = torch.zeros(3, dtype=R_wb.dtype, device=R_wb.device)
    for i in range(mask.shape[0]):
        r = lie.so3_log(lie._mm(preint.dR[i].T, lie._mm(R_wb[i].T, R_wb[i + 1])))
        J = preint.JRg[i]
        H = H + torch.where(mask[i], lie._mm(J.T, J), zero)
        g = g + torch.where(mask[i], lie._einsum("ij,j->i", J.T, r), zero)
    return torch.linalg.solve_ex(H + (prior_info + 1e-9) * lie._eye3(H), g).result


def gravity_rotation(dirG: torch.Tensor) -> torch.Tensor:
    """R_wg that turns world -z onto the direction `dirG` (normalized here)."""
    dirG = dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9)
    gI = device_const(("down", dirG.dtype), dirG.device, lambda: torch.tensor([0.0, 0.0, -1.0], dtype=dirG.dtype))
    v = torch.linalg.cross(gI, dirG)
    ang = torch.acos(torch.clamp(torch.dot(gI, dirG), -1.0, 1.0))
    axis = v / torch.clamp(torch.linalg.norm(v), min=1e-9)
    return lie.so3_exp(axis * ang)


def estimate_gravity_direction(preints: list, R_wb_list: list, gravity: float = 9.81) -> torch.Tensor:
    """World gravity direction from summed velocity deltas, dirG = -sum_k
    R_wb_k dV_k. Returns R_wg aligning world -z to the estimated gravity."""
    dirG = torch.zeros_like(preints[0].dV)
    for p, R_wb in zip(preints, R_wb_list):
        dirG = dirG - lie._einsum("ij,j->i", R_wb, p.dV)
    return gravity_rotation(dirG)
