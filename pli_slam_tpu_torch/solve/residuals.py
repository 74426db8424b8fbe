"""Point and line residual blocks with analytic pose Jacobians, and the
IMU preintegration factor (port of pli_slam_tpu.solve.residuals).

Pose convention: T_cw = (R_cw, t_cw), x_c = R_cw x_w + t_cw; updates are
left-multiplicative twists (rho, phi). The mono point residual, the
landmark Jacobians and `make_pose_prior` are on no path of either package;
the reference's tests call them.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie


def transform_points(R_cw, t_cw, x_w):
    return lie._einsum("ij,...j->...i", R_cw, x_w) + t_cw


def _dxc_dpose(x_c: torch.Tensor) -> torch.Tensor:
    """d x_c / d delta = [I | -hat(x_c)], [N,3,6]."""
    eye = torch.eye(3, dtype=x_c.dtype, device=x_c.device).expand(x_c.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.hat(x_c)], dim=-1)


def _stereo_jproj(cam, x_c):
    """d(u_l, v_l, u_r)/d x_c, [N,3,3]; u_r = u_l - bf/z."""
    J2 = cam_ops.project_jacobian(cam, x_c)
    z = x_c[..., 2]
    inv_z2 = 1.0 / torch.clamp(z * z, min=1e-12)
    zero = torch.zeros_like(z)
    Jr = J2[..., 0, :] + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    return torch.cat([J2, Jr[..., None, :]], dim=-2)


def point_residuals_mono(cam, R_cw, t_cw, x_w, uv_obs):
    """Mono reprojection. Returns (r [N,2], J_pose [N,2,6], x_c [N,3])."""
    x_c = transform_points(R_cw, t_cw, x_w)
    r = uv_obs - cam_ops.project(cam, x_c)
    J_pose = -torch.einsum("nij,njk->nik", cam_ops.project_jacobian(cam, x_c), _dxc_dpose(x_c))
    return r, J_pose, x_c


def point_residuals_stereo(cam, R_cw, t_cw, x_w, uvr_obs):
    """Stereo reprojection (u_l, v_l, u_r). Returns (r [N,3], J_pose [N,3,6], x_c)."""
    x_c = transform_points(R_cw, t_cw, x_w)
    r = uvr_obs - cam_ops.stereo_project(cam, x_c)
    J_pose = -torch.einsum("nij,njk->nik", _stereo_jproj(cam, x_c), _dxc_dpose(x_c))
    return r, J_pose, x_c


def point_residuals_landmark_jac(cam, R_cw, x_c, stereo: bool):
    """d r / d x_w for BA: -J_proj @ R_cw, [N, 2 or 3, 3]."""
    J_proj = _stereo_jproj(cam, x_c) if stereo else cam_ops.project_jacobian(cam, x_c)
    return -torch.einsum("nij,jk->nik", J_proj, R_cw)


def line_residuals(cam, R_cw, t_cw, xs_w, xe_w, l_obs):
    """Signed distances of the projected endpoints to the observed line.
    Returns (r [N,2], J_pose [N,2,6], (xs_c, xe_c, Jd_xc_s, Jd_xc_e))."""

    def endpoint(x_w):
        x_c = transform_points(R_cw, t_cw, x_w)
        uv = cam_ops.project(cam, x_c)
        d = l_obs[..., 0] * uv[..., 0] + l_obs[..., 1] * uv[..., 1] + l_obs[..., 2]
        J_proj = cam_ops.project_jacobian(cam, x_c)
        Jd_xc = torch.einsum("ni,nij->nj", l_obs[..., :2], J_proj)
        Jd_pose = torch.einsum("nj,njk->nk", Jd_xc, _dxc_dpose(x_c))
        return d, Jd_pose, x_c, Jd_xc

    ds, Js, xs_c, Jd_xc_s = endpoint(xs_w)
    de, Je, xe_c, Jd_xc_e = endpoint(xe_w)
    return torch.stack([ds, de], dim=-1), torch.stack([Js, Je], dim=-2), (xs_c, xe_c, Jd_xc_s, Jd_xc_e)


def line_residuals_landmark_jac(R_cw, Jd_xc_s, Jd_xc_e):
    """d r / d (xs_w, xe_w) for BA, [N, 2, 6]: row 0 depends on xs_w only,
    row 1 on xe_w only (`Jd_xc_*` from `line_residuals`)."""
    Js = torch.einsum("nj,jk->nk", Jd_xc_s, R_cw)
    Je = torch.einsum("nj,jk->nk", Jd_xc_e, R_cw)
    z = torch.zeros_like(Js)
    return torch.stack([torch.cat([Js, z], dim=-1), torch.cat([z, Je], dim=-1)], dim=-2)


def make_pose_prior(R_prior, t_prior, weight: float):
    """6-dof pose prior factory: prior(R_cw, t_cw) -> weight * [r_t, r_phi]
    with dR = R_cw R_prior^T, r_phi = log(dR), r_t = t_cw - dR t_prior."""

    def prior(R_cw, t_cw):
        dR = lie._mm(R_cw, R_prior.transpose(-1, -2))
        return weight * torch.cat([t_cw - lie._einsum("ij,j->i", dR, t_prior), lie.so3_log(dR)])

    return prior


def imu_residual(preint, R0, p0, v0, R1, p1, v1, bg, ba, gravity=9.81):
    """9-dof preintegration factor r = [r_phi, r_v, r_p] between body states
    0 and 1 (R_wb, p_w, v_w), biases at state 0. `gravity` is a magnitude
    (world -z) or a world vector [3]. Returns r [..., 9]: every argument
    may carry leading batch axes (a chain of factors, a batch of perturbed
    states), which broadcast. The function is functional, so forward-mode
    autodiff goes through it (ops.autodiff.jacfwd at the call sites)."""
    from pli_slam_tpu_torch.ops import imu as imu_ops

    g = imu_ops.gravity_vector(gravity, R0)
    dt = preint.dt[..., None]
    dR = imu_ops.delta_rotation(preint, bg)
    dV = imu_ops.delta_velocity(preint, bg, ba)
    dP = imu_ops.delta_position(preint, bg, ba)
    R0t = R0.transpose(-1, -2)
    r_phi = lie.so3_log(lie._mm(dR.transpose(-1, -2), lie._mm(R0t, R1)))
    r_v = imu_ops._mv(R0t, v1 - v0 - g * dt) - dV
    r_p = imu_ops._mv(R0t, p1 - p0 - v0 * dt - 0.5 * g * dt * dt) - dP
    return torch.cat([r_phi, r_v, r_p], dim=-1)
