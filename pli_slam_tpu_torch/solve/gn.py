"""Frame-pose Gauss-Newton over point + line residuals (port of pli_slam_tpu.solve.gn).

Same pipeline as the reference: GN rounds interleaved with MAD outlier
reclassification, Cauchy weights, fixed iteration budgets, a 6x6 solve
per iteration. The reference's `fori_loop`s are Python loops here. The
6x6 system is solved with `torch.linalg.solve_ex`, which reports
singularity in `info` instead of checking it on the host, so a solve
never syncs the device; a singular or non-finite step is rejected on
the device exactly as the reference rejects a non-finite one.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu.utils.config import OptimizerConfig
from pli_slam_tpu_torch.ops import lie, robust
from pli_slam_tpu_torch.solve import residuals as res


@dataclasses.dataclass(frozen=True)
class PoseObservations:
    x_w: torch.Tensor  # [P,3]
    uvr: torch.Tensor  # [P,3]
    stereo_mask: torch.Tensor  # [P] bool
    point_mask: torch.Tensor  # [P] bool
    sigma2_pt: torch.Tensor  # [P]
    xs_w: torch.Tensor  # [L,3]
    xe_w: torch.Tensor  # [L,3]
    l_obs: torch.Tensor  # [L,3]
    line_mask: torch.Tensor  # [L] bool
    sigma2_ln: torch.Tensor  # [L]


@dataclasses.dataclass(frozen=True)
class PoseResult:
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inlier_pt: torch.Tensor
    inlier_ln: torch.Tensor
    n_inliers: torch.Tensor
    cost: torch.Tensor


def _accumulate(cam, R, t, obs: PoseObservations, pt_mask, ln_mask, cauchy_c2: float):
    r_pt, J_pt, x_c = res.point_residuals_stereo(cam, R, t, obs.x_w, obs.uvr)
    ones = torch.ones_like(obs.stereo_mask)
    row_mask = torch.stack([ones, ones, obs.stereo_mask], dim=-1).to(r_pt.dtype)
    r_pt = r_pt * row_mask
    J_pt = J_pt * row_mask[..., None]
    behind = x_c[..., 2] <= 0.05
    m_pt = pt_mask & obs.point_mask & ~behind
    chi2_pt = torch.sum(r_pt * r_pt, dim=-1) / obs.sigma2_pt
    w_pt = robust.cauchy_weight(chi2_pt, cauchy_c2) / obs.sigma2_pt
    w_pt = torch.where(m_pt, w_pt, torch.zeros_like(w_pt))

    r_ln, J_ln, aux = res.line_residuals(cam, R, t, obs.xs_w, obs.xe_w, obs.l_obs)
    xs_c, xe_c = aux[0], aux[1]
    behind_ln = (xs_c[..., 2] <= 0.05) | (xe_c[..., 2] <= 0.05)
    m_ln = ln_mask & obs.line_mask & ~behind_ln
    chi2_ln = torch.sum(r_ln * r_ln, dim=-1) / obs.sigma2_ln
    w_ln = robust.cauchy_weight(chi2_ln, cauchy_c2) / obs.sigma2_ln
    w_ln = torch.where(m_ln, w_ln, torch.zeros_like(w_ln))

    H = (torch.einsum("nij,n,nik->jk", J_pt, w_pt, J_pt)
         + torch.einsum("nij,n,nik->jk", J_ln, w_ln, J_ln))
    g = (torch.einsum("nij,n,ni->j", J_pt, w_pt, r_pt)
         + torch.einsum("nij,n,ni->j", J_ln, w_ln, r_ln))
    cost = torch.sum(w_pt * chi2_pt * obs.sigma2_pt) + torch.sum(w_ln * chi2_ln * obs.sigma2_ln)
    return H, g, cost, chi2_pt, chi2_ln, m_pt, m_ln


def _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, iters: int, cauchy_c2: float, damping: float):
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    for _ in range(iters):
        H, g, *_ = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
        delta, info = torch.linalg.solve_ex(H + damping * eye6, g)
        delta = -delta
        bad = (info != 0) | ~torch.all(torch.isfinite(delta)) | (torch.linalg.norm(delta) > 1.0)
        delta = torch.where(bad, torch.zeros_like(delta), delta)
        dR, dt = lie.se3_exp(delta)
        R, t = lie.normalize_rotation(lie._mm(dR, R)), lie._einsum("ij,j->i", dR, t) + dt
    return R, t


def solve_pose(cam, obs: PoseObservations, R0, t0, cfg: OptimizerConfig, cauchy_c2: float = 5.991) -> PoseResult:
    """GN -> MAD outlier rejection -> GN -> ... -> refinement (Optimizer.cc:1146-1163)."""
    R, t = R0, t0
    pt_mask = torch.ones(obs.point_mask.shape, dtype=torch.bool, device=R.device)
    ln_mask = torch.ones(obs.line_mask.shape, dtype=torch.bool, device=R.device)
    for _ in range(cfg.pose_rounds - 1):
        R, t = _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, cfg.pose_gn_iters, cauchy_c2, cfg.damping_init)
        _, _, _, chi2_pt, chi2_ln, m_pt, m_ln = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
        r_pt = torch.sqrt(torch.clamp(chi2_pt, min=0.0))
        r_ln = torch.sqrt(torch.clamp(chi2_ln, min=0.0))
        pt_mask = robust.mad_inlier_mask(r_pt, m_pt, cfg.mad_k) | (m_pt & (chi2_pt < cauchy_c2))
        ln_mask = robust.mad_inlier_mask(r_ln, m_ln, cfg.mad_k) | (m_ln & (chi2_ln < cauchy_c2))
    R, t = _gn_iterations(cam, R, t, obs, pt_mask, ln_mask, cfg.pose_gn_iters_refine, cauchy_c2, cfg.damping_init)
    _, _, cost, chi2_pt, chi2_ln, m_pt, m_ln = _accumulate(cam, R, t, obs, pt_mask, ln_mask, cauchy_c2)
    inlier_pt = m_pt & (chi2_pt < cauchy_c2)
    inlier_ln = m_ln & (chi2_ln < 7.815)
    n = torch.sum(inlier_pt.to(torch.int32)) + torch.sum(inlier_ln.to(torch.int32))
    return PoseResult(R_cw=R, t_cw=t, inlier_pt=inlier_pt, inlier_ln=inlier_ln, n_inliers=n, cost=cost)
