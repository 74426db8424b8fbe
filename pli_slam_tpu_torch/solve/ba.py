"""Windowed bundle adjustment with Schur reduction (port of the local-BA
half of pli_slam_tpu.solve.ba).

Same structure as the reference: observations sorted by landmark once per
solve (`ObsIndex`), per-iteration scatter-free segment reductions, closed
-form batched 3x3 / 6x6 landmark inverses, a dense [6W, 6W] reduced
camera system, Levenberg-Marquardt with delayed rejection. The
reference's `fori_loop`s are Python loops; the reduced system is solved
with `torch.linalg.solve_ex` (no host-side `info` check, so no sync).
Accept/reject decisions stay on the device as selects.
`solve_ba_alternating` is the memory-bounded whole-map solver of global BA.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.utils.config import OptimizerConfig
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie, robust


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Padded BA problem; observations are pose-major (po_pose =
    repeat(arange(W), Op // W)), landmark ids unique within a pose block,
    -1 for empty slots."""

    R: torch.Tensor  # [W,3,3]
    t: torch.Tensor  # [W,3]
    pose_mask: torch.Tensor  # [W] bool
    fixed_mask: torch.Tensor  # [W] bool
    pts: torch.Tensor  # [P,3]
    pt_mask: torch.Tensor  # [P] bool
    lns: torch.Tensor  # [L,6]
    ln_mask: torch.Tensor  # [L] bool
    po_pose: torch.Tensor  # [Op] int
    po_pt: torch.Tensor  # [Op] int
    po_uvr: torch.Tensor  # [Op,3]
    po_stereo: torch.Tensor  # [Op] bool
    po_sigma2: torch.Tensor  # [Op]
    po_mask: torch.Tensor  # [Op] bool
    lo_pose: torch.Tensor  # [Ol] int
    lo_ln: torch.Tensor  # [Ol] int
    lo_l: torch.Tensor  # [Ol,3]
    lo_sigma2: torch.Tensor  # [Ol]
    lo_mask: torch.Tensor  # [Ol] bool


@dataclasses.dataclass(frozen=True)
class BAResult:
    R: torch.Tensor
    t: torch.Tensor
    pts: torch.Tensor
    lns: torch.Tensor
    po_chi2: torch.Tensor
    lo_chi2: torch.Tensor
    cost: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ObsIndex:
    perm: torch.Tensor  # [E] — argsort of landmark ids
    gat: torch.Tensor  # [C, wcap] — rows of the sorted obs per landmark
    gmask: torch.Tensor  # [C, wcap] bool
    pose_of: torch.Tensor  # [C, wcap] — pose index of each slot


def build_obs_index(lm_id, static_ok, pose_id, capacity: int, wcap: int) -> ObsIndex:
    E = lm_id.shape[0]
    dev = lm_id.device
    key = torch.where(static_ok & (lm_id >= 0), lm_id, torch.full_like(lm_id, capacity)).to(torch.int64)
    perm = torch.argsort(key, stable=True)
    sorted_ids = key[perm]
    lm_range = torch.arange(capacity, dtype=torch.int64, device=dev)
    start = torch.searchsorted(sorted_ids, lm_range, right=False)
    end = torch.searchsorted(sorted_ids, lm_range, right=True)
    end = torch.minimum(end, start + wcap)
    gat = start[:, None] + torch.arange(wcap, device=dev)[None, :]
    gmask = gat < end[:, None]
    gat = torch.clamp(gat, max=E - 1)
    pose_sorted = pose_id[perm].long()
    pose_of = torch.where(gmask, pose_sorted[gat], torch.zeros_like(gat))
    return ObsIndex(perm=perm, gat=gat, gmask=gmask, pose_of=pose_of)


def segment_reduce(idx: ObsIndex, vals):
    """Sum per-observation rows [E, F] into per-landmark rows [C, F]."""
    g = vals[idx.perm][idx.gat]  # [C, wcap, F]
    return torch.sum(torch.where(idx.gmask[..., None], g, torch.zeros((), dtype=vals.dtype, device=vals.device)), dim=1)


def segment_reduce_split(idx: ObsIndex, vals, split: int, n_poses: int):
    """(plain per-landmark sums [C, split], per-pose sums [C, n_poses, F - split])."""
    v_sorted = vals[idx.perm]
    g = torch.where(idx.gmask[..., None], v_sorted[idx.gat], torch.zeros((), dtype=vals.dtype, device=vals.device))
    plain = torch.sum(g[..., :split], dim=1)
    onehot = idx.pose_of[..., None] == torch.arange(n_poses, device=vals.device)[None, None, :]
    onehot = (onehot & idx.gmask[..., None]).to(vals.dtype)
    per_pose = torch.einsum("cse,csf->cef", onehot, g[..., split:])
    return plain, per_pose


def _dxc(xc):
    eye = torch.eye(3, dtype=xc.dtype, device=xc.device).expand(xc.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.hat(xc)], dim=-1)


def _point_obs_linearize(cam, prob: BAProblem, R, t, pts):
    pose = prob.po_pose.long()
    pid = torch.clamp(prob.po_pt, min=0).long()
    Ro = R[pose]
    to = t[pose]
    xw = pts[pid]
    xc = torch.einsum("nij,nj->ni", Ro, xw) + to
    r = prob.po_uvr - cam_ops.stereo_project(cam, xc)
    ones = torch.ones_like(prob.po_stereo)
    row = torch.stack([ones, ones, prob.po_stereo], dim=-1).to(r.dtype)
    r = r * row
    J2 = cam_ops.project_jacobian(cam, xc)
    z = xc[..., 2]
    inv_z2 = 1.0 / torch.clamp(z * z, min=1e-12)
    zero = torch.zeros_like(z)
    Jr = J2[..., 0, :] + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    Jproj = torch.cat([J2, Jr[..., None, :]], dim=-2) * row[..., None]
    Jp = -torch.einsum("nij,njk->nik", Jproj, _dxc(xc))
    Jl = -torch.einsum("nij,njk->nik", Jproj, Ro)
    ok = (prob.po_mask & (prob.po_pt >= 0) & (z > 0.05) & prob.pt_mask[pid] & prob.pose_mask[pose])
    return r, Jp, Jl, ok


def _line_obs_linearize(cam, prob: BAProblem, R, t, lns):
    pose = prob.lo_pose.long()
    lid = torch.clamp(prob.lo_ln, min=0).long()
    Ro = R[pose]
    to = t[pose]
    seg = lns[lid]
    l_obs = prob.lo_l

    def endpoint(xw):
        xc = torch.einsum("nij,nj->ni", Ro, xw) + to
        uv = cam_ops.project(cam, xc)
        d = l_obs[:, 0] * uv[:, 0] + l_obs[:, 1] * uv[:, 1] + l_obs[:, 2]
        Jproj = cam_ops.project_jacobian(cam, xc)
        Jd_xc = torch.einsum("ni,nij->nj", l_obs[:, :2], Jproj)
        Jd_pose = torch.einsum("nj,njk->nk", Jd_xc, _dxc(xc))
        Jd_x = torch.einsum("nj,njk->nk", Jd_xc, Ro)
        return d, Jd_pose, Jd_x, xc[:, 2]

    d0, Jp0, Jx0, z0 = endpoint(seg[:, :3])
    d1, Jp1, Jx1, z1 = endpoint(seg[:, 3:])
    r = -torch.stack([d0, d1], dim=-1)
    Jp = -torch.stack([Jp0, Jp1], dim=-2)
    zeros = torch.zeros_like(Jx0)
    Jl = -torch.stack([torch.cat([Jx0, zeros], -1), torch.cat([zeros, Jx1], -1)], dim=-2)
    ok = (prob.lo_mask & (prob.lo_ln >= 0) & (z0 > 0.05) & (z1 > 0.05)
          & prob.ln_mask[lid] & prob.pose_mask[pose])
    return r, Jp, Jl, ok


def _robust_weight(r, sigma2, ok, delta):
    chi2 = torch.sum(r * r, dim=-1) / sigma2
    w = robust.huber_weight(chi2, delta * delta) / sigma2
    return torch.where(ok, w, torch.zeros_like(w)), chi2


def prepare_indices(prob: BAProblem, wcap_pt: int | None = None, wcap_ln: int | None = None):
    W = prob.R.shape[0]
    static_p = prob.po_mask & (prob.po_pt >= 0)
    static_l = prob.lo_mask & (prob.lo_ln >= 0)
    idx_p = build_obs_index(prob.po_pt, static_p, prob.po_pose, prob.pts.shape[0], wcap_pt or W)
    idx_l = build_obs_index(prob.lo_ln, static_l, prob.lo_pose, prob.lns.shape[0], wcap_ln or W)
    return idx_p, idx_l


def _diag_sum(H):
    return torch.diagonal(H, dim1=1, dim2=2).sum(-1)


def assemble_visual(cam, prob: BAProblem, idx_p: ObsIndex, idx_l: ObsIndex, R, t, pts, lns,
                    cfg: OptimizerConfig, damping):
    """Linearize + reduce: (S6 [W,W,6,6], rhs6 [W,6], point blocks,
    line blocks, cost, chi2_p, chi2_l)."""
    W = prob.R.shape[0]
    dev = R.device
    r_p, Jp_p, Jl_p, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
    w_p, chi2_p = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
    r_l, Jp_l, Jl_l, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
    w_l, chi2_l = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)

    Sx = prob.po_pt.shape[0] // W
    Sl = prob.lo_ln.shape[0] // W
    blk_pp = torch.einsum("nia,n,nib->nab", Jp_p, w_p, Jp_p).reshape(W, Sx, 6, 6)
    blk_gp = torch.einsum("nia,n,ni->na", Jp_p, w_p, r_p).reshape(W, Sx, 6)
    blk_pp_l = torch.einsum("nia,n,nib->nab", Jp_l, w_l, Jp_l).reshape(W, Sl, 6, 6)
    blk_gp_l = torch.einsum("nia,n,ni->na", Jp_l, w_l, r_l).reshape(W, Sl, 6)
    Hpp = blk_pp.sum(1) + blk_pp_l.sum(1)
    gp = blk_gp.sum(1) + blk_gp_l.sum(1)

    pt_pack = torch.cat(
        [
            torch.einsum("nia,n,nib->nab", Jl_p, w_p, Jl_p).reshape(-1, 9),
            torch.einsum("nia,n,ni->na", Jl_p, w_p, r_p),
            torch.einsum("nia,n,nib->nab", Jp_p, w_p, Jl_p).reshape(-1, 18),
        ],
        dim=-1,
    )
    red_p, Wb_p = segment_reduce_split(idx_p, pt_pack, split=12, n_poses=W)
    Hll_p = red_p[:, :9].reshape(-1, 3, 3)
    gl_p = red_p[:, 9:]
    Wb_p = Wb_p.reshape(-1, W, 6, 3)

    ln_pack = torch.cat(
        [
            torch.einsum("nia,n,nib->nab", Jl_l, w_l, Jl_l).reshape(-1, 36),
            torch.einsum("nia,n,ni->na", Jl_l, w_l, r_l),
            torch.einsum("nia,n,nib->nab", Jp_l, w_l, Jl_l).reshape(-1, 36),
        ],
        dim=-1,
    )
    red_l, Wb_l = segment_reduce_split(idx_l, ln_pack, split=42, n_poses=W)
    Hll_l = red_l[:, :36].reshape(-1, 6, 6)
    gl_l = red_l[:, 36:]
    Wb_l = Wb_l.reshape(-1, W, 6, 6)

    eye3 = torch.eye(3, dtype=R.dtype, device=dev)
    eye6 = torch.eye(6, dtype=R.dtype, device=dev)
    active_p = prob.pt_mask & (_diag_sum(Hll_p) > 1e-10)
    active_l = prob.ln_mask & (_diag_sum(Hll_l) > 1e-10)
    Hll_p_d = Hll_p + damping * eye3
    # stiffen the along-line null directions of line endpoints (reference ba.py:316-329)
    seg_dir = lns[:, 3:] - lns[:, :3]
    u = seg_dir / torch.clamp(torch.linalg.norm(seg_dir, dim=-1, keepdim=True), min=1e-6)
    D = torch.einsum("la,lb->lab", u, u)
    reg = _diag_sum(Hll_l) / 6.0 + 1.0
    zero3 = torch.zeros_like(D)
    Dblk = torch.cat([torch.cat([D, zero3], -1), torch.cat([zero3, D], -1)], dim=-2)
    Hll_l_d = Hll_l + damping * eye6 + reg[:, None, None] * Dblk
    zero = torch.zeros((), dtype=R.dtype, device=dev)
    Hll_p_inv = torch.where(
        active_p[:, None, None],
        _inv_spd_equilibrated(Hll_p_d + (~active_p)[:, None, None] * eye3, _inv3x3), zero)
    Hll_l_inv = torch.where(
        active_l[:, None, None],
        _inv_spd_equilibrated(Hll_l_d + (~active_l)[:, None, None] * eye6, _inv6x6_spd), zero)

    def schur_terms(Wb, Hinv, gl, d):
        A = Wb.reshape(Wb.shape[0], W * 6, d)
        B = torch.einsum("icd,ide->ice", A, Hinv)
        S_sub = torch.einsum("iac,ibc->ab", B, A)
        r_add = torch.einsum("iac,ic->a", B, gl)
        return S_sub, r_add

    Ssub_p, radd_p = schur_terms(Wb_p, Hll_p_inv, gl_p, 3)
    Ssub_l, radd_l = schur_terms(Wb_l, Hll_l_inv, gl_l, 6)
    ar = torch.arange(W, device=dev)
    S6 = torch.zeros((W, W, 6, 6), dtype=R.dtype, device=dev)
    S6[ar, ar] = Hpp
    S6 = S6 - (Ssub_p + Ssub_l).reshape(W, 6, W, 6).permute(0, 2, 1, 3)
    rhs6 = -gp + (radd_p + radd_l).reshape(W, 6)
    cost = torch.sum(w_p * chi2_p * prob.po_sigma2) + torch.sum(w_l * chi2_l * prob.lo_sigma2)
    return (S6, rhs6, (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l),
            cost, chi2_p, chi2_l)


def _inv3x3(m):
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.ones_like(det), det)
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
            torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _inv_spd_equilibrated(m, invfn):
    d = torch.sqrt(torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1), min=1e-30))
    s = 1.0 / d
    m_eq = m * s[..., :, None] * s[..., None, :]
    return invfn(m_eq) * s[..., :, None] * s[..., None, :]


def _inv6x6_spd(m):
    A = m[..., :3, :3]
    B = m[..., :3, 3:]
    Dm = m[..., 3:, 3:]
    Ai = _inv3x3(A)
    AiB = torch.einsum("...ij,...jk->...ik", Ai, B)
    S = Dm - torch.einsum("...ji,...jk->...ik", B, AiB)
    Si = _inv3x3(S)
    TL = Ai + torch.einsum("...ij,...jk,...lk->...il", AiB, Si, AiB)
    TR = -torch.einsum("...ij,...jk->...ik", AiB, Si)
    BL = TR.transpose(-1, -2)
    return torch.cat([torch.cat([TL, TR], dim=-1), torch.cat([BL, Si], dim=-1)], dim=-2)


def back_substitute(Wb, Hll_inv, gl, delta_p):
    A = Wb.reshape(Wb.shape[0], -1, Wb.shape[-1])
    rhs = -gl - torch.einsum("iac,a->ic", A, delta_p.reshape(-1))
    return torch.einsum("iab,ib->ia", Hll_inv, rhs)


def ba_iteration(cam, prob: BAProblem, idx_p, idx_l, R, t, pts, lns, cfg: OptimizerConfig, damping):
    W = prob.R.shape[0]
    dev = R.device
    eye6 = torch.eye(6, dtype=R.dtype, device=dev)
    ar = torch.arange(W, device=dev)
    (S, rhs, (Hll_p_inv, gl_p, Wb_p, active_p), (Hll_l_inv, gl_l, Wb_l, active_l),
     cost, chi2_p, chi2_l) = assemble_visual(cam, prob, idx_p, idx_l, R, t, pts, lns, cfg, damping)
    S = S.clone()
    S[ar, ar] = S[ar, ar] + damping * eye6

    free = (prob.pose_mask & ~prob.fixed_mask).to(S.dtype)
    S = S * free[:, None, None, None] * free[None, :, None, None]
    S[ar, ar] = S[ar, ar] + (1.0 - free)[:, None, None] * eye6
    rhs = rhs * free[:, None]

    Sd = S.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(Sd), min=1e-12))
    Sd_eq = Sd * dscale[:, None] * dscale[None, :]
    sol, info = torch.linalg.solve_ex(Sd_eq, rhs.reshape(-1) * dscale)
    delta_p = (sol * dscale).reshape(W, 6)
    bad = (info != 0) | ~torch.all(torch.isfinite(delta_p))
    zero = torch.zeros((), dtype=R.dtype, device=dev)
    delta_p = torch.where(bad, zero, delta_p)
    pn = torch.linalg.norm(delta_p, dim=-1, keepdim=True)
    delta_p = delta_p * torch.clamp(cfg.ba_max_pose_step / torch.clamp(pn, min=1e-12), max=1.0)

    delta_pt = back_substitute(Wb_p, Hll_p_inv, gl_p, delta_p)
    delta_ln = back_substitute(Wb_l, Hll_l_inv, gl_l, delta_p)
    delta_pt = torch.where(bad | ~torch.all(torch.isfinite(delta_pt), -1, keepdim=True), zero, delta_pt)
    delta_ln = torch.where(bad | ~torch.all(torch.isfinite(delta_ln), -1, keepdim=True), zero, delta_ln)
    ln_n = torch.linalg.norm(delta_pt, dim=-1, keepdim=True)
    delta_pt = delta_pt * torch.clamp(cfg.ba_max_landmark_step / torch.clamp(ln_n, min=1e-12), max=1.0)
    ll_n = torch.linalg.norm(delta_ln, dim=-1, keepdim=True)
    delta_ln = delta_ln * torch.clamp(cfg.ba_max_landmark_step / torch.clamp(ll_n, min=1e-12), max=1.0)

    dR, dt = lie.se3_exp(delta_p)
    R_new = lie.normalize_rotation(torch.einsum("wij,wjk->wik", dR, R))
    t_new = torch.einsum("wij,wj->wi", dR, t) + dt
    pts_new = pts + torch.where(active_p[:, None], delta_pt, zero)
    lns_new = lns + torch.where(active_l[:, None], delta_ln, zero)
    return R_new, t_new, pts_new, lns_new, cost, chi2_p, chi2_l


def solve_ba(cam, prob: BAProblem, cfg: OptimizerConfig, iters: int | None = None) -> BAResult:
    """Two-stage LM solve: optimize, drop chi2 outliers, optimize again."""
    iters = cfg.local_ba_iters if iters is None else iters
    iters1 = max(iters // 3, 1)
    res1 = _solve_ba_stage(cam, prob, cfg, iters1)
    prob2 = dataclasses.replace(
        prob, R=res1.R, t=res1.t, pts=res1.pts, lns=res1.lns,
        po_mask=prob.po_mask & (res1.po_chi2 < cfg.prune_chi2_pt),
        lo_mask=prob.lo_mask & (res1.lo_chi2 < cfg.prune_chi2_ln),
    )
    return _solve_ba_stage(cam, prob2, cfg, iters - iters1)


def evaluate_cost(cam, prob: BAProblem, R, t, pts, lns, cfg: OptimizerConfig):
    r_p, _, _, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
    w_p, chi2_p = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
    r_l, _, _, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
    w_l, chi2_l = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
    cost = torch.sum(w_p * chi2_p * prob.po_sigma2) + torch.sum(w_l * chi2_l * prob.lo_sigma2)
    return cost, chi2_p, chi2_l


def _pick(worse, a, b):
    """Per-field select: `a` where `worse`, else `b` (device-side, no sync)."""
    return tuple(torch.where(worse, x, y) for x, y in zip(a, b))


def _solve_ba_stage(cam, prob: BAProblem, cfg: OptimizerConfig, iters: int) -> BAResult:
    """LM with delayed rejection (reference ba.py:664-715)."""
    idx_p, idx_l = prepare_indices(prob)
    dev = prob.R.device
    state0 = (prob.R, prob.t, prob.pts, prob.lns)
    cur, prev = state0, state0
    cost_prev = torch.tensor(float("inf"), device=dev)
    lam = torch.tensor(cfg.damping_init, dtype=torch.float32, device=dev)
    for _ in range(iters):
        Rn, tn, ptsn, lnsn, cost, _, _ = ba_iteration(cam, prob, idx_p, idx_l, *cur, cfg, lam)
        worse = cost > cost_prev
        stepped = (Rn, tn, ptsn, lnsn)
        cur, prev = _pick(worse, prev, stepped), _pick(worse, prev, cur)
        improved = cost < cost_prev
        lam = torch.where(worse, lam * 10.0,
                          torch.where(improved, torch.clamp(lam * 0.5, min=cfg.damping_init), lam))
        cost_prev = torch.where(worse, cost_prev, cost)
    cost_cur, chi2_p_c, chi2_l_c = evaluate_cost(cam, prob, *cur, cfg)
    cost_prev2, chi2_p_p, chi2_l_p = evaluate_cost(cam, prob, *prev, cfg)
    worse = cost_cur > cost_prev
    R, t, pts, lns = _pick(worse, prev, cur)
    return BAResult(R=R, t=t, pts=pts, lns=lns,
                    po_chi2=torch.where(worse, chi2_p_p, chi2_p_c),
                    lo_chi2=torch.where(worse, chi2_l_p, chi2_l_c),
                    cost=torch.where(worse, cost_prev2, cost_cur))


def solve_ba_alternating(cam, prob: BAProblem, cfg: OptimizerConfig, iters: int | None = None,
                         wcap: int = 16) -> BAResult:
    """Memory-bounded whole-map BA by exact block-coordinate descent: a
    landmark-only GN step (poses fixed, block-diagonal per landmark), then a
    pose-only GN step (landmarks fixed, block-diagonal per pose). No Hpl
    blocks, so memory is O(P * wcap) instead of the Schur solve's O(P * W)."""
    iters = cfg.gba_iters if iters is None else iters
    W = prob.R.shape[0]
    dev, dt_ = prob.R.device, prob.R.dtype
    idx_p, idx_l = prepare_indices(prob, wcap_pt=wcap, wcap_ln=wcap)
    damping = 1e-3
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    zero = torch.zeros((), dtype=dt_, device=dev)
    free = (prob.pose_mask & ~prob.fixed_mask).to(dt_)
    Sx = prob.po_pt.shape[0] // W
    Sl = prob.lo_ln.shape[0] // W

    def clip_step(d, max_step):
        nrm = torch.linalg.norm(d, dim=-1, keepdim=True)
        return d * torch.clamp(max_step / torch.clamp(nrm, min=1e-12), max=1.0)

    R, t, pts, lns = prob.R, prob.t, prob.pts, prob.lns
    for _ in range(iters):
        # landmark step (poses fixed)
        r_p, _, Jl_p, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
        w_p, _ = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
        red_p = segment_reduce(idx_p, torch.cat([torch.einsum("nia,n,nib->nab", Jl_p, w_p, Jl_p).reshape(-1, 9),
                                                 torch.einsum("nia,n,ni->na", Jl_p, w_p, r_p)], dim=-1))
        Hll_p, gl_p = red_p[:, :9].reshape(-1, 3, 3), red_p[:, 9:]
        act_p = prob.pt_mask & (_diag_sum(Hll_p) > 1e-10)
        Hinv = _inv_spd_equilibrated(Hll_p + damping * eye3 + (~act_p)[:, None, None] * eye3, _inv3x3)
        d_pt = clip_step(-torch.einsum("iab,ib->ia", Hinv, gl_p), cfg.ba_max_landmark_step)
        pts = pts + torch.where(act_p[:, None] & torch.all(torch.isfinite(d_pt), -1, keepdim=True), d_pt, zero)

        r_l, _, Jl_l, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
        w_l, _ = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
        red_l = segment_reduce(idx_l, torch.cat([torch.einsum("nia,n,nib->nab", Jl_l, w_l, Jl_l).reshape(-1, 36),
                                                 torch.einsum("nia,n,ni->na", Jl_l, w_l, r_l)], dim=-1))
        Hll_l, gl_l = red_l[:, :36].reshape(-1, 6, 6), red_l[:, 36:]
        act_l = prob.ln_mask & (_diag_sum(Hll_l) > 1e-10)
        seg_dir = lns[:, 3:] - lns[:, :3]
        u = seg_dir / torch.clamp(torch.linalg.norm(seg_dir, dim=-1, keepdim=True), min=1e-6)
        Dp = torch.einsum("la,lb->lab", u, u)
        z3 = torch.zeros_like(Dp)
        Dblk = torch.cat([torch.cat([Dp, z3], -1), torch.cat([z3, Dp], -1)], dim=-2)
        regl = _diag_sum(Hll_l) / 6.0 + 1.0
        Hinv_l = _inv_spd_equilibrated(
            Hll_l + damping * eye6 + regl[:, None, None] * Dblk + (~act_l)[:, None, None] * eye6, _inv6x6_spd)
        d_ln = clip_step(-torch.einsum("iab,ib->ia", Hinv_l, gl_l), cfg.ba_max_landmark_step)
        lns = lns + torch.where(act_l[:, None] & torch.all(torch.isfinite(d_ln), -1, keepdim=True), d_ln, zero)

        # pose step (landmarks fixed; block-diagonal, exact)
        r_p, Jp_p, _, ok_p = _point_obs_linearize(cam, prob, R, t, pts)
        w_p, _ = _robust_weight(r_p, prob.po_sigma2, ok_p, cfg.huber_stereo)
        r_l, Jp_l, _, ok_l = _line_obs_linearize(cam, prob, R, t, lns)
        w_l, _ = _robust_weight(r_l, prob.lo_sigma2, ok_l, cfg.huber_mono)
        Hpp = (torch.einsum("nia,n,nib->nab", Jp_p, w_p, Jp_p).reshape(W, Sx, 6, 6).sum(1)
               + torch.einsum("nia,n,nib->nab", Jp_l, w_l, Jp_l).reshape(W, Sl, 6, 6).sum(1))
        gp = (torch.einsum("nia,n,ni->na", Jp_p, w_p, r_p).reshape(W, Sx, 6).sum(1)
              + torch.einsum("nia,n,ni->na", Jp_l, w_l, r_l).reshape(W, Sl, 6).sum(1))
        act_w = _diag_sum(Hpp) > 1e-10
        Hpp_inv = _inv_spd_equilibrated(Hpp + damping * eye6 + (~act_w)[:, None, None] * eye6, _inv6x6_spd)
        dp = clip_step(-torch.einsum("wab,wb->wa", Hpp_inv, gp), cfg.ba_max_pose_step)
        dp = dp * free[:, None] * act_w[:, None]
        dp = torch.where(torch.all(torch.isfinite(dp)), dp, zero)
        dR, dt = lie.se3_exp(dp)
        R = lie.normalize_rotation(torch.einsum("wij,wjk->wik", dR, R))
        t = torch.einsum("wij,wj->wi", dR, t) + dt

    cost, chi2_p, chi2_l = evaluate_cost(cam, prob, R, t, pts, lns, cfg)
    return BAResult(R=R, t=t, pts=pts, lns=lns, po_chi2=chi2_p, lo_chi2=chi2_l, cost=cost)
