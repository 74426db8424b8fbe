"""Pose-graph optimization in Sim3 / SE3 / 4-DoF, dense and batched (port of
pli_slam_tpu.solve.pgo).

Poses are world->camera Sim3 (R, t, s). Every edge residual
r = log(S_m^-1 S_j S_i^-1) and its two 7x7 Jacobians come from one batched
forward-mode pass over all edges (`ops.autodiff.jacfwd`), the blocks are
summed into a dense [K, K, 7, 7] Hessian by
`ops.indexing.deterministic_index_add` (on the card in fixed point, so that
every run gives the same bits) and the [7K, 7K] system is
solved with `torch.linalg.solve_ex` (no host check; a singular or
non-finite step is dropped on the device, as the reference drops a
non-finite one). The reference's `fori_loop` is a Python loop.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.ops import autodiff, lie
from pli_slam_tpu_torch.ops.indexing import deterministic_index_add, top_k


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Padded pose graph. Edges reference node slots."""

    R: torch.Tensor  # [K,3,3] S_cw rotation
    t: torch.Tensor  # [K,3]
    s: torch.Tensor  # [K] scale
    node_mask: torch.Tensor  # [K] bool
    fixed_mask: torch.Tensor  # [K] bool
    e_i: torch.Tensor  # [E] int source node
    e_j: torch.Tensor  # [E] int target node
    e_R: torch.Tensor  # [E,3,3] measured S_ji = S_j S_i^-1
    e_t: torch.Tensor  # [E,3]
    e_s: torch.Tensor  # [E]
    e_weight: torch.Tensor  # [E]
    e_mask: torch.Tensor  # [E] bool


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """r = log(S_m^-1 o S_j o S_i^-1) in R^7 (rho, phi, sigma); the
    translation part is the first-order form, as in the reference."""
    Rii, tii, sii = lie.sim3_inverse(Ri, ti, si)
    Rji, tji, sji = lie.sim3_compose(Rj, tj, sj, Rii, tii, sii)
    Rmi, tmi, smi = lie.sim3_inverse(Rm, tm, sm)
    Re, te, se = lie.sim3_compose(Rmi, tmi, smi, Rji, tji, sji)
    sigma = torch.log(torch.clamp(se, min=1e-9))
    return torch.cat([te, lie.so3_log(Re), sigma[..., None]], dim=-1)


def _perturbed_left(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


def _perturbed_right(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    """S' = S o exp(xi): the increment acts in world coordinates (4-DoF mode,
    where the free rotation is yaw about the world gravity axis)."""
    dRi, dti, dsi = lie.sim3_exp(xi_i)
    dRj, dtj, dsj = lie.sim3_exp(xi_j)
    Ri2, ti2, si2 = lie.sim3_compose(Ri, ti, si, dRi, dti, dsi)
    Rj2, tj2, sj2 = lie.sim3_compose(Rj, tj, sj, dRj, dtj, dsj)
    return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)


_PINNED = {"sim3": (), "se3": (6,), "4dof": (3, 4, 6)}  # xi = [rho(3), phi(3), sigma]


def optimize(graph: PoseGraph, iters: int = 20, se3: bool = False, damping: float = 1e-6,
             mode: str | None = None) -> PoseGraph:
    """`iters` GN iterations. mode "sim3" (7-DoF), "se3" (scale pinned) or
    "4dof" (translation + yaw about world z); `se3=True` is "se3"."""
    if mode is None:
        mode = "se3" if se3 else "sim3"
    if mode not in _PINNED:
        raise ValueError(f"unknown pgo mode {mode!r}")
    pinned = _PINNED[mode]
    perturbed = _perturbed_right if mode == "4dof" else _perturbed_left
    K = graph.R.shape[0]
    E = graph.e_i.shape[0]
    dof = 7
    dev, dt_ = graph.R.device, graph.R.dtype
    ei, ej = graph.e_i.long(), graph.e_j.long()
    zeros = torch.zeros((E, dof), dtype=dt_, device=dev)
    w = torch.where(graph.e_mask, graph.e_weight.to(dt_), torch.zeros((), dtype=dt_, device=dev))
    free = (graph.node_mask & ~graph.fixed_mask).to(dt_)
    eye = torch.eye(dof, dtype=dt_, device=dev)
    ar = torch.arange(K, device=dev)
    keep = torch.ones(dof, dtype=dt_, device=dev)
    for d in pinned:
        keep[d] = 0.0
    diag_add = (1.0 - free)[:, None, None] * eye + damping * eye
    pin_diag = torch.diag(1.0 - keep)

    R, t, s = graph.R, graph.t, graph.s
    for _ in range(iters):
        args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], graph.e_R, graph.e_t, graph.e_s)
        r, Ji = autodiff.jacfwd(lambda x: perturbed(x, zeros, *args), zeros)
        _, Jj = autodiff.jacfwd(lambda x: perturbed(zeros, x, *args), zeros)
        Hii = torch.einsum("eai,e,eaj->eij", Ji, w, Ji)
        Hjj = torch.einsum("eai,e,eaj->eij", Jj, w, Jj)
        Hij = torch.einsum("eai,e,eaj->eij", Ji, w, Jj)
        H = deterministic_index_add(torch.zeros((K * K, dof, dof), dtype=dt_, device=dev),
                            torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),
                            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
        H = H.reshape(K, K, dof, dof)
        g = deterministic_index_add(torch.zeros((K, dof), dtype=dt_, device=dev), torch.cat([ei, ej]),
                            torch.cat([torch.einsum("eai,e,ea->ei", Ji, w, r), torch.einsum("eai,e,ea->ei", Jj, w, r)]))

        H = H * free[:, None, None, None] * free[None, :, None, None]
        H[ar, ar] = H[ar, ar] + diag_add
        g = g * free[:, None]
        if pinned:
            # a pinned dof gets an identity row and column, so its update is zero
            H = H * keep[None, None, :, None] * keep[None, None, None, :]
            H[ar, ar] = H[ar, ar] + pin_diag
            g = g * keep

        Hd = H.permute(0, 2, 1, 3).reshape(K * dof, K * dof)
        sol, info = torch.linalg.solve_ex(Hd, g.reshape(-1))
        delta = -sol.reshape(K, dof)
        bad = (info != 0) | ~torch.all(torch.isfinite(delta))
        delta = torch.where(bad, torch.zeros((), dtype=dt_, device=dev), delta)

        dR, dt, ds = lie.sim3_exp(delta)
        if mode == "4dof":
            R2, t2, s2 = lie.sim3_compose(R, t, s, dR, dt, ds)
        else:
            R2, t2, s2 = lie.sim3_compose(dR, dt, ds, R, t, s)
        R, t, s = lie.normalize_rotation(R2), t2, s2
    return dataclasses.replace(graph, R=R, t=t, s=s)


def chain_edges(R, t, s, valid):
    """Sequential odometry edges k-1 -> k from the current estimates."""
    K = R.shape[0]
    i = torch.arange(K - 1, dtype=torch.int32, device=R.device)
    j = i + 1
    li, lj = i.long(), j.long()
    Rii, tii, sii = lie.sim3_inverse(R[li], t[li], s[li])
    Rm, tm, sm = lie.sim3_compose(R[lj], t[lj], s[lj], Rii, tii, sii)
    return i, j, Rm, tm, sm, valid[li] & valid[lj]


def covis_edges(R, t, s, valid, covis, n_top: int = 2, min_weight: int = 30):
    """Each keyframe to its `n_top` most covisible non-adjacent keyframes
    with weight >= min_weight; ties go to the lower slot (`jax.lax.top_k`'s
    order, ops.indexing.top_k)."""
    K = R.shape[0]
    ids = torch.arange(K, dtype=torch.int32, device=R.device)
    zero = torch.zeros((), dtype=covis.dtype, device=R.device)
    w = torch.where(valid[:, None] & valid[None, :], covis, zero)
    w = torch.where(torch.abs(ids[:, None] - ids[None, :]) <= 1, zero, w)  # the chain covers these
    top_w, top_j = top_k(w, n_top)
    i = torch.repeat_interleave(ids, n_top)
    j = top_j.reshape(-1).to(torch.int32)
    li, lj = i.long(), j.long()
    mask = (top_w.reshape(-1) >= min_weight) & valid[li] & valid[lj] & (i < j)
    Rii, tii, sii = lie.sim3_inverse(R[li], t[li], s[li])
    Rm, tm, sm = lie.sim3_compose(R[lj], t[lj], s[lj], Rii, tii, sii)
    return i, j, Rm, tm, sm, mask
