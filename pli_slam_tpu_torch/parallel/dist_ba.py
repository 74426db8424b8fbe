"""Landmark-sharded bundle adjustment over a `torch.distributed` group (port
of pli_slam_tpu.parallel.dist_ba).

Landmarks and their observations are split over the ranks; the poses (a
window of W <= ~32) are replicated. Each rank assembles its shard's share
of the reduced camera system S = Hpp - Hpl Hll^-1 Hlp, the shares are
all-reduced, every rank solves the same dense [6W, 6W] system and
back-substitutes its own landmarks. The per-shard arithmetic is
`solve.ba` with `group` set, so the one-process and distributed solvers
cannot drift apart.

Layout (the reference's): `partition_observations` returns the problem
stacked along a leading shard axis; `shard_of(stacked, rank)` is one
rank's problem and `gather_landmarks` puts per-shard landmark rows back in
store order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.solve import ba as ba_mod
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils.config import OptimizerConfig


def partition_observations(prob: ba_mod.BAProblem, n_shards: int, compact: bool = True) -> ba_mod.BAProblem:
    """Split a pose-major problem into `n_shards` landmark shards, stacked
    along a leading axis (every field, the replicated poses included).

    Ownership is interleaved: shard s owns landmark ids s, s+n, s+2n, ...
    (local row j is global id j*n + s), so a pose's observations, which
    cluster in an id range in real maps, spread evenly over the shards.
    Observation rows of another shard's landmarks are masked out, so every
    observation counts once over all shards.

    With `compact` each shard's observation arrays are gathered down to the
    rows it owns, per (shard, pose), padded to one common per-pose count: the
    equal-count pose-major blocks that `assemble_visual`'s [W, S] reshape
    needs. The per-shard work then shrinks ~1/n. The plan is made on the host.
    """
    P_total, L_total = prob.pts.shape[0], prob.lns.shape[0]
    if P_total % n_shards or L_total % n_shards:
        raise ValueError(f"{P_total} points and {L_total} lines do not split into {n_shards} shards")
    dev = prob.pts.device

    def shard_obs(idx):
        neg = torch.full_like(idx, -1)
        return torch.where(idx >= 0, idx % n_shards, neg), torch.where(idx >= 0, idx // n_shards, neg)

    own_p, loc_p = shard_obs(prob.po_pt)
    own_l, loc_l = shard_obs(prob.lo_ln)

    if compact:
        W = prob.R.shape[0]

        def plan(own, pose, mask):
            """Per-(shard, pose) row lists padded to a common count."""
            own_np, pose_np = own.cpu().numpy(), pose.cpu().numpy()
            live = mask.cpu().numpy() & (own_np >= 0)
            rows = [[np.nonzero(live & (own_np == s) & (pose_np == w))[0] for w in range(W)]
                    for s in range(n_shards)]
            cap = max(max((len(r) for sr in rows for r in sr), default=1), 1)
            plans = []
            for s in range(n_shards):
                idx = np.zeros((W, cap), np.int64)
                keep = np.zeros((W, cap), bool)
                for w in range(W):
                    r = rows[s][w]
                    idx[w, :len(r)] = r
                    keep[w, :len(r)] = True
                pose_rows = np.repeat(np.arange(W, dtype=np.int32)[:, None], cap, axis=1)
                plans.append(tuple(torch.from_numpy(a.reshape(-1)).to(dev) for a in (idx, keep, pose_rows)))
            return plans

        plans_p = plan(own_p, prob.po_pose, prob.po_mask)
        plans_l = plan(own_l, prob.lo_pose, prob.lo_mask)

    reps = []
    for s in range(n_shards):
        rep = dataclasses.replace(
            prob,
            pts=prob.pts[s::n_shards], pt_mask=prob.pt_mask[s::n_shards],
            lns=prob.lns[s::n_shards], ln_mask=prob.ln_mask[s::n_shards],
            po_pt=torch.where(own_p == s, loc_p, torch.full_like(loc_p, -1)),
            po_mask=prob.po_mask & (own_p == s),
            lo_ln=torch.where(own_l == s, loc_l, torch.full_like(loc_l, -1)),
            lo_mask=prob.lo_mask & (own_l == s),
        )
        if compact:
            pr, pk, pp = plans_p[s]
            lr, lk, lp = plans_l[s]
            po_pt, lo_ln = rep.po_pt[pr], rep.lo_ln[lr]
            rep = dataclasses.replace(
                rep,
                po_pose=pp, po_pt=torch.where(pk, po_pt, torch.full_like(po_pt, -1)),
                po_uvr=rep.po_uvr[pr], po_stereo=rep.po_stereo[pr],
                po_sigma2=rep.po_sigma2[pr], po_mask=rep.po_mask[pr] & pk,
                lo_pose=lp, lo_ln=torch.where(lk, lo_ln, torch.full_like(lo_ln, -1)),
                lo_l=rep.lo_l[lr], lo_sigma2=rep.lo_sigma2[lr], lo_mask=rep.lo_mask[lr] & lk,
            )
        reps.append(rep)
    return ba_mod.BAProblem(**{f.name: torch.stack([getattr(r, f.name) for r in reps])
                               for f in dataclasses.fields(ba_mod.BAProblem)})


def shard_of(stacked, rank: int):
    """Shard `rank` of a stacked problem: every field's row `rank`."""
    return dataclasses.replace(stacked, **{f.name: getattr(stacked, f.name)[rank]
                                           for f in dataclasses.fields(stacked)})


def gather_landmarks(x: torch.Tensor) -> torch.Tensor:
    """Per-shard landmark rows [n, P/n, ...] back in store order [P, ...]:
    global id j*n + s is shard s's row j."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def solve_ba_distributed(cam, prob_local: ba_mod.BAProblem, cfg: OptimizerConfig, group,
                         iters: int | None = None) -> ba_mod.BAResult:
    """Distributed two-stage Schur BA; call it on every rank of `group` with
    that rank's shard. Poses and cost come back replicated (the same bits on
    every rank), landmarks and chi2 per shard."""
    return ba_mod.solve_ba(cam, prob_local, cfg, iters=iters, group=group)


def solve_gba_distributed(cam, prob_local: ba_mod.BAProblem, cfg: OptimizerConfig, group,
                          iters: int | None = None, wcap: int = 16) -> ba_mod.BAResult:
    """Distributed whole-map BA (the alternating solver): the landmark step is
    local; the pose step all-reduces the per-pose [W,6,6] + [W,6] blocks, the
    only traffic per iteration besides the final cost."""
    return ba_mod.solve_ba_alternating(cam, prob_local, cfg, iters=iters, wcap=wcap, group=group)


def solve_shard(rank: int, group, device, cam, stacked, cfg: OptimizerConfig, iters: int | None = None,
                solver: str = "schur") -> ba_mod.BAResult:
    """One rank's body for `parallel.launch.run_ranks`: shard `rank` of the
    host-side stacked problem (`utils.convert.to_host` of
    `partition_observations`' result) onto `device`, through the Schur
    ("schur") or the whole-map ("gba") solver; the result as numpy."""
    prob = convert.ba_problem(shard_of(stacked, rank), device)
    solve = {"schur": solve_ba_distributed, "gba": solve_gba_distributed}[solver]
    return convert.to_host(solve(cam, prob, cfg, group, iters))
