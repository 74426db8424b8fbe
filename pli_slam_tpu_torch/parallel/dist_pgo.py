"""Edge-sharded pose-graph optimization over a `torch.distributed` group
(port of pli_slam_tpu.parallel.dist_pgo).

The edges (per-edge residual and two 7x7 Jacobians, the expensive side) are
split over the ranks; the node states (K <= ~1000 keyframes) are
replicated. Each rank linearizes its edges and sums them into the dense
[K, K, 7, 7] normal equations; H and g are all-reduced, and every rank
solves the same dense [7K, 7K] system and applies the same update (ROADMAP
queue 3 B8: the solve is not shared out). The arithmetic is
`solve.pgo.optimize` with `group` set, so the one-process and distributed
solvers cannot drift apart.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.solve import pgo as pgo_mod
from pli_slam_tpu_torch.solve.pgo import PoseGraph

_EDGE_FIELDS = ("e_i", "e_j", "e_R", "e_t", "e_s", "e_weight", "e_mask")


def partition_edges(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad the edges to a multiple of `n_shards` (identity measurement, scale
    1, weight 0, masked out) and stack contiguous edge blocks along a leading
    shard axis; the node states stay as they are (replicated)."""
    E = graph.e_i.shape[0]
    pad = -E % n_shards
    dev = graph.e_i.device

    def pad_e(a, fill):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=dev)])

    e_R = torch.cat([graph.e_R, torch.eye(3, dtype=graph.e_R.dtype, device=dev).expand(pad, 3, 3)])
    padded = dict(e_i=pad_e(graph.e_i, 0), e_j=pad_e(graph.e_j, 0), e_R=e_R, e_t=pad_e(graph.e_t, 0.0),
                  e_s=pad_e(graph.e_s, 1.0), e_weight=pad_e(graph.e_weight, 0.0), e_mask=pad_e(graph.e_mask, False))
    return dataclasses.replace(graph, **{k: v.reshape((n_shards, -1) + tuple(v.shape[1:]))
                                         for k, v in padded.items()})


def shard_edges(stacked: PoseGraph, rank: int) -> PoseGraph:
    """Rank `rank`'s graph: its edge block, the replicated nodes."""
    return dataclasses.replace(stacked, **{k: getattr(stacked, k)[rank] for k in _EDGE_FIELDS})


def optimize_distributed(graph_local: PoseGraph, group, iters: int = 20, mode: str = "sim3",
                         damping: float = 1e-6) -> PoseGraph:
    """`iters` Gauss-Newton iterations of `solve.pgo.optimize(graph, mode=)`
    with this rank's edges; call it on every rank of `group`. Returns the
    graph with the optimized (replicated) node states."""
    return pgo_mod.optimize(graph_local, iters=iters, damping=damping, mode=mode, group=group)
