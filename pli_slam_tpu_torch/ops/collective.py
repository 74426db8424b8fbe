"""The one cross-rank operation of the distributed solvers.

The reference shards with `shard_map` and sums across shards with
`jax.lax.psum`; here each shard is a rank of a `torch.distributed` process
group and `psum` is one `all_reduce`. With no group it is the identity, so
a solver called without one is the one-process solver, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of `x` over the ranks of `group` (a new tensor, the same on every
    rank); `x` itself when `group` is None."""
    if group is None:
        return x
    y = x.reshape(-1).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.reshape(x.shape)
