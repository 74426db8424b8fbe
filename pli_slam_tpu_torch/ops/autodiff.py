"""Forward-mode Jacobians of the small inertial factors.

The reference takes them with `jax.jacfwd` (and `jax.vmap` over a chain of
factors). `torch.func.jacfwd` would be the one-to-one counterpart, but it
runs the function under `vmap`, and there PyTorch 2.x promotes the tangent
of "0-d tensor (op) Python number" to float64 (`theta2 / 6.0`,
`(trace - 1.0) * 0.5`: the Lie-group code is full of them), after which a
float32 matmul refuses the mix. So the Jacobian is taken with one
`torch.func.jvp` instead, over a batch: the D rows of the primal are all
`x`, the D rows of the tangent are the unit vectors, and the function
evaluates the rows independently because everything under it broadcasts
over leading axes. Nothing dual is 0-d then, no `vmap` is involved, and the
work is the same D-wide batch that `jacfwd` would have made.
"""

from __future__ import annotations

import torch


def jacfwd(f, x: torch.Tensor):
    """(f(x) [*B, R], J [*B, R, D]) for x [*B, D] and an `f` that maps
    [..., *B, D] -> [..., *B, R] independently for every index of the leading
    axes and of B (J[b] = d f(x)[b] / d x[b]: nothing couples the b's)."""
    D = x.shape[-1]
    batch = x.shape[:-1]
    X = x.expand((D,) + tuple(x.shape)).clone()
    E = torch.eye(D, dtype=x.dtype, device=x.device).reshape((D,) + (1,) * len(batch) + (D,)).expand(X.shape).clone()
    out, tangent = torch.func.jvp(f, (X,), (E,))
    return out[0], torch.movedim(tangent, 0, -1)
