"""Binary-descriptor matching as dense matrix products with predicate gates
(port of pli_slam_tpu.ops.matching).

Descriptors are ±1 int8 rows, so hamming = (256 - dot) / 2. The dot is
taken as a float32 matrix product: every partial sum is an integer of
magnitude <= 256, so it is exact (TF32 is off). The fused gated matcher
for point tracking is the hand-written kernel in ops.kernels.hamming;
this module is the dense path for lines, stereo and triangulation.
"""

from __future__ import annotations

import torch

BIG = 1e9


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """d1 [N1,B] int8 ±1, d2 [N2,B] -> [N1,N2] float32."""
    b = d1.shape[-1]
    dot = torch.matmul(d1.float(), d2.float().T)
    return (b - dot) * 0.5


def match_nn(dist, valid1, valid2, gate=None, max_dist: float = 50.0, ratio: float = 1.0):
    """Row-wise nearest neighbour with optional gate and Lowe ratio test.
    Returns (idx2 [N1] int32, best [N1], ok [N1] bool)."""
    big = torch.full((), BIG, dtype=dist.dtype, device=dist.device)
    d = torch.where(valid2[None, :], dist, big)
    if gate is not None:
        d = torch.where(gate, d, big)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    ok = valid1 & (best <= max_dist)
    if ratio < 1.0:
        cols = torch.arange(d.shape[1], device=d.device)
        d2nd = torch.where(cols[None, :] == best_idx[:, None], big, d).amin(dim=1)
        ok = ok & (best < ratio * d2nd)
    return best_idx.to(torch.int32), best, ok


def mutual_consistency(idx12, ok1, dist, valid1, valid2, gate=None):
    """Keep only mutual best matches."""
    big = torch.full((), BIG, dtype=dist.dtype, device=dist.device)
    d = torch.where(valid1[:, None] & valid2[None, :], dist, big)
    if gate is not None:
        d = torch.where(gate, d, big)
    best_for_2 = torch.argmin(d, dim=0)
    rows = torch.arange(dist.shape[0], device=dist.device)
    return ok1 & (best_for_2[idx12.long()] == rows)


def dedup_matches(idx2, best, ok, n2: int):
    """Keep only the smallest-distance row per matched column.

    The reference scatters at `idx2` directly and relies on JAX wrapping
    -1 to the last column; every such row has ok=False, so it scatters
    BIG and cannot change a minimum. Here -1 is clamped to 0 with the
    same effect."""
    big = torch.full((), BIG, dtype=best.dtype, device=best.device)
    d = torch.where(ok, best, big)
    col = torch.clamp(idx2.long(), min=0)
    col_min = torch.full((n2,), BIG, dtype=best.dtype, device=best.device)
    col_min = col_min.scatter_reduce(0, col, d, reduce="amin", include_self=True)
    return ok & (d <= col_min[col])


def window_gate(uv1, uv2, radius) -> torch.Tensor:
    """||uv1_i - uv2_j|| <= radius via the |a|^2+|b|^2-2ab expansion [N1,N2]."""
    cross = torch.matmul(uv1, uv2.T)
    n1 = torch.sum(uv1 * uv1, dim=-1)
    n2 = torch.sum(uv2 * uv2, dim=-1)
    d2 = n1[:, None] + n2[None, :] - 2.0 * cross
    return d2 <= radius * radius


def scale_gate(octave1, octave2, max_diff: int = 1) -> torch.Tensor:
    return torch.abs(octave1[:, None] - octave2[None, :]) <= max_diff
