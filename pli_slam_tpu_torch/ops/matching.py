"""Binary-descriptor matching as dense matrix products with predicate gates
(port of pli_slam_tpu.ops.matching).

Descriptors are ±1 int8 rows, so hamming = (256 - dot) / 2. The dot is
taken as a float32 matrix product: every partial sum is an integer of
magnitude <= 256, so it is exact (TF32 is off). The fused gated matcher
for point tracking is the hand-written kernel in ops.kernels.hamming;
this module is the dense path for lines, stereo and triangulation.
"""

from __future__ import annotations

import math

import torch

from pli_slam_tpu_torch.ops.indexing import top_k

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


def row_band_gate(v1, v2, band) -> torch.Tensor:
    """Epipolar row band for rectified stereo: |v1_i - v2_j| <= band, [N1,N2]."""
    return torch.abs(v1[:, None] - v2[None, :]) <= band


def scale_gate(octave1, octave2, max_diff: int = 1) -> torch.Tensor:
    return torch.abs(octave1[:, None] - octave2[None, :]) <= max_diff


def _mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """`jnp.mod` for a positive float divisor: the exact fmod, moved into
    [0, y) (torch.remainder rounds x - y * floor(x / y) instead)."""
    r = torch.fmod(x, y)
    return torch.where(r < 0, r + y, r)


def rotation_consistency(angle1, angle2, idx2, ok, n_bins: int = 30, top: int = 3) -> torch.Tensor:
    """Rotation-histogram filter (reference ORBmatcher's HISTO_LENGTH voting):
    keep matches whose angle difference falls in one of the `top` most
    popular of `n_bins` bins (ties to the lower bin, as `jax.lax.top_k`)."""
    dtheta = _mod(angle1 - angle2[idx2.long()], 2.0 * math.pi)
    bins = torch.clamp((dtheta * (n_bins / (2.0 * math.pi))).to(torch.int32), 0, n_bins - 1).long()
    counts = torch.zeros(n_bins, dtype=torch.int32, device=ok.device).index_add_(0, bins, ok.to(torch.int32))
    top_bins = top_k(counts, top)[1]
    return ok & torch.any(bins[:, None] == top_bins[None, :], dim=1)


def match_descriptors(d1, d2, valid1, valid2, gate=None, max_dist: float = 50.0, ratio: float = 1.0,
                      mutual: bool = True):
    """Hamming -> nearest neighbour -> mutual check (or, without `mutual`,
    one match per d2 row). Returns (idx2, best, ok)."""
    dist = hamming_matrix(d1, d2)
    idx2, best, ok = match_nn(dist, valid1, valid2, gate, max_dist, ratio)
    if mutual:
        ok = mutual_consistency(idx2, ok, dist, valid1, valid2, gate)
    else:
        ok = dedup_matches(idx2, best, ok, d2.shape[0])
    return idx2, best, ok
