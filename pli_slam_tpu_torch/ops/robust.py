"""Robust weights and masked robust statistics (port of pli_slam_tpu.ops.robust).

Padding-safe like the reference: a boolean `mask` excludes padded
entries from every statistic, and shapes never depend on the data.
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops.indexing import row


def cauchy_weight(r2: torch.Tensor, c2=1.0) -> torch.Tensor:
    return 1.0 / (1.0 + r2 / c2)


def huber_weight(r2: torch.Tensor, delta=1.0) -> torch.Tensor:
    r = torch.sqrt(torch.clamp(r2, min=1e-24))
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def tukey_weight(r2: torch.Tensor, c=4.685) -> torch.Tensor:
    u2 = r2 / (c * c)
    return torch.where(u2 < 1.0, (1.0 - u2) ** 2, torch.zeros_like(u2))


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over mask==True entries of a 1-D tensor (sort with +inf padding)."""
    n = torch.sum(mask.to(torch.int64))
    xs, _ = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    last = x.shape[0] - 1
    med = 0.5 * (row(xs, torch.clamp(lo, max=last)) + row(xs, torch.clamp(hi, max=last)))
    return torch.where(n > 0, med, torch.zeros_like(med))


def mad_sigma(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    med = masked_median(r, mask)
    return 1.4826 * masked_median(torch.abs(r - med), mask)


def mad_inlier_mask(r: torch.Tensor, mask: torch.Tensor, k: float = 4.0, min_sigma: float = 1e-4) -> torch.Tensor:
    med = masked_median(r, mask)
    sigma = torch.clamp(mad_sigma(r, mask), min=min_sigma)
    return mask & (torch.abs(r - med) <= k * sigma)
