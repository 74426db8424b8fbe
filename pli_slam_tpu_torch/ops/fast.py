"""FAST-9/16 corner detection as whole-image tensor ops (port of pli_slam_tpu.ops.fast).

The 16-pixel ring is 16 rolled copies; the segment test is a 16-bit
ring-mask contiguity check with shifts/ANDs; non-max suppression is a
3x3 max pool (-inf padding, the same as the reference's 3x3
`reduce_window(..., "SAME")`).
"""

from __future__ import annotations

import torch

RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

_ARC_LEN = 9
_ARC_MASK = (1 << _ARC_LEN) - 1


def _ring_stack(img: torch.Tensor) -> torch.Tensor:
    """[16, ..., H, W]: ring[i][..., y, x] = img[..., y+dy_i, x+dx_i] (wrapping)."""
    return torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) for dx, dy in RING_OFFSETS], dim=0)


def _has_contiguous_arc(ring_bits: torch.Tensor) -> torch.Tensor:
    wrapped = ring_bits | (ring_bits << 16)
    ok = torch.zeros_like(ring_bits, dtype=torch.bool)
    for s in range(16):
        ok = ok | (((wrapped >> s) & _ARC_MASK) == _ARC_MASK)
    return ok


def fast_score(img: torch.Tensor, threshold: float, diff: torch.Tensor | None = None):
    """(score [H,W] float32, is_corner [H,W] bool); 3-pixel border masked."""
    if diff is None:
        diff = _ring_stack(img) - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    weights = (1 << torch.arange(16, dtype=torch.int32, device=img.device)).reshape((16,) + (1,) * (diff.ndim - 1))
    zero_i = torch.zeros((), dtype=torch.int32, device=img.device)
    bits_b = torch.sum(torch.where(brighter, weights, zero_i), dim=0, dtype=torch.int32)
    bits_d = torch.sum(torch.where(darker, weights, zero_i), dim=0, dtype=torch.int32)
    corner = _has_contiguous_arc(bits_b) | _has_contiguous_arc(bits_d)
    zero_f = torch.zeros((), dtype=diff.dtype, device=img.device)
    excess_b = torch.sum(torch.where(brighter, diff - threshold, zero_f), dim=0)
    excess_d = torch.sum(torch.where(darker, -diff - threshold, zero_f), dim=0)
    score = torch.maximum(excess_b, excess_d)
    h, w = img.shape[-2:]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)
    corner = corner & interior
    return torch.where(corner, score, zero_f), corner


def max_pool_same(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """`reduce_window(x, -inf, max, (kh, kw), (1, 1), "SAME")` over the
    last two axes of [..., H, W] for odd windows (symmetric padding)."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + x.shape[-2:])
    m = torch.nn.functional.max_pool2d(x4, (kh, kw), stride=1, padding=(kh // 2, kw // 2))
    return m.reshape(lead + m.shape[-2:])


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    m = max_pool_same(score, 3, 3)
    return (score >= m) & (score > 0.0)


def detect(img: torch.Tensor, threshold: float, min_threshold: float | None = None):
    diff = _ring_stack(img) - img[None]
    score_hi, _ = fast_score(img, threshold, diff)
    if min_threshold is not None and min_threshold < threshold:
        score_lo, _ = fast_score(img, min_threshold, diff)
        score = torch.where(score_hi > 0, score_hi + 1e4, score_lo)
    else:
        score = score_hi
    keep = nms_3x3(score)
    return torch.where(keep, score, torch.zeros_like(score)), keep
