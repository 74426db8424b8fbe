"""JAX indexing and selection semantics, written out for torch.

The reference leans on XLA behaviours that torch does not share:

- `x.at[idx].set(v)` with repeated indices: on XLA's CPU backend the
  LAST update wins (checked against jax 0.9). torch's `index_put_`
  leaves the winner undefined, and on CUDA it is a race. `scatter_set`
  makes every duplicate write the last writer's row, so the result is
  deterministic on both devices and equal to the reference on the CPU.
- `jax.lax.top_k` puts the lower index first among equal values;
  `torch.topk` promises no order. `top_k` sorts stably instead.
- `jnp.unique(size=, fill_value=)` has no torch form, and `torch.unique`
  on CUDA syncs for its output size. `unique_fixed` sorts, keeps the
  first of each run and compacts into a fixed-size buffer, keeping the
  smallest ids as the reference does.
- `jnp.nanmedian` interpolates at the middle, so an even count averages
  the two middle values; `torch.nanmedian` returns the lower one.
  `nanmedian` follows the reference.
- `x.at[idx].add(v)` on floats: torch's `index_add` on CUDA sums with
  atomics in whatever order the threads arrive, so two runs of one build
  can round differently. `deterministic_index_add` sums there in 64-bit
  fixed point (`fixed_point_index_add`), where integer additions give the
  same bits in any order.

Gathers and scatters here never see an out-of-range index: callers clamp
and mask explicitly (an out-of-range index is a device assert on CUDA).
"""

from __future__ import annotations

import torch


def scatter_set(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Functional `dst.at[idx].set(src)` along dim 0 with last-write-wins
    on duplicate indices. `idx` [N] int in [0, dst.shape[0]); `src` [N, ...]."""
    n = idx.shape[0]
    pos = torch.arange(n, device=idx.device)
    idx = idx.long()
    last = torch.full((dst.shape[0],), -1, dtype=torch.long, device=idx.device)
    last = last.scatter_reduce(0, idx, pos, reduce="amax", include_self=True)
    out = dst.clone()
    out[idx] = src[last[idx]].to(dst.dtype)
    return out


def scatter_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Functional `dst.at[idx].add(src)` along dim 0."""
    return dst.index_add(0, idx.long(), src.to(dst.dtype))


def deterministic_index_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Functional `dst.index_add(0, idx, src)` for a float `dst` that gives
    the same bits in every run: on the CPU `index_add` itself, which adds in
    update order as XLA's CPU scatter does; on CUDA, whose `index_add` adds
    with atomics in arrival order, `fixed_point_index_add`."""
    if dst.device.type != "cuda":
        return dst.index_add(0, idx.long(), src.to(dst.dtype))
    return fixed_point_index_add(dst, idx, src)


def fixed_point_index_add(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """`dst.index_add(0, idx, src)` whose result does not depend on the order
    of the additions, on any device. Each column of `src` [N, ...] is scaled
    by the power of two that brings the sum of its magnitudes just under
    2**62, rounded to int64 and summed with integer adds (exact in any order,
    CUDA atomics included), then scaled back and added to `dst` in float64:
    each destination is its sum correctly rounded, with a quantization error
    below N * 2**-62 of its column's magnitude sum. A destination that
    receives a non-finite row becomes NaN."""
    n = src.shape[0]
    v = src.reshape(n, -1).to(torch.float64)
    finite = torch.isfinite(v)
    v = torch.where(finite, v, torch.zeros((), dtype=v.dtype, device=v.device))
    exp = torch.clamp(61.0 - torch.ceil(torch.log2(torch.clamp(v.abs().sum(0), min=1e-300))), max=1000.0)
    q = torch.round(torch.ldexp(v, exp)).to(torch.int64)
    acc = torch.zeros((dst.shape[0], q.shape[1]), dtype=torch.int64, device=dst.device).index_add_(0, idx.long(), q)
    bad = torch.zeros(acc.shape, dtype=torch.int32, device=dst.device).index_add_(0, idx.long(), (~finite).to(torch.int32))
    out = dst.reshape(dst.shape[0], -1).to(torch.float64) + torch.ldexp(acc.to(torch.float64), -exp)
    out = torch.where(bad > 0, torch.full((), float("nan"), dtype=out.dtype, device=out.device), out)
    return out.to(dst.dtype).reshape(dst.shape)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: largest first, lower index first
    among ties. Returns (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def unique_fixed(ids: torch.Tensor, size: int, fill_value: int) -> torch.Tensor:
    """`jnp.unique(ids, size=size, fill_value=fill_value)` for a 1-D int
    tensor: the `size` smallest distinct values, ascending, padded with
    `fill_value`."""
    s, _ = torch.sort(ids)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    pos = torch.cumsum(first.long(), 0) - 1
    keep = first & (pos < size)
    out = torch.full((size + 1,), fill_value, dtype=ids.dtype, device=ids.device)
    # rows not kept all land in the spare slot `size`, which is dropped
    out = out.scatter(0, torch.where(keep, pos, torch.full_like(pos, size)), s)
    return out[:size]


def nanmedian(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`jnp.nanmedian` of d[mask] [N] -> 0-d: the two middle values of an
    even count averaged; NaN when the mask is empty."""
    n = mask.sum()
    srt, _ = torch.sort(torch.where(mask, d, torch.full_like(d, float("inf"))))
    pos = 0.5 * (n - 1).to(d.dtype)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    last = torch.clamp(n - 1, min=0)
    med = srt[torch.clamp(low.long(), min=0)] * (1.0 - hw) + srt[torch.minimum(torch.clamp(high.long(), min=0), last)] * hw
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))
