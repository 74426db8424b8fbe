"""Constant tensors built once per device.

A CUDA graph records kernels, not host work: a `torch.tensor(...)` or
`torch.as_tensor(...)` on a GPU copies from pageable host memory and waits
for the copy, which a stream being captured may not do, and a value built
from a host number inside the captured region would be frozen at capture.
So every constant the fused steps use (tables, intrinsics, fixed priors)
comes from here: built on the first call, outside any capture (the warm-up
run before a capture makes that first call), and cached by key and device.
A cached tensor is shared: callers never write into it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import _disable_current_modes

_cache: dict = {}


def device_const(key, device, make: Callable[[], object]) -> torch.Tensor:
    """The tensor `make()` (an array, list or tensor) on `device`, built on
    the first call for (`key`, device) and cached. Under a tracing mode
    (make_fx) or a function transform (`ops.autodiff.jacfwd`'s jvp, vmap)
    the constant is built as a plain tensor, outside the trace or the
    transform: built inside a jvp it would be cached as the transform's
    wrapper, which has no storage of its own."""
    device = torch.device(device) if device is not None else torch.empty(0).device  # the default device
    k = (key, device.type, device.index)
    t = _cache.get(k)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {key!r} is first needed inside a CUDA graph capture: "
                               "run the captured function once eagerly before capturing it")
        with _disable_current_modes(), torch._C._DisableFuncTorch():
            t = torch.as_tensor(make(), device=device)
        _cache[k] = t
    return t
