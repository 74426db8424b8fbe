"""Fused gated Hamming matcher: CUDA kernel for Hopper + its plain PyTorch twin.

Port of the TPU kernel `pli_slam_tpu/ops/pallas/hamming.py`
(`gated_match_pallas`, body `_kernel`). The CUDA source is
`pli_slam_tpu_torch/csrc/gated_match.cu`; its header comment says what
bounds it on the H100 and how the design answers that.

`gated_match` dispatches on the device of its inputs and nothing else:
CUDA tensors launch the kernel (built on first use with nvcc for
sm_90a into `build/kernels/` at the repository root, bound through a
plain C entry with ctypes), CPU tensors run `gated_match_reference`, and
anything else raises. There is no fallback from one to the other.

Semantics (both paths, bit for bit with the Pallas kernel):
- gate: du*du + dv*dv <= r2 in float32, each product and the sum rounded
  separately (the direct form of hamming.py:60-62, not the expansion of
  matching.window_gate), and both validity flags;
- distance (256 - <f, s>) / 2, exact;
- ties go to the lowest store row; `second` is the minimum over every
  other row, so an exact duplicate of the winner gives second == best;
- no passing row: idx = -1, best = 1e9.
The ok / ratio epilogue is shared torch code (hamming.py:141-143).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

BIG = 1e9
N_BITS = 256

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "gated_match.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

launches = 0  # kernel launches made through `gated_match` in this process
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the gated-match kernel is built from source on first use")


def build() -> float:
    """Compile (if needed) and load the kernel library. Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    src = _SRC.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libgated_match_{digest}.so"
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gated_match_launch.argtypes = [vp] * 7 + [ci, ci] + [vp] * 7
    lib.gated_match_launch.restype = ci
    lib.gated_match_chunk_rows.argtypes = []
    lib.gated_match_chunk_rows.restype = ci
    _lib = lib
    return time.perf_counter() - t0


def _r2(radius, device) -> torch.Tensor:
    """Squared radius as a float32 [1] tensor on `device`. A device tensor
    stays on the device; a Python number is written by a fill kernel, so
    neither form makes the host wait."""
    if isinstance(radius, torch.Tensor):
        r = radius.to(device=device, dtype=torch.float32).reshape(1)
    else:
        r = torch.full((1,), float(radius), dtype=torch.float32, device=device)
    return r * r


def _check(fdesc, fuv, fvalid, sdesc, suv, svalid):
    n, bits = fdesc.shape
    p = sdesc.shape[0]
    if bits != N_BITS or sdesc.shape[1] != N_BITS:
        raise ValueError(f"descriptors must be [*, {N_BITS}], got {tuple(fdesc.shape)} and {tuple(sdesc.shape)}")
    if fdesc.dtype != torch.int8 or sdesc.dtype != torch.int8:
        raise TypeError("descriptors must be int8")
    if tuple(fuv.shape) != (n, 2) or tuple(suv.shape) != (p, 2):
        raise ValueError("uv must be [N, 2] and [P, 2]")
    if fuv.dtype != torch.float32 or suv.dtype != torch.float32:
        raise TypeError("uv must be float32")
    if tuple(fvalid.shape) != (n,) or tuple(svalid.shape) != (p,):
        raise ValueError("validity masks must be [N] and [P]")
    if fvalid.dtype != torch.bool or svalid.dtype != torch.bool:
        raise TypeError("validity masks must be bool")
    devs = {t.device for t in (fdesc, fuv, fvalid, sdesc, suv, svalid)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return n, p, devs.pop()


def gated_match_reference(fdesc, fuv, fvalid, sdesc, suv, svalid, radius):
    """Plain PyTorch version: returns (idx [N] int32, best [N], second [N])."""
    dev = fdesc.device
    dot = torch.matmul(fdesc.float(), sdesc.float().T)  # exact: integers <= 256
    dist = (N_BITS - dot) * 0.5
    du = fuv[:, 0:1] - suv[:, 0][None, :]
    dv = fuv[:, 1:2] - suv[:, 1][None, :]
    gate = ((du * du + dv * dv) <= _r2(radius, dev)) & svalid[None, :] & fvalid[:, None]
    big = torch.full((), BIG, dtype=torch.float32, device=dev)
    # a BIG column keeps an empty store well-defined: it never wins (strict <)
    dist = torch.cat([torch.where(gate, dist, big), big.expand(dist.shape[0], 1)], dim=1)
    best, arg = torch.min(dist, dim=1)  # documented to return the first minimum
    cols = torch.arange(dist.shape[1], device=dev)
    second = torch.where(cols[None, :] == arg[:, None], big, dist).amin(dim=1)
    idx = torch.where(best < BIG, arg, torch.full_like(arg, -1)).to(torch.int32)
    return idx, best, second


def gated_match_cuda(fdesc, fuv, fvalid, sdesc, suv, svalid, radius):
    """Launch the CUDA kernel: returns (idx [N] int32, best [N], second [N])."""
    global launches
    build()
    dev = fdesc.device
    n, p = fdesc.shape[0], sdesc.shape[0]

    def dense(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    fdesc, sdesc, fuv, suv = dense(fdesc), dense(sdesc), dense(fuv), dense(suv)
    fvalid, svalid = fvalid.contiguous(), svalid.contiguous()
    r2 = _r2(radius, dev)
    n_chunks = -(-p // _lib.gated_match_chunk_rows())
    pbest = torch.empty((max(n_chunks, 1), n), dtype=torch.float32, device=dev)
    psecond = torch.empty_like(pbest)
    pidx = torch.empty((max(n_chunks, 1), n), dtype=torch.int32, device=dev)
    best = torch.empty(n, dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.gated_match_launch(
        fdesc.data_ptr(), fuv.data_ptr(), fvalid.data_ptr(), sdesc.data_ptr(), suv.data_ptr(),
        svalid.data_ptr(), r2.data_ptr(), n, p, pbest.data_ptr(), psecond.data_ptr(),
        pidx.data_ptr(), best.data_ptr(), second.data_ptr(), idx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gated_match kernel launch failed: cudaError {err}")
    launches += 1
    return idx, best, second


def gated_match(fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist: float = 100.0, ratio: float = 1.0):
    """Fused gated match: returns (idx [N] int32, best [N] float32, ok [N] bool).

    `radius` is a float or a 0-d float32 tensor on the inputs' device."""
    _, _, dev = _check(fdesc, fuv, fvalid, sdesc, suv, svalid)
    if dev.type == "cuda":
        idx, best, second = gated_match_cuda(fdesc, fuv, fvalid, sdesc, suv, svalid, radius)
    elif dev.type == "cpu":
        idx, best, second = gated_match_reference(fdesc, fuv, fvalid, sdesc, suv, svalid, radius)
    else:
        raise RuntimeError(f"gated_match has no path for device {dev}")
    ok = fvalid & (best <= max_dist) & (idx >= 0)
    if ratio < 1.0:
        ok = ok & (best < ratio * second)
    return idx, best, ok
