"""The largest eigenvector of symmetric 4x4 matrices: CUDA kernel for Hopper
+ its plain twin.

The port's own kernel (the reference's Horn alignment, `solve/sim3.py`
`horn_alignment`, takes it from `jnp.linalg.eigh` inside its jitted
relocalization and loop-verification programs). `torch.linalg.eigh` on a
CUDA tensor reads cuSOLVER's error flag on the host, which a stream being
captured into a CUDA graph may not do; the kernel
(`pli_slam_tpu_torch/csrc/eig4.cu`, round-robin Jacobi in float64, four
lanes a matrix; its header says what bounds it) never leaves the device.

`largest_eigvec` dispatches on the device of its input and nothing else: a
CUDA tensor launches the kernel (built on first use with nvcc for sm_90a into
`build/kernels/`, bound through a plain C entry with ctypes), a CPU tensor
runs `largest_eigvec_reference` (torch.linalg.eigh), and anything else
raises. The eigenvector's sign is free in both.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from pli_slam_tpu_torch.ops.kernels import hamming

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "eig4.cu"

launches = 0  # kernel launches made through `largest_eigvec` in this process
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def load(src: Path = _SRC) -> ctypes.CDLL:
    """`src` (this source, or another version of it with the same C entry)
    compiled with `-Xptxas -v` and bound."""
    lib = hamming.compile_library(src, hamming.PTXAS_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.eig4_launch.argtypes = [vp, vp, vp, ci, vp, vp]
    lib.eig4_launch.restype = ci
    return lib


def build() -> float:
    """Compile (if needed) and load the kernel library. Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    _lib = load()
    return time.perf_counter() - t0


def ptxas_report(lib: ctypes.CDLL | None = None) -> dict:
    """What ptxas reported for `eig4_kernel` when the library (after
    `build`) or `lib` (from `load`) was built: registers, stack frame, spill
    stores and loads and static shared memory (bytes), and its lines as
    printed."""
    (found,) = hamming.ptxas_usage((lib or _lib).nvcc_output, "eig4_kernel").values()
    return found


def schedule() -> list[list[tuple[int, int]]]:
    """The kernel's round-robin sweep, as `diagonalize` in csrc/eig4.cu runs
    it (`pairs`): steps[s] = the two disjoint pairs (p, q), p < q, that step
    s rotates at once; step k = s + 1 rotates (0, k) and its complement."""
    return [[(0, k), (1 if k > 1 else 2, 2 if k == 3 else 3)] for k in (1, 2, 3)]


def largest_eigvec_reference(N: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the last column of eigh's ascending eigenvectors."""
    return torch.linalg.eigh(N)[1][..., :, -1]


def largest_eigvec_cuda(N: torch.Tensor, values: torch.Tensor | None = None,
                        sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on `N` [..., 4, 4] float32 (CUDA, symmetric). Returns
    the unit eigenvectors [..., 4]. `values` ([n] float32) receives each
    matrix's largest eigenvalue, `sweeps` ([n] int32) its Jacobi sweeps."""
    global launches
    if N.dtype != torch.float32 or N.shape[-2:] != (4, 4):
        raise ValueError(f"largest_eigvec takes [..., 4, 4] float32, got {tuple(N.shape)} {N.dtype}")
    if N.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"largest_eigvec launches on the current device ({torch.cuda.current_device()}), input is on {N.device}")
    build()
    src = N.contiguous()
    n = src.numel() // 16
    out = torch.empty(src.shape[:-1], dtype=torch.float32, device=N.device)
    for name, t, dtype in (("values", values, torch.float32), ("sweeps", sweeps, torch.int32)):
        if t is not None and (t.dtype != dtype or t.numel() < n or t.device != N.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of one entry per matrix on the input's device")
    stream = torch.cuda.current_stream(N.device).cuda_stream
    err = _lib.eig4_launch(src.data_ptr(), out.data_ptr(), None if values is None else values.data_ptr(), n,
                           None if sweeps is None else sweeps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"largest_eigvec kernel launch failed: cudaError {err}")
    launches += 1
    return out


def largest_eigvec(N: torch.Tensor) -> torch.Tensor:
    """The unit eigenvector of the largest eigenvalue of each symmetric 4x4
    matrix of `N` [..., 4, 4]: [..., 4]."""
    if N.device.type == "cuda":
        return largest_eigvec_cuda(N)
    if N.device.type != "cpu":
        raise RuntimeError(f"largest_eigvec has no path for device {N.device}")
    return largest_eigvec_reference(N)
