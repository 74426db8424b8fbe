"""Closest rotation of 3x3 matrices: CUDA kernel for Hopper + its plain twin.

The port's own kernel (the reference's `normalize_rotation` is
`jnp.linalg.svd` + det, lowered by XLA inside the jitted frame program).
`torch.linalg.svd` on a CUDA tensor reads cuSOLVER's error flag on the
host, which a stream being captured into a CUDA graph may not do; the
kernel (`pli_slam_tpu_torch/csrc/rot3.cu`, one thread per matrix, in
float64: the Newton-Schulz polar iteration for the near rotations the main
path hands it, one-sided Jacobi for every other matrix; its header says
what bounds it) never leaves the device.

`closest_rotation` dispatches on the device of its input and nothing else:
a CUDA tensor launches the kernel (built on first use with nvcc for sm_90a
into `build/kernels/`, bound through a plain C entry with ctypes), a CPU
tensor runs `closest_rotation_reference` (torch.linalg.svd + det), and
anything else raises.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import torch

from pli_slam_tpu_torch.ops.kernels import hamming

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "rot3.cu"

launches = 0  # kernel launches made through `closest_rotation` in this process
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def load(src: Path = _SRC) -> ctypes.CDLL:
    """`src` (this source, or another version of it with the same C entry)
    compiled with `-Xptxas -v` and bound."""
    lib = hamming.compile_library(src, hamming.PTXAS_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rot3_launch.argtypes = [vp, vp, ci, vp, vp]
    lib.rot3_launch.restype = ci
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
    """What ptxas reported for `rot3_kernel` when the library (after
    `build`) or `lib` (from `load`) was built: registers, stack frame, spill
    stores and loads and static shared memory (bytes), and its lines as
    printed."""
    (found,) = hamming.ptxas_usage((lib or _lib).nvcc_output, "rot3_kernel").values()
    return found


def closest_rotation_reference(R: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: U diag(1, 1, sign det(U V^T)) V^T from the SVD
    (the reference's NormalizeRotation)."""
    u, _, vt = torch.linalg.svd(R, full_matrices=False)
    det = torch.linalg.det(torch.matmul(u, vt))
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * torch.sign(det)[..., None, None]], dim=-1)
    return torch.matmul(u, vt)


def closest_rotation_cuda(R: torch.Tensor, sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on `R` [..., 3, 3] float32 (CUDA). `sweeps`, an [n]
    int32 CUDA tensor, receives each matrix's branch and work: the polar
    iteration's steps (>= 0) for a near rotation (det > 0 and every squared
    singular value within 0.25 of 1), else -1 - the Jacobi branch's sweeps
    (<= -1)."""
    global launches
    if R.dtype != torch.float32 or R.shape[-2:] != (3, 3):
        raise ValueError(f"closest_rotation takes [..., 3, 3] float32, got {tuple(R.shape)} {R.dtype}")
    if R.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"closest_rotation launches on the current device ({torch.cuda.current_device()}), input is on {R.device}")
    build()
    src = R.contiguous()
    out = torch.empty_like(src)
    n = src.numel() // 9
    if sweeps is not None and (sweeps.dtype != torch.int32 or sweeps.numel() < n or sweeps.device != R.device):
        raise ValueError("sweeps must be an int32 tensor of at least one entry per matrix on the input's device")
    stream = torch.cuda.current_stream(R.device).cuda_stream
    err = _lib.rot3_launch(src.data_ptr(), out.data_ptr(), n, None if sweeps is None else sweeps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"closest_rotation kernel launch failed: cudaError {err}")
    launches += 1
    return out


def closest_rotation(R: torch.Tensor) -> torch.Tensor:
    """The closest rotation to each 3x3 matrix of `R` [..., 3, 3]."""
    if R.device.type == "cuda":
        return closest_rotation_cuda(R)
    if R.device.type != "cpu":
        raise RuntimeError(f"closest_rotation has no path for device {R.device}")
    return closest_rotation_reference(R)
