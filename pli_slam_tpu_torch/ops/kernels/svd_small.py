"""Singular value decomposition of small square matrices (n <= 12): CUDA
kernel for Hopper + its plain twin.

The port's own kernel (the reference's depth-free PnP, `solve/pnp.py`
`ransac_pnp_dlt`, takes the DLT's null vector and the rotation block's
factors from `jnp.linalg.svd` inside its jitted relocalization program).
`torch.linalg.svd` on a CUDA tensor reads cuSOLVER's error flag on the host,
which a stream being captured into a CUDA graph may not do; the kernel
(`pli_slam_tpu_torch/csrc/svd_small.cu`, one-sided Jacobi in float64, a
warp per matrix with B and V in shared memory, round-robin ordering; its
header says what bounds it) never leaves the device.

`svd` dispatches on the device of its input and nothing else: a CUDA tensor
launches the kernel (built on first use with nvcc for sm_90a into
`build/kernels/`, bound through a plain C entry with ctypes), a CPU tensor
runs `svd_reference` (torch.linalg.svd), and anything else raises. Both
return (U, S, Vh) with S descending; the signs of a singular pair are free.

`smallest_eigvec` serves the two-view initialization's minimal solvers
(`solve/twoview.py`, `jnp.linalg.eigh` of the 9x9 A^T A in the reference):
the eigenvector of the smallest eigenvalue of symmetric positive
semi-definite matrices. On a CUDA tensor it is the kernel's last right
singular vector; its plain version on the CPU is `torch.linalg.eigh`'s
first eigenvector, the reference's formulation.
"""

from __future__ import annotations

import ctypes
import re
import time
from pathlib import Path

import torch

from pli_slam_tpu_torch.ops.kernels import hamming

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "svd_small.cu"
MAX_N = 12

launches = 0  # kernel launches made through `svd` in this process
_lib = None


def reset_launches() -> None:
    global launches
    launches = 0


def build() -> float:
    """Compile (if needed) and load the kernel library. Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    lib = hamming.compile_library(_SRC, hamming.PTXAS_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.svd_small_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp]
    lib.svd_small_launch.restype = ci
    _lib = lib
    return time.perf_counter() - t0


def ptxas_report() -> dict:
    """What ptxas reported for the instances of `svd_small_kernel` (one for
    each n) when the library was built (after `build`): the most registers,
    stack frame, spill stores and loads (bytes) and static shared memory
    (bytes) of any instance, the registers of each n, and the lines of the
    12x12 instance as printed."""
    found = {int(re.search(r"ILi(\d+)E", name).group(1)): f
             for name, f in hamming.ptxas_usage(_lib.nvcc_output, "svd_small_kernel").items()}
    if sorted(found) != list(range(1, MAX_N + 1)):
        raise RuntimeError(f"ptxas reported svd_small_kernel for n = {sorted(found)}, not 1..{MAX_N}")
    worst = {key: max(f[key] for f in found.values())
             for key in ("registers", "stack_frame", "spill_stores", "spill_loads", "smem")}
    return {**worst, "registers_by_n": {n: f["registers"] for n, f in sorted(found.items())},
            "text": found[MAX_N]["text"]}


def schedule(n: int) -> tuple[int, list[list[tuple[int, int]]]]:
    """The kernel's round-robin sweep for n x n matrices, as the step loop of
    `svd_small_kernel` in csrc/svd_small.cu runs it (`layout`, `first_pair`,
    `next_pair`): (lanes a pair, steps). steps[s][k] = (p, q), p < q, is the
    pair that slot k rotates at step s; a sweep is n' - 1 steps of n' / 2
    slots, n' = n rounded up to even, and q == n is an odd n's phantom
    column, whose pair the kernel skips. Lane `sub` of a slot takes the rows
    sub, sub + lanes, ... below n; lanes is the largest power of two with
    n' / 2 x lanes <= 32 (a warp)."""
    pairs = (n + 1) // 2
    lanes = 1
    while pairs * lanes * 2 <= 32:
        lanes *= 2
    m = 2 * pairs - 1
    ac = [(m, 0) if k == 0 else (k, m - k) for k in range(pairs)]  # first_pair
    steps = []
    for s in range(m):
        if s > 0:  # next_pair
            ac = [(a if k == 0 else (a + 1) % m, (c + 1) % m) for k, (a, c) in enumerate(ac)]
        steps.append([(min(a, c), max(a, c)) for a, c in ac])
    return lanes, steps


def svd_reference(A: torch.Tensor):
    """Plain PyTorch version: torch.linalg.svd -> (U, S, Vh)."""
    return tuple(torch.linalg.svd(A))


def svd_cuda(A: torch.Tensor, sweeps: torch.Tensor | None = None):
    """Launch the kernel on `A` [..., n, n] float32 (CUDA), n <= 12. Returns
    (U [..., n, n], S [..., n], Vh [..., n, n]). `sweeps`, an [count] int32
    CUDA tensor, receives each matrix's Jacobi sweep count."""
    global launches
    n = A.shape[-1]
    if A.dtype != torch.float32 or A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"svd_small takes [..., n, n] float32 with n <= {MAX_N}, got {tuple(A.shape)} {A.dtype}")
    if A.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"svd_small launches on the current device ({torch.cuda.current_device()}), input is on {A.device}")
    build()
    src = A.contiguous()
    count = src.numel() // (n * n)
    u, vt = torch.empty_like(src), torch.empty_like(src)
    s = torch.empty(src.shape[:-1], dtype=torch.float32, device=A.device)
    if sweeps is not None and (sweeps.dtype != torch.int32 or sweeps.numel() < count or sweeps.device != A.device):
        raise ValueError("sweeps must be an int32 tensor of at least one entry per matrix on the input's device")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib.svd_small_launch(src.data_ptr(), u.data_ptr(), s.data_ptr(), vt.data_ptr(), count, n,
                                None if sweeps is None else sweeps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"svd_small kernel launch failed: error {err}")
    launches += 1
    return u, s, vt


def svd(A: torch.Tensor):
    """(U, S, Vh) of each square matrix of `A` [..., n, n], n <= 12."""
    if A.device.type == "cuda":
        return svd_cuda(A)
    if A.device.type != "cpu":
        raise RuntimeError(f"svd_small has no path for device {A.device}")
    return svd_reference(A)


def smallest_eigvec_reference(A: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `smallest_eigvec`: torch.linalg.eigh's first eigenvector."""
    return torch.linalg.eigh(A).eigenvectors[..., :, 0]


def smallest_eigvec(A: torch.Tensor) -> torch.Tensor:
    """The eigenvector of the smallest eigenvalue of each symmetric positive
    semi-definite matrix of `A` [..., n, n], n <= 12: [..., n], sign free."""
    if A.device.type == "cuda":
        return svd_cuda(A)[2][..., -1, :]
    if A.device.type != "cpu":
        raise RuntimeError(f"svd_small has no path for device {A.device}")
    return smallest_eigvec_reference(A)
