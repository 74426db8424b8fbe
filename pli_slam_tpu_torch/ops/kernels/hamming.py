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
The acceptance flag (hamming.py:141-143) is written by the kernel on the
card and by `accept_reference` on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
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
_block_rows = 0  # frame rows per block, a constant of the source
_tickets: dict = {}  # (device index, stream) -> the kernel's zeroed row-tile counters
_chunks: dict = {}  # (device index, N, P) -> chunks of the store, as the source plans them


def reset_launches() -> None:
    global launches
    launches = 0


class ReplayCounter:
    """Launch accounting for a CUDA graph that holds kernel launches.

    A wrapper counts a launch when it runs, and inside a capture it runs
    once, at capture time, while the graph launches the kernel at every
    replay. Around the capture, `capturing()` takes the launches it made
    back off each module's `launches` and keeps their number; `replay(graph)`
    replays the graph and adds that number again, so a replayed step counts
    what the same step run eagerly counts. `uncounted()` drops the launches
    of a warm-up run. `modules` are the kernel modules (each with an int
    `launches`: this one, ops.kernels.rot3)."""

    def __init__(self, *modules):
        self.modules = modules
        self.per_replay = [0] * len(modules)

    @contextlib.contextmanager
    def uncounted(self):
        before = [m.launches for m in self.modules]
        try:
            yield
        finally:
            for m, b in zip(self.modules, before):
                m.launches = b

    @contextlib.contextmanager
    def capturing(self):
        before = [m.launches for m in self.modules]
        try:
            yield
        finally:
            self.per_replay = [m.launches - b for m, b in zip(self.modules, before)]
            for m, b in zip(self.modules, before):
                m.launches = b

    def add(self) -> None:
        """Count one run of what was captured (a replay, or one of a
        conditional body's runs, known once the frame's stats are read)."""
        for m, n in zip(self.modules, self.per_replay):
            m.launches += n

    def replay(self, graph) -> None:
        graph.replay()
        self.add()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the gated-match kernel is built from source on first use")


def compile_library(src: Path = _SRC, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `src` with nvcc for sm_90a (once per content and flags) and load it.
    The headers of `csrc/` are on the include path (a copy of a source
    elsewhere finds them too) and part of the content. The library's
    `nvcc_output` holds what nvcc printed when it built it (kept beside the
    library, so a cached build reports it too)."""
    headers = b"".join(h.read_bytes() for h in sorted(_SRC.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-I", str(_SRC.parent),
               *flags, "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.nvcc_output = log.read_text() if log.exists() else ""
    return lib


PTXAS_FLAGS = ("-Xptxas", "-v")  # a build then prints each kernel's registers, stack frame and spills


def ptxas_usage(nvcc_output: str, kernel: str) -> dict:
    """What `-Xptxas -v` printed for each instance of the kernel `kernel`
    (mangled entry name -> registers, stack frame, spill stores and loads,
    static shared memory in bytes, and its lines as printed)."""
    lines = nvcc_output.splitlines()
    found = {}
    for i, line in enumerate(lines):
        entry = re.search(rf"Compiling entry function '(\S*{kernel}\S*)'", line)
        if entry:
            end = next(j for j in range(i, len(lines)) if "registers" in lines[j])
            text = "\n".join(x.strip() for x in lines[i:end + 1])
            stack, stores, loads = (int(x) for x in re.search(
                r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", text).groups())
            smem = re.search(r"(\d+) bytes smem", text)
            found[entry.group(1)] = {"registers": int(re.search(r"Used (\d+) registers", text).group(1)),
                                     "stack_frame": stack, "spill_stores": stores, "spill_loads": loads,
                                     "smem": int(smem.group(1)) if smem else 0, "text": text}
    if not found:
        raise RuntimeError(f"ptxas reported no entry function {kernel}")
    return found


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' types: without them ctypes cuts pointers to 32 bits."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gated_match_launch.argtypes = [vp] * 7 + [cf, cf, cf, ci, ci, ci] + [vp] * 5
    lib.gated_match_launch.restype = ci
    lib.gated_match_chunks.argtypes = [ci, ci]
    lib.gated_match_chunks.restype = ci
    lib.gated_match_block_rows.argtypes = []
    lib.gated_match_block_rows.restype = ci
    return lib


def build() -> float:
    """Compile (if needed) and load the kernel library. Returns the seconds spent."""
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    use_library(bind(compile_library()))
    return time.perf_counter() - t0


def use_library(lib: ctypes.CDLL) -> None:
    """Make `lib` (a bound build of the source) the one the wrapper launches."""
    global _lib, _block_rows
    _lib, _block_rows = lib, lib.gated_match_block_rows()
    _tickets.clear()
    _chunks.clear()


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


def accept_reference(fvalid, idx, best, second, max_dist: float = 100.0, ratio: float = 1.0):
    """Plain PyTorch version of the acceptance flag: a valid feature whose best
    row is near enough and, below ratio 1, clearly better than the second."""
    ok = fvalid & (best <= max_dist) & (idx >= 0)
    if ratio < 1.0:
        ok = ok & (best < ratio * second)
    return ok


def merge_partials_reference(pbest, pidx, psecond):
    """Merge partial results over the leading axis: [C, N] -> (idx, best, second) [N].

    Each partial is a `gated_match_reference` result on a subset of the store,
    with `pidx` already in rows of the whole store. The rule is order-free
    (associative and commutative), which is what lets the CUDA kernel fold
    columns, quads, tiles and chunks in whatever order they come: the winner
    is the lexicographic minimum of (best, idx), and second is the minimum of
    the losers' bests and of every partial's second."""
    dev = pbest.device
    big = torch.full((1, pbest.shape[1]), BIG, dtype=torch.float32, device=dev)
    # the merge's identity element first: an empty stack of partials stays well-defined
    pbest, psecond = torch.cat([big, pbest]), torch.cat([big, psecond])
    pidx = torch.cat([torch.full_like(big, -1, dtype=torch.int32), pidx.to(torch.int32)])
    best = pbest.amin(dim=0)
    tied = torch.where(pbest == best[None], pidx, torch.iinfo(torch.int32).max)
    idx, winner = tied.min(dim=0)
    others = torch.where(torch.arange(pbest.shape[0], device=dev)[:, None] == winner[None], big, pbest)
    second = torch.minimum(others.amin(dim=0), psecond.amin(dim=0))
    return torch.where(best < BIG, idx, torch.full_like(idx, -1)), best, second


def gated_match_cuda(fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist: float = 100.0, ratio: float = 1.0):
    """Launch the CUDA kernel: returns (idx [N] int32, best [N], second [N], ok [N] bool).

    One launch and three allocations; a `radius` that is a device tensor is
    read by the kernel, so nothing here makes the host wait."""
    global launches
    build()
    dev = fdesc.device
    if dev.index != torch.cuda.current_device():
        raise RuntimeError(
            f"gated_match launches on the current device ({torch.cuda.current_device()}), inputs are on {dev}")
    n, p = fdesc.shape[0], sdesc.shape[0]

    def dense(t):
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    fdesc, sdesc, fuv, suv = dense(fdesc), dense(sdesc), dense(fuv), dense(suv)
    fvalid, svalid = fvalid.contiguous(), svalid.contiguous()
    r_dev = radius.to(device=dev, dtype=torch.float32).reshape(1) if isinstance(radius, torch.Tensor) else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_tiles = -(-n // _block_rows)
    tickets = _tickets.get((dev.index, stream))
    if tickets is None or tickets.numel() < n_tiles:
        # one counter per tile of frame rows; the kernel leaves them at zero. Inside a capture (the body of a
        # conditional node is captured on a stream of its own) they are the graph's, zeroed at every replay
        tickets = torch.zeros(max(n_tiles, 64), dtype=torch.int32, device=dev)
        if not torch.cuda.is_current_stream_capturing():
            _tickets[(dev.index, stream)] = tickets
    n_chunks = _chunks.get((dev.index, n, p))  # the kernel's split of the store for this shape and card
    if n_chunks is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"gated_match: shape N={n} x P={p} first seen inside a CUDA graph capture; "
                           "launch it once on the capture stream first")
    if n_chunks is None:
        n_chunks = _chunks[(dev.index, n, p)] = _lib.gated_match_chunks(n, p)
    scratch = torch.empty(3 * n_chunks * n, dtype=torch.float32, device=dev)  # partial best, second, idx
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    err = _lib.gated_match_launch(
        fdesc.data_ptr(), fuv.data_ptr(), fvalid.data_ptr(), sdesc.data_ptr(), suv.data_ptr(), svalid.data_ptr(),
        None if r_dev is None else r_dev.data_ptr(), 0.0 if r_dev is not None else float(radius),
        float(max_dist), float(ratio), int(ratio < 1.0), n, p,
        scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gated_match kernel launch failed: error {err} (cudaError, or 100000 + CUresult)")
    launches += 1
    return out[2].view(torch.int32), out[0], out[1], ok


def gated_match(fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist: float = 100.0, ratio: float = 1.0):
    """Fused gated match: returns (idx [N] int32, best [N] float32, ok [N] bool).

    `radius` is a float or a 0-d float32 tensor on the inputs' device."""
    _, _, dev = _check(fdesc, fuv, fvalid, sdesc, suv, svalid)
    if dev.type == "cuda":
        idx, best, _, ok = gated_match_cuda(fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist, ratio)
        return idx, best, ok
    if dev.type != "cpu":
        raise RuntimeError(f"gated_match has no path for device {dev}")
    idx, best, second = gated_match_reference(fdesc, fuv, fvalid, sdesc, suv, svalid, radius)
    return idx, best, accept_reference(fvalid, idx, best, second, max_dist, ratio)
