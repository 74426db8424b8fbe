"""CUDA-graph conditional IF nodes: the fused steps' keyframe branch on the
device (the port's counterpart of the reference's `lax.cond`,
pli_slam_tpu/frontend/tracker.py:1187, :1394).

`if_node(pred)`, inside a `torch.cuda.graph` capture, captures what runs in
its block into the body of an IF node that the device runs at a replay when
the 0-d bool CUDA tensor `pred` holds there. The route, chosen once from
`utils.capture_probe` on the card (PyTorch 2.11 there has no Python route to
`CUDAGraph.begin_capture_to_if_node`): `csrc/cond_node.cu`, built on first use
with nvcc for sm_90a into `build/kernels/` and bound with ctypes, adds the
node and a one-thread kernel that sets its handle from `pred`, and captures
the body on a stream of its own. The body's allocations go to a memory pool
of the graph's bodies (`BodyPool`), routed there by PyTorch's allocator
(`_cuda_beginAllocateCurrentThreadToPool`: the thread's allocations while a
body is captured): the allocator records one capture into a pool at a time,
and the graph's own pool is being recorded into by the graph's capture
(PyTorch 2.11 refuses a second recorder: "already recording to
mempool_id"). A capture that fails raises; nothing falls back to a host
decision.

`launches` counts the handle-setting kernel as the other kernels' modules
count theirs (once at capture, once per replay through
ops.kernels.hamming.ReplayCounter). `select_reference` is the plain version
of what the node decides: the body's result when `pred` holds, else what
the buffers held.
"""

from __future__ import annotations

import contextlib
import ctypes
import time
import weakref
from pathlib import Path

import torch

from pli_slam_tpu_torch.ops.kernels import hamming

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "cond_node.cu"

launches = 0  # handle-setting kernels captured through `if_node` (and replayed) in this process
_lib = None
_body_streams: dict = {}  # device index -> the stream bodies are captured on


def reset_launches() -> None:
    global launches
    launches = 0


def build() -> float:
    """Compile (if needed) and load the library. Returns the seconds spent."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    lib = hamming.compile_library(_SRC)
    vp = ctypes.c_void_p
    lib.cond_if_begin.argtypes = [vp, vp, vp]
    lib.cond_if_begin.restype = ctypes.c_int
    lib.cond_if_end.argtypes = [vp]
    lib.cond_if_end.restype = ctypes.c_int
    lib.cond_init.argtypes = []
    lib.cond_init.restype = ctypes.c_int
    lib.cond_body_census.argtypes = [vp]
    lib.cond_body_census.restype = None
    _lib = lib
    return time.perf_counter() - t0


def ready(device) -> None:
    """Before the process's first CUDA graph capture on `device` (the port's
    captures call it): build the library, load its kernel (inside a capture
    a module's first load is refused), make the stream bodies are captured
    on, and capture, once, a throwaway graph whose IF body solves a dense
    system (`_prime`)."""
    build()
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _body_streams:
        with torch.cuda.device(index):
            _check(_lib.cond_init(), "loading the kernel")
            _body_streams[index] = torch.cuda.Stream(index)
            _prime(torch.device("cuda", index))


def _prime(dev) -> None:
    """The first dense solve captured in a process decides how cuSOLVER
    treats captures from then on: when it lies on a plain capture's stream,
    every later solve inside an IF body comes as graph memory-allocation
    nodes, which CUDA refuses in a body ("invalid argument" at
    instantiation); when it lies inside an IF body, none do, in plain
    captures or bodies. So the first one is this graph's, thrown away. The
    systems (48 unknowns, a vector right-hand side: cuSOLVER's LU and
    cuBLAS's triangular solves, in float32 and in float64) are windowed
    BA's."""
    systems = [(torch.eye(48, device=dev, dtype=dt) * 2.0, torch.ones(48, device=dev, dtype=dt))
               for dt in (torch.float32, torch.float64)]
    for a, b in systems:
        torch.linalg.solve_ex(a, b)  # the handles, on the caller's stream
    here, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
    side.wait_stream(here)
    graph = torch.cuda.CUDAGraph()
    pool = BodyPool(dev, graph)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        with if_node(flag, pool):
            for a, b in systems:
                torch.linalg.solve_ex(a, b)
    here.wait_stream(side)


class BodyPool:
    """The memory pool of one graph's IF bodies. Each body captured takes a
    reference on it; they are given back when `owner` (what holds the
    graph) is collected, so the bodies' memory lives as long as the graph
    that replays them."""

    def __init__(self, device, owner):
        dev = torch.device(device)
        self.index = torch.cuda.current_device() if dev.index is None else dev.index
        self.id = torch.cuda.graph_pool_handle()
        self.refs = 0
        weakref.finalize(owner, BodyPool._release, self)

    @staticmethod
    def _release(pool: "BodyPool") -> None:
        for _ in range(pool.refs):
            torch._C._cuda_releasePool(pool.index, pool.id)
        pool.refs = 0


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conditional node: {what} failed: cudaError {err}")


@contextlib.contextmanager
def if_node(pred: torch.Tensor, pool: BodyPool):
    """Capture the block into an IF node's body on the 0-d bool CUDA tensor
    `pred`, its allocations from `pool` (the graph's bodies' pool). Must
    run inside a capture, on its stream, after `ready`."""
    global launches
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"an IF node's predicate is a 0-d bool CUDA tensor, got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an IF node is captured inside a CUDA graph capture")
    dev = pred.device
    body = _body_streams.get(dev.index)
    if body is None:
        raise RuntimeError(f"conditional.ready({dev}) must run before the capture")
    parent = torch.cuda.current_stream(dev)
    pred = pred.contiguous()
    _check(_lib.cond_if_begin(parent.cuda_stream, pred.data_ptr(), body.cuda_stream), "beginning the body")
    launches += 1
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool.id)
    pool.refs += 1
    try:
        with torch.cuda.stream(body):
            yield
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool.id)
        _check(_lib.cond_if_end(body.cuda_stream), "ending the body")


NODE_TYPES = ("kernel", "memcpy", "memset", "host", "child graph", "empty", "event wait", "event record",
              "semaphore signal", "semaphore wait", "mem alloc", "mem free", "batch mem op", "conditional", "other",
              "memcpy touching host memory")


def last_body_census() -> dict:
    """The nodes of the body captured last, by type (what a conditional body may hold is restricted)."""
    out = (ctypes.c_int * 16)()
    _lib.cond_body_census(out)
    return {name: n for name, n in zip(NODE_TYPES, out) if n}


def select_reference(pred: torch.Tensor, body, outs):
    """Plain version: run `body()` (which writes `outs`) when `pred` holds,
    read on the host."""
    if bool(pred):
        body()
    return outs
