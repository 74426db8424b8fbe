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
the body on a stream of its own.

Streams (`Streams`, made by `ready`): the port captures on three streams of
its own per device, created by `csrc/cond_node.cu` and wrapped as
`torch.cuda.ExternalStream`s for the process's lifetime: every capture of
the port warms up on `warm` and captures on `capture`, and IF bodies are
captured on `body`. None is one of PyTorch's pooled streams:
`torch.cuda.Stream()` hands those out round-robin (32 a priority), so with
a pooled body stream and a fresh pooled stream for each capture, the third
loop-closing tracker of a process captured its fused step on the body
stream itself (CUDA refuses the body's capture: cudaErrorIllegalState), and
every new stream's first cuBLAS call left a 32 MiB workspace that PyTorch
keeps for the process (~1 GiB over the first few trackers, some of it
pinning their graphs' pools). The three streams' workspaces are made once,
by `_prime`. `check_parent` refuses a parent capture on the body stream by
handle before CUDA sees it. The body's allocations go to a memory pool of
the graph's bodies (`BodyPool`), routed there by PyTorch's allocator
(`_cuda_beginAllocateCurrentThreadToPool`: the thread's allocations while a
body is captured): the allocator records one capture into a pool at a time,
and the graph's own pool is being recorded into by the graph's capture
(PyTorch 2.11 refuses a second recorder: "already recording to
mempool_id"). The pool is given back when the graph that replays the
bodies is collected. A capture that fails raises; nothing falls back to a
host decision.

`launches` counts the handle-setting kernel as the other kernels' modules
count theirs (once at capture, once per replay through
ops.kernels.hamming.ReplayCounter). `select_reference` is the plain version
of what the node decides: the body's result when `pred` holds, else what
the buffers held.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
import weakref
from pathlib import Path

import torch

from pli_slam_tpu_torch.ops.kernels import hamming

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "cond_node.cu"

launches = 0  # handle-setting kernels captured through `if_node` (and replayed) in this process
_lib = None
_streams: dict = {}  # device index -> Streams, the port's streams there (`ready`)


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
    lib.cond_stream_create.argtypes = [ctypes.POINTER(vp)]
    lib.cond_stream_create.restype = ctypes.c_int
    lib.cond_body_census.argtypes = [vp]
    lib.cond_body_census.restype = None
    _lib = lib
    return time.perf_counter() - t0


@dataclasses.dataclass(frozen=True)
class Streams:
    """The port's streams on one device (see the module docstring)."""

    capture: torch.cuda.ExternalStream  # every capture of the port (frontend.graphs.capture_graph)
    warm: torch.cuda.ExternalStream  # its eager warm-up before the capture
    body: torch.cuda.ExternalStream  # IF bodies


def _index(device) -> int:
    dev = torch.device(device)
    return torch.cuda.current_device() if dev.index is None else dev.index


def ready(device) -> None:
    """Before the process's first CUDA graph capture on `device` (the port's
    captures call it): build the library, load its kernel (inside a capture
    a module's first load is refused), make the port's streams there
    (`Streams`), and capture, once, a throwaway graph whose IF body solves
    a dense system (`_prime`)."""
    build()
    index = _index(device)
    if index not in _streams:
        with torch.cuda.device(index):
            _check(_lib.cond_init(), "loading the kernel")
            roles = Streams(*(_new_stream(index) for _ in range(3)))
            _prime(torch.device("cuda", index), roles)
            _streams[index] = roles


def _new_stream(index: int) -> torch.cuda.ExternalStream:
    """A non-blocking stream of the port's own on device `index`, for the
    process's lifetime: no `torch.cuda.Stream()` can hand it out."""
    handle = ctypes.c_void_p()
    _check(_lib.cond_stream_create(ctypes.byref(handle)), "creating a stream")
    return torch.cuda.ExternalStream(handle.value, device=torch.device("cuda", index))


def streams(device) -> Streams:
    """The port's streams on `device` (after `ready`)."""
    return _streams[_index(device)]


def check_parent(parent: int, body: int) -> None:
    """Refuse an IF node whose parent capture runs on the body stream (CUDA
    would fail the body's capture with cudaErrorIllegalState)."""
    if parent == body:
        raise RuntimeError(f"conditional node: the parent capture's stream {parent:#x} is the IF bodies' stream "
                           f"{body:#x}")


def _prime(dev, roles: Streams) -> None:
    """The first dense solve captured in a process decided how cuSOLVER
    treated captures from then on while the bodies' stream was a pooled
    one: when it lay on a plain capture's stream, every later solve inside
    an IF body came as graph memory-allocation nodes, which CUDA refuses in
    a body ("invalid argument" at instantiation); when it lay inside an IF
    body, none did. So the first one is this graph's, thrown away (with the
    port's own streams the probe's unprimed case captures right; no tracker
    has run without the priming). The
    systems (48 unknowns, a vector right-hand side: cuSOLVER's LU and
    cuBLAS's triangular solves, in float32 and in float64) are windowed
    BA's. Their first eager solve runs on the caller's stream: on a stream
    of the port's it made this graph's body refused too. A matrix product
    on each of the port's streams makes the cuBLAS workspace PyTorch keeps
    per stream: eagerly on `warm` (which also makes cuBLAS's handle,
    refused inside a capture), inside this graph on `capture` (which never
    runs eager work) and in its body on `body`; no tracker's capture makes
    one after."""
    systems = [(torch.eye(48, device=dev, dtype=dt) * 2.0, torch.ones(48, device=dev, dtype=dt))
               for dt in (torch.float32, torch.float64)]
    here = torch.cuda.current_stream(dev)
    for a, b in systems:  # cuSOLVER's handle, on the caller's stream
        torch.linalg.solve_ex(a, b)
    roles.warm.wait_stream(here)
    with torch.cuda.stream(roles.warm):
        torch.mm(systems[0][0], systems[0][0])
    roles.capture.wait_stream(roles.warm)
    graph = torch.cuda.CUDAGraph()
    pool = BodyPool(dev, graph)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    with torch.cuda.stream(roles.capture), torch.cuda.graph(graph, stream=roles.capture,
                                                            capture_error_mode="thread_local"):
        torch.mm(systems[0][0], systems[0][0])
        with if_node(flag, pool, roles.body):
            for a, b in systems:
                torch.linalg.solve_ex(a, b)
            torch.mm(systems[0][0], systems[0][0])
    here.wait_stream(roles.capture)


class BodyPool:
    """The memory pool of one graph's IF bodies. Each body captured takes a
    reference on it; they are given back when the graph that replays the
    bodies is collected (`tie`; `graph`, when it exists already), so the
    bodies' memory lives exactly as long as that graph, whoever else held
    it."""

    def __init__(self, device, graph=None):
        self.index = _index(device)
        self.id = torch.cuda.graph_pool_handle()
        self.refs = 0
        if graph is not None:
            self.tie(graph)

    def tie(self, graph) -> None:
        """Give the references back when `graph` is collected; with None (a
        capture that failed: no graph replays the bodies), now."""
        if graph is None:
            self.release()
        else:
            weakref.finalize(graph, self.release)

    def release(self) -> None:
        for _ in range(self.refs):
            torch._C._cuda_releasePool(self.index, self.id)
        self.refs = 0


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conditional node: {what} failed: cudaError {err}")


@contextlib.contextmanager
def if_node(pred: torch.Tensor, pool: BodyPool, body=None):
    """Capture the block into an IF node's body on the 0-d bool CUDA tensor
    `pred`, its allocations from `pool` (the graph's bodies' pool), on the
    port's body stream (`body`, until `ready` has made it). Must run inside
    a capture, on its stream, after `ready`."""
    global launches
    if pred.device.type != "cuda" or pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError(f"an IF node's predicate is a 0-d bool CUDA tensor, got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an IF node is captured inside a CUDA graph capture")
    dev = pred.device
    if body is None:
        if dev.index not in _streams:
            raise RuntimeError(f"conditional.ready({dev}) must run before the capture")
        body = _streams[dev.index].body
    parent = torch.cuda.current_stream(dev)
    check_parent(parent.cuda_stream, body.cuda_stream)
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
