"""The per-frame programs as CUDA graphs: the port's counterpart of the
reference's `jax.jit(step)` (pli_slam_tpu/frontend/tracker.py:1225, :1425)
and of its jitted stage programs (`jax.jit(partial(stage, cam, cfg))`,
tracker.py:1518-1579, :1612, :1676-1678).

`FusedStep` runs a fused step (frontend.step.Segments: T builds and tracks
the frame, the keyframe decision, K the keyframe branch) as one program:

- with `graphs=True` (CUDA only) the whole step is captured into one CUDA
  graph when the tracker is constructed (`prepare`): T, the decision on the
  device, and K with and without windowed BA as the bodies of two
  conditional IF nodes (ops.kernels.conditional, `csrc/cond_node.cu`) on
  `need_kf & (n_kf + 1 >= 3)` and `need_kf & (n_kf + 1 < 3)` -- the
  reference's `lax.cond(need_kf, ...)` and, inside it, `lax.cond(n_kf2 >=
  3, ...)`. A frame is one replay. Its one read is the stats vector: copied
  into pinned memory right after the replay, with an event recorded after
  the copy (`FrameStats`), so the host waits for that frame's sixteen
  floats alone, one frame late in the tracker's streaming mode;
- with `graphs=False` (and always on the CPU) the same program runs eagerly
  (`step.run_segments`), the host reading the decision to take the branch.

State. The graph reads and writes static buffers: every tensor of the step's
state (pose, velocity, IMU state, keyframe counters, stores, BoW database,
view ring, local map) is cloned once when the step is captured, and each
part (T, and whichever K variant runs) ends by copying what it changed into
them; K also writes T's output buffers (stats, record), so what follows
the IF nodes reads one set of buffers whichever branch ran. The tracker then
holds those buffers. The keyframe counters on the device lead: they chain
from frame to frame, and a host path that moves them (initialization,
relocalization, loop correction, merge, reset, `load_map`, the host-path
frames of the stereo-inertial sensor) hands the new values to
`set_counters`, written at the next frame. A rare path that replaces the
tracker's other tensors with new ones is followed by a copy of each tensor
whose storage is not its buffer's into the buffer before the next replay.
Per-frame inputs (images, IMU batch, stamp, the mapping and widened-window
flags) are copied into static input buffers.

`StageProgram` runs one stage of the host-orchestrated frames
(preintegration, the frame build, tracking, keyframe insertion, windowed
BA, BoW, culling, the local map: frontend.step's host-path stages): it
captures the stage once per input signature -- the tree structure, shapes
and dtypes of its arguments and the values of their non-tensor leaves,
which is jit's cache -- and replays it on every later call. Values that
change from call to call (keyframe slots and counts, the stamp, flags)
enter as 0-d device tensors, so they are copied in, not captured. Each
call copies its arguments into the signature's static input buffers
(`copy_into`, which skips a source that already is its buffer) and returns
its results as copies: the host path keeps results across frames (the
previous pose, the trajectory record, the per-keyframe accumulator, the
Atlas's parked stores), and the next replay overwrites the graph's own
output buffers. A result that is one of the stage's inputs passed through
unchanged (a store field the stage does not write) is returned as the
caller's own tensor, as the eager stage returns it. With `graphs=False`
(and always on the CPU) the stage runs eagerly.

Capture (`capture_graph`, both classes). The body is run once eagerly on
the port's warm-up stream first, its launches uncounted and its results
dropped (kernel builds, cuBLAS / cuSOLVER handles, the gated-match
kernel's plans, the constants of ops.consts; for a fused step T and both
K variants, since a capture runs neither body), then captured on the
port's capture stream into the caller's memory pool (ops.kernels.
conditional.Streams: the same two streams for every capture of the
process, never the IF bodies' stream; an eager solve on a capture's own
stream before it made the solves of its IF bodies come as graph memory
nodes, which a body may not hold). A capture that fails raises, naming
the fused step or stage (PyTorch's or CUDA's error names the operation);
nothing falls back to eager or to a host decision. A graph's memory (its
pool, its IF bodies' `BodyPool`) is given back when the graph is
collected: a dropped tracker keeps no device memory beyond the free
blocks the caching allocator holds until `torch.cuda.empty_cache()`. The
hand-written kernels' launch counters count per replay (ops.kernels.
hamming.ReplayCounter), and an IF body's when the frame's stats show it
ran, so a graph frame counts what an eager frame counts.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.ops.kernels import conditional, eig4, hamming, rot3, svd_small


KERNEL_MODULES = (hamming, rot3, eig4, svd_small, conditional)  # the hand-written kernels' modules, each with its `launches`


def tree_pairs(dst, src, out: list) -> list:
    """Append the (dst, src) leaf pairs of two trees of the same structure
    (dicts, tuples, lists, dataclasses; tensor and scalar leaves)."""
    if isinstance(dst, torch.Tensor):
        out.append((dst, src))
    elif isinstance(dst, dict):
        for k, v in src.items():
            tree_pairs(dst[k], v, out)
    elif isinstance(dst, (tuple, list)):
        for a, b in zip(dst, src, strict=True):
            tree_pairs(a, b, out)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            tree_pairs(getattr(dst, f.name), getattr(src, f.name), out)
    return out


def tree_leaves(tree) -> list[torch.Tensor]:
    return [a for a, _ in tree_pairs(tree, tree, [])]


def tree_map(fn, tree):
    """The same structure with `fn` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def tree_clone(tree):
    """The same structure with every tensor leaf cloned into memory of its own."""
    return tree_map(torch.Tensor.clone, tree)


def signature(tree):
    """What a capture is keyed on: the structure, every tensor leaf's shape,
    dtype and device, and every other leaf's value (which must hash)."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict", tuple((k, signature(v)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(signature(v) for v in tree))
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple(signature(getattr(tree, f.name)) for f in dataclasses.fields(tree)))
    return ("static", tree)


def copy_into(pairs: list, static_storages: set) -> None:
    """dst <- src for every pair whose source is not already its buffer. A
    source that lies in another static buffer (R_prev <- R) is cloned
    before anything is written, so every source is read as it was."""
    todo = []
    for dst, src in pairs:
        if isinstance(src, torch.Tensor):
            if src is dst or (src.data_ptr() == dst.data_ptr() and src.shape == dst.shape
                              and src.stride() == dst.stride()):
                continue
            if src.untyped_storage().data_ptr() in static_storages:
                src = src.clone()
        todo.append((dst, src))
    for dst, src in todo:
        if isinstance(src, torch.Tensor):
            dst.copy_(src)
        else:
            dst.fill_(src)


@dataclasses.dataclass
class Captured:
    """One captured graph: what `capture_graph` returns."""

    graph: object  # torch.cuda.CUDAGraph, or anything with `replay()`
    counter: hamming.ReplayCounter
    outs: object  # the body's outputs from the capture: the graph rewrites them at every replay
    ms: float  # wall time of the warm-up and the capture
    pool_bytes: int  # device memory the capture reserved

    def replay(self) -> None:
        self.counter.replay(self.graph)


def capture_graph(device, pool, what: str, body) -> Captured:
    """Warm `body` up (`body(False)`: its launches uncounted, its results
    dropped) on the port's warm-up stream, then capture `body(True)` on its
    capture stream into `pool`. A failed capture raises, naming `what`."""
    dev = torch.device(device)
    conditional.ready(dev)  # before the process's first capture (see conditional._prime)
    roles = conditional.streams(dev)
    side, warm = roles.capture, roles.warm
    t0 = time.perf_counter()
    counter = hamming.ReplayCounter(*KERNEL_MODULES)
    warm.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(warm), counter.uncounted():
        body(False)
    side.wait_stream(warm)
    with torch.cuda.stream(side):
        # what torch.cuda.graph releases on entry, released first: the growth is then the private pool's
        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        try:
            with counter.capturing(), torch.cuda.graph(graph, pool=pool, stream=side,
                                                       capture_error_mode="thread_local"):
                outs = body(True)
        except Exception as exc:
            raise RuntimeError(f"capturing {what} failed: {exc}") from exc
    torch.cuda.current_stream(dev).wait_stream(side)
    return Captured(graph, counter, outs, (time.perf_counter() - t0) * 1e3,
                    torch.cuda.memory_reserved(dev) - reserved0)


class FrameStats:
    """A fused frame's stats vector on its way to the host: a non-blocking
    copy into pinned memory, started right after the frame's launch, and an
    event recorded after it. `read()` waits on that event alone (not on the
    stream, so not on a frame launched since), returns the vector as numpy
    and, under graphs, counts the keyframe branch's launches if the frame
    made a keyframe (`FusedStep`). Reading again returns the same array."""

    def __init__(self, host: torch.Tensor, event, settle, slot: int):
        self._host, self._event, self._settle, self._slot = host, event, settle, slot
        self._value = None

    def read(self):
        if self._value is None:
            if self._event is not None and not self._event.query():
                self._event.synchronize()
            self._value = self._host.numpy().copy()
            self._settle(self)
        return self._value


class PinnedUpload:
    """Host arrays to `device` without making the host wait for it: on a GPU
    each call writes its arrays into pinned buffers of its own slot and
    copies them with non-blocking copies, an event recorded after them. A
    copy from pageable memory would wait for everything queued on the stream
    first (the previous frame's program). `slots` calls may be in flight; a
    slot is written again once its event has passed, which the tracker's one
    read a frame (of the previous frame's stats, at the latest) has made
    sure of -- checked with a query, waited on only if not. Each call returns
    new device tensors. On the CPU the arrays are returned as tensors."""

    def __init__(self, device, slots: int = 3):
        self.device = torch.device(device)
        self._slots = [({}, None) for _ in range(slots)]
        self._next = 0

    def __call__(self, *arrays) -> tuple:
        if self.device.type != "cuda":
            return tuple(torch.as_tensor(a, dtype=torch.float32, device=self.device) for a in arrays)
        slot = self._next
        self._next = (slot + 1) % len(self._slots)
        bufs, event = self._slots[slot]
        if event is not None and not event.query():
            event.synchronize()
        out = []
        for i, a in enumerate(arrays):
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                out.append(a.to(self.device, torch.float32))
                continue
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            key = (i, a.shape)
            if key not in bufs:
                bufs[key] = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
            np.copyto(bufs[key].numpy(), a, casting="unsafe")
            out.append(torch.empty(a.shape, dtype=torch.float32, device=self.device).copy_(bufs[key],
                                                                                          non_blocking=True))
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._slots[slot] = (bufs, event)
        return tuple(out)


def if_branch(pred, body, pool) -> None:
    """Capture `body()` as the body of a conditional IF node on `pred` (ops.kernels.conditional)."""
    with conditional.if_node(pred, pool):
        body()


class FusedStep:
    """One fused step (`segs`, from step.visual_segments / step.vi_segments)
    run for a Tracker on `device`, as one CUDA graph a frame when `graphs`
    is set.

    The keyframe counters (`n_kf`, `fs`, `last`) live on the device and lead:
    each frame chains them into the next. A host path that moves them hands
    the new values to `set_counters`, and the next frame writes them in.

    `prepare(state, inputs)` captures the program on the tracker's state and
    a frame's inputs (the tracker calls it at construction, on its empty
    stores). `__call__(state, inputs) -> (state, out, stats)`: `state` is the
    tracker's step state without the counters, `inputs` the frame's inputs
    (`img`, `stamp`, `allow`, and for the stereo-inertial step `imu` and
    `wide`). Returns the state after the frame (the static buffers under
    graphs), `out` (ref, rel_R, rel_t: the trajectory record, copies the
    caller may keep) and the frame's `FrameStats`, the frame's one read.

    Under graphs the program is T, the decision, and K with and without
    windowed BA as the bodies of two IF nodes (`branch`: `if_branch`, or a
    test's stand-in), every part committing into the static buffers; a
    frame is one replay. `capture` captures the graph (`capture_graph`, or a
    stand-in). Launch counts: T's are counted at every replay, K's when the
    frame's stats say a keyframe of that variant was made, so a graph frame
    counts what an eager frame counts once its stats are read (`settle`)."""

    STATS_SLOTS = 4  # pinned stats buffers: frames whose stats are not yet read

    def __init__(self, segs, device, graphs: bool, capture=None, branch=None):
        self.segs = segs
        self.device = torch.device(device)
        self.graphs = bool(graphs)
        if self.graphs and capture is None and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self._capture = capture_graph if capture is None else capture
        self._branch = if_branch if branch is None else branch
        self.static = self.inputs = self.program = None
        self.counters = None  # n_kf / fs / last: 0-d int32 tensors on the device (the static buffers under graphs)
        self._moved = None  # counters a host path set, written at the next frame
        self._k_counters = {ba: hamming.ReplayCounter(*KERNEL_MODULES) for ba in (True, False)}
        self._unread: list[FrameStats] = []
        cuda = self.device.type == "cuda"
        self._stats_host = [torch.empty(step_mod.N_STATS, pin_memory=cuda) for _ in range(self.STATS_SLOTS)]
        self._free = list(range(self.STATS_SLOTS))
        self.capture_ms = 0.0  # wall time of the capture (warm-up included)
        self.pool_bytes = 0  # device memory reserved by the capture
        self.captures = 0
        self.replays = 0

    def set_counters(self, n_kf: int, fs: int, last: int) -> None:
        self._moved = (int(n_kf), int(fs), int(last))

    def _counter_state(self) -> dict:
        if self._moved is None and self.counters is None:
            raise RuntimeError("the fused step's keyframe counters were never set")
        if self._moved is None:
            return dict(self.counters)
        n_kf, fs, last = self._moved
        self._moved = None
        if self.counters is not None and self.graphs:  # written into the buffers the graph reads
            copy_into([(self.counters["n_kf"], n_kf), (self.counters["fs"], fs), (self.counters["last"], last)], set())
            return dict(self.counters)
        dev = self.device
        return {k: step_mod._dev_int(v, dev) for k, v in (("n_kf", n_kf), ("fs", fs), ("last", last))}

    # -- the stats read ------------------------------------------------------
    def _stats(self, stats: torch.Tensor) -> FrameStats:
        """Start the frame's stats on their way to the host."""
        while not self._free:  # every slot waits for a read: read the oldest (no frame leaves one unread for long)
            self._unread[0].read()
        slot = self._free.pop()
        host, event = self._stats_host[slot], None
        if self.device.type == "cuda":
            host.copy_(stats, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        else:
            host.copy_(stats)
        fs = FrameStats(host, event, self._settled, slot)
        self._unread.append(fs)
        return fs

    def _settled(self, fs: FrameStats) -> None:
        stats = fs._value
        if self.graphs and stats[step_mod.ST_KF_CREATED] > 0:
            self._k_counters[bool(stats[step_mod.ST_NKF] >= 3)].add()
        self._unread.remove(fs)
        self._free.append(fs._slot)

    def settle(self) -> None:
        """Read every frame's stats not yet read (waiting for them): the
        keyframe branch's launches are then counted."""
        for fs in list(self._unread):
            fs.read()

    # -- eager -------------------------------------------------------------
    def _eager(self, state, inputs):
        inputs = step_mod.scalar_inputs(inputs, self.device)
        s, out, _, _ = step_mod.run_segments(self.segs, inputs, {**state, **self._counter_state()})
        self.counters = {k: s[k] for k in ("n_kf", "fs", "last")}
        return s, out

    # -- graphs ------------------------------------------------------------
    def _commit(self, new: dict) -> None:
        copy_into(tree_pairs(self.static, new, []), self._storages)

    def _program(self, commit: bool):
        """The whole step on the static buffers. `commit`: the capture (each
        part commits, K's variants as IF bodies, `out` is T's buffers that
        either branch overwrites); else the warm-up, which runs T and both K
        variants once, results dropped, so that every kernel is built and
        every handle exists before the capture."""
        segs, inputs = self.segs, self.inputs
        new, out, carry = segs.track(inputs, self.static)
        if commit:
            self._commit(new)
        state = self.static if commit else {**self.static, **new}
        need = segs.decide(inputs, state, carry)
        n_kf2 = state["n_kf"] + 1
        for with_ba, pred in ((True, need & (n_kf2 >= 3)), (False, need & (n_kf2 < 3))):
            def body(with_ba=with_ba):
                with self._k_counters[with_ba].capturing():
                    new_k, out_k = segs.keyframe(inputs, state, carry, with_ba)
                    if commit:
                        self._commit(new_k)
                        copy_into(tree_pairs(out, out_k, []), set())
            if commit:
                self._branch(pred, body, self._bodies)
            else:
                body()
        return out

    def prepare(self, state: dict, inputs: dict) -> None:
        """Capture the program (graphs only) on `state` (the tracker's, without
        the counters) and `inputs` (any frame's, e.g. blank images): the
        static buffers are cloned from them, and the counters start as
        `set_counters` last set them (zero if never)."""
        if not self.graphs or self.program is not None:
            return
        dev = self.device
        if self._moved is None and self.counters is None:
            self._moved = (0, 0, 0)
        self.static = tree_clone({**state, **self._counter_state()})
        self.counters = {k: self.static[k] for k in ("n_kf", "fs", "last")}
        self.inputs = tree_clone(step_mod.scalar_inputs(inputs, dev))
        self._storages = {t.untyped_storage().data_ptr() for t in tree_leaves(self.static)}
        cuda = dev.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if cuda else None
        self._bodies = conditional.BodyPool(dev) if cuda else None  # the IF bodies' memory
        try:
            self.program = self._capture(dev, pool, "the fused step", self._program)
        finally:  # the bodies' memory lives as long as the graph that replays them (none if the capture failed)
            if self._bodies is not None:
                self._bodies.tie(None if self.program is None else self.program.graph)
        self.captures += 1
        self.capture_ms += self.program.ms
        self.pool_bytes += self.program.pool_bytes

    def __call__(self, state: dict, inputs: dict):
        if not self.graphs:
            s, out = self._eager(state, inputs)
            return s, {k: out[k] for k in ("ref", "rel_R", "rel_t")}, self._stats(out["stats"])
        if self.program is None:
            self.prepare(state, inputs)
        while len(self._unread) > 1:  # a frame whose stats the caller dropped (a map reset): counted now
            self._unread[0].read()
        self._counter_state()
        copy_into(tree_pairs(self.static, state, []), self._storages)
        copy_into(tree_pairs(self.inputs, inputs, []), set())
        self.program.replay()
        self.replays += 1
        out = self.program.outs
        record = {k: out[k].clone() for k in ("ref", "rel_R", "rel_t")}  # the next replay overwrites them
        return self.static, record, self._stats(out["stats"])


class StageProgram:
    """One stage of the host-orchestrated frames (`fn`, a function of
    tensors, trees of tensors and hashable static values) run on `device`,
    as CUDA graphs when `graphs` is set: captured at the first call with
    each input signature and replayed at every later one (see the module
    docstring). `pool`: the graph memory pool the captures share (a
    tracker's stages share one). `capture`: what captures a graph,
    `capture_graph` unless a test hands in a stand-in."""

    max_signatures = 8  # more means a per-call host value in the signature: it would capture every call

    def __init__(self, fn, device, graphs: bool, name: str, pool=None, capture=None):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.graphs = bool(graphs)
        if self.graphs and capture is None and self.device.type != "cuda":
            raise ValueError(f"stage {name}: CUDA graphs need a CUDA device, not {self.device}")
        self._capture = capture_graph if capture is None else capture
        self._pool = pool
        self._entries: dict = {}  # signature -> (static inputs, Captured, output leaf -> input leaf index)
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0

    @property
    def captures(self) -> int:
        return len(self._entries)

    def _new_entry(self, args):
        if len(self._entries) >= self.max_signatures:
            raise RuntimeError(f"stage {self.name}: input signature {len(self._entries) + 1}; a value that changes "
                               f"between calls must enter as a device tensor")
        inputs = tree_clone(args)
        leaves = tree_leaves(inputs)
        versions = [t._version for t in leaves]
        cap = self._capture(self.device, self._pool, f"stage {self.name}", lambda commit: self.fn(*inputs))
        if [t._version for t in leaves] != versions:
            raise RuntimeError(f"stage {self.name} writes into its inputs")
        where = {(t.data_ptr(), t.shape, t.stride(), t.dtype): i for i, t in enumerate(leaves)}
        alias = [where.get((t.data_ptr(), t.shape, t.stride(), t.dtype)) for t in tree_leaves(cap.outs)]
        self.capture_ms += cap.ms
        self.pool_bytes += cap.pool_bytes
        return inputs, cap, alias

    def __call__(self, *args):
        if not self.graphs:
            return self.fn(*args)
        key = signature(args)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._new_entry(args)
        else:
            copy_into(tree_pairs(entry[0], args, []), set())
        _, cap, alias = entry
        cap.replay()
        self.replays += 1
        sources = tree_leaves(args)
        results = iter([t.clone() if a is None else sources[a] for t, a in zip(tree_leaves(cap.outs), alias)])
        return tree_map(lambda _: next(results), cap.outs)
