"""The per-frame programs as CUDA graphs: the port's counterpart of the
reference's `jax.jit(step)` (pli_slam_tpu/frontend/tracker.py:1225, :1425)
and of its jitted stage programs (`jax.jit(partial(stage, cam, cfg))`,
tracker.py:1518-1579, :1612, :1676-1678).

`FusedStep` runs a fused step, cut at its one device->host read
(frontend.step.Segments): T builds and tracks the frame, K is the keyframe
branch.

- with `graphs=True` (CUDA only) T is captured into one CUDA graph at the
  first fused frame and K (for keyframes with windowed BA, n_kf >= 2) at
  the first such keyframe; both replay every later frame. A keyframe
  without BA (the map's second and third, n_kf < 2: the reference's
  `n_kf2 >= 3` cond) runs K eagerly on the same buffers. The frame's read
  -- (ok, inliers, the reference keyframe's inliers) -- is copied into
  pinned host memory after T's replay, and the host waits on an event for
  those twelve bytes before it decides on a keyframe;
- with `graphs=False` (and always on the CPU) T, the read and K run
  eagerly (`step.run_segments`).

State. The graphs read and write static buffers: every tensor of the step's
state (pose, velocity, IMU state, keyframe counters, stores, BoW database,
view ring, local map) is cloned once when T is captured, and each segment
ends by copying what it changed into them. The tracker then holds those
buffers. A rare path (loop correction, a deferred BA chunk, relocalization,
merge, reset, `load_map`, leaving the fused stereo-inertial mode) replaces
the tracker's tensors with new ones; before every replay `FusedStep` copies
each tensor whose storage is not its buffer's into the buffer, and writes
the host's keyframe counters when they differ from what the last fused
frame left on the device. Per-frame inputs (images, IMU batch, stamp, the
widened-window flag) are copied into static input buffers.

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

Capture (`capture_graph`, both classes). The body is run once eagerly on a
side stream first, its launches uncounted and its results dropped (kernel
builds, cuBLAS / cuSOLVER handles, the gated-match kernel's tickets on that
stream, the constants of ops.consts), then captured on that stream into
the caller's memory pool. A capture that fails raises, naming the segment
or stage (PyTorch's error names the operation); nothing falls back to
eager. The hand-written kernels' launch counters count per replay
(ops.kernels.hamming.ReplayCounter), so a graph frame counts what an eager
frame counts.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.ops.kernels import eig4, hamming, rot3, svd_small


KERNEL_MODULES = (hamming, rot3, eig4, svd_small)  # the hand-written kernels' modules, each with its `launches`


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


def capture_graph(device, pool, what: str, body, stream=None) -> Captured:
    """Warm `body` up on a side stream (`body(False)`: its launches
    uncounted, its results dropped), then capture `body(True)` on that
    stream into `pool`. A failed capture raises, naming `what`."""
    dev = torch.device(device)
    side = stream if stream is not None else torch.cuda.Stream(dev)
    t0 = time.perf_counter()
    counter = hamming.ReplayCounter(*KERNEL_MODULES)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with counter.uncounted():
            body(False)
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


class FusedStep:
    """One fused step (`segs`, from step.visual_segments / step.vi_segments)
    run for a Tracker on `device`, as CUDA graphs when `graphs` is set.

    `__call__(state, inputs, n_kf, fs, allow_mapping) -> (state, out,
    need_kf)`: `state` is the tracker's step state (the host's counters
    `n_kf` / `fs` are passed separately, as ints), `inputs` the frame's
    inputs. Returns the state after the frame (the static buffers when
    graphs run), the last segment's `out` (stats, ref, rel_R, rel_t; copies
    the caller may keep) and the keyframe decision."""

    def __init__(self, segs, device, graphs: bool):
        self.segs = segs
        self.device = torch.device(device)
        self.graphs = bool(graphs)
        if self.graphs and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.static = self.inputs = None
        self.T = self.K = None
        self.capture_ms = 0.0  # wall time of the captures (warm-up included)
        self.pool_bytes = 0  # device memory reserved by the captures
        self.replays = 0

    # -- eager -------------------------------------------------------------
    def _eager(self, state, inputs, n_kf, fs, allow_mapping):
        dev = self.device
        inputs = step_mod.scalar_inputs(inputs, dev)
        state = {**state, "n_kf": step_mod._dev_int(n_kf, dev), "fs": step_mod._dev_int(fs, dev),
                 "last": step_mod._dev_int(state["last"], dev)}
        s, out, _, need_kf = step_mod.run_segments(self.segs, inputs, state, n_kf, fs, allow_mapping)
        return s, out, need_kf

    # -- graphs ------------------------------------------------------------
    def _load(self, state, inputs, n_kf, fs):
        dev = self.device
        if self.static is None:
            state = {**state, "n_kf": step_mod._dev_int(n_kf, dev), "fs": step_mod._dev_int(fs, dev),
                     "last": step_mod._dev_int(state["last"], dev)}
            self.static = tree_clone(state)
            self.inputs = tree_clone(step_mod.scalar_inputs(inputs, dev))
            self._storages = {t.untyped_storage().data_ptr() for t in tree_leaves(self.static)}
            self._counters = (n_kf, fs)
            self._read = torch.empty(3, dtype=torch.int32, pin_memory=True)
            self._event = torch.cuda.Event()
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
            return
        pairs = tree_pairs(self.static, {k: v for k, v in state.items() if k not in ("n_kf", "fs")}, [])
        if self._counters != (n_kf, fs):  # a host path moved the counters
            pairs += [(self.static["n_kf"], int(n_kf)), (self.static["fs"], int(fs))]
        copy_into(pairs, self._storages)
        copy_into(tree_pairs(self.inputs, inputs, []), set())

    def _commit(self, new: dict) -> None:
        copy_into(tree_pairs(self.static, new, []), self._storages)

    def _run_track(self, commit: bool):
        new, out, carry = self.segs.track(self.inputs, self.static)
        if commit:
            self._commit(new)
        return out, carry

    def _run_keyframe(self, commit: bool):
        new, out = self.segs.keyframe(self.inputs, self.static, self.carry, True)
        if commit:
            self._commit(new)
        return out

    def _capture(self, name: str, body) -> Captured:
        cap = capture_graph(self.device, self._pool, f"segment {name} of the fused step", body, self._stream)
        self.capture_ms += cap.ms
        self.pool_bytes += cap.pool_bytes
        return cap

    def _replay(self, seg: Captured) -> None:
        seg.replay()
        self.replays += 1

    def __call__(self, state: dict, inputs: dict, n_kf: int, fs: int, allow_mapping):
        if not self.graphs:
            return self._eager(state, inputs, n_kf, fs, allow_mapping)
        self._load(state, inputs, n_kf, fs)
        if self.T is None:
            self.T = self._capture("T (track)", self._run_track)
        self._replay(self.T)
        out, self.carry = self.T.outs
        self._read.copy_(out["read"], non_blocking=True)
        self._event.record()
        self._event.synchronize()
        ok, n_in, last = self._read.tolist()
        need_kf = step_mod.keyframe_decision(self.segs.cfg, ok, n_in, last, n_kf, fs, allow_mapping)
        if need_kf and n_kf + 1 >= 3:
            if self.K is None:
                self.K = self._capture("K (keyframe)", self._run_keyframe)
            self._replay(self.K)
            out = self.K.outs
        elif need_kf:  # the first keyframes, without windowed BA, run eagerly on the buffers
            new, out = self.segs.keyframe(self.inputs, self.static, self.carry, False)
            self._commit(new)
        self._counters = (n_kf + 1, 0) if need_kf else (n_kf, fs + 1)
        out = {k: out[k].clone() for k in ("stats", "ref", "rel_R", "rel_t")}  # the next replay overwrites them
        return self.static, out, need_kf


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
