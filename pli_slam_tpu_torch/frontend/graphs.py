"""The fused per-frame steps as CUDA graphs: the port's counterpart of the
reference's `jax.jit(step)` (pli_slam_tpu/frontend/tracker.py:1225, :1425).

A step is cut at its one device->host read (frontend.step.Segments): T
builds and tracks the frame, K is the keyframe branch. `FusedStep` runs them
for a `Tracker`:

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

Capture. Each segment is run once eagerly on a side stream first, without
committing its results (kernel builds, cuBLAS / cuSOLVER handles, the
gated-match kernel's tickets on that stream, the constants of ops.consts),
then captured on that stream; T and K share one memory pool. A capture that
fails raises, naming the segment (PyTorch's error names the operation);
nothing falls back to eager. The hand-written kernels' launch counters
count per replay (ops.kernels.hamming.ReplayCounter), so a graph frame
counts what an eager frame counts.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.ops.kernels import hamming, rot3


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


def tree_clone(tree):
    """The same structure with every tensor leaf cloned into memory of its own."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_clone(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


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

    def _capture(self, name: str, body):
        """Warm `body` up on the side stream (its launches uncounted, its
        results dropped), capture it, and return (graph, counter, outputs)."""
        dev, side = self.device, self._stream
        t0 = time.perf_counter()
        counter = hamming.ReplayCounter(hamming, rot3)
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
                with counter.capturing(), torch.cuda.graph(graph, pool=self._pool, stream=side,
                                                           capture_error_mode="thread_local"):
                    outs = body(True)
            except Exception as exc:
                raise RuntimeError(f"capturing segment {name} of the fused step failed: {exc}") from exc
        torch.cuda.current_stream(dev).wait_stream(side)
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved0
        return graph, counter, outs

    def _replay(self, seg) -> None:
        graph, counter, _ = seg
        counter.replay(graph)
        self.replays += 1

    def __call__(self, state: dict, inputs: dict, n_kf: int, fs: int, allow_mapping):
        if not self.graphs:
            return self._eager(state, inputs, n_kf, fs, allow_mapping)
        self._load(state, inputs, n_kf, fs)
        if self.T is None:
            self.T = self._capture("T (track)", self._run_track)
        self._replay(self.T)
        out, self.carry = self.T[2]
        self._read.copy_(out["read"], non_blocking=True)
        self._event.record()
        self._event.synchronize()
        ok, n_in, last = self._read.tolist()
        need_kf = step_mod.keyframe_decision(self.segs.cfg, ok, n_in, last, n_kf, fs, allow_mapping)
        if need_kf and n_kf + 1 >= 3:
            if self.K is None:
                self.K = self._capture("K (keyframe)", self._run_keyframe)
            self._replay(self.K)
            out = self.K[2]
        elif need_kf:  # the first keyframes, without windowed BA, run eagerly on the buffers
            new, out = self.segs.keyframe(self.inputs, self.static, self.carry, False)
            self._commit(new)
        self._counters = (n_kf + 1, 0) if need_kf else (n_kf, fs + 1)
        out = {k: out[k].clone() for k in ("stats", "ref", "rel_R", "rel_t")}  # the next replay overwrites them
        return self.static, out, need_kf
