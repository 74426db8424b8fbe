"""The fused step as one program, on the CPU.

On a GPU frontend.graphs.FusedStep captures each fused step once, when the
Tracker is constructed, as one CUDA graph: T, the keyframe decision on the
device (`step.need_keyframe`, the reference's `need_kf`), and K with and
without windowed BA as the bodies of two conditional IF nodes; a frame is
one replay and the host reads one stats vector (one frame late in
streaming mode). What the CPU can show of that (the program against the
reference's jitted steps, the counters chained on the device, is
test_torch_graph_step.py's and test_torch_graph_step_vi.py's (a)):

- (b) the device decision against the host's float64 transcription of it
  (the port's decision before it moved to the device) on every integer
  pair up to 3000 for the shipped ratio, and against the reference's
  float32 expression at a ratio where the two differ (0.6: n_in 15, last
  25);
- (c) `make_fx(tracing_mode="fake")` of the decision and of the whole
  program (T with the frame build, K with and without windowed BA), at
  the port's own first fused keyframe with windowed BA
  (`own_fused_frames`): no host read inside; for the visual step this is
  test_torch_graph_step.py's (b);
- (d) FusedStep's bookkeeping on stand-in graphs (a capture that runs the
  program, a branch that runs a body when its predicate holds), driven by
  a Tracker: one capture per fused step, at construction; one replay a
  frame; no `aten._local_scalar_dense` between a streaming frame's start
  and its stats read but the stand-in's own look at the predicates; K's
  launches counted on keyframes only; counters a host path moved written
  at the next frame, once; every frame equal to the eager tracker's;
- the trajectory record's reference keyframe taken from the step's `ref`,
  equal to the host mirror's `max(n_kf - 1, 0)` when the mirror is current.
"""

import dataclasses
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph_step import _fake_trace, check_segments_trace, own_fused_frames
from test_torch_stages import CAM, TRAJ, _vi_cfg, stand_in_capture
from torch.utils._python_dispatch import TorchDispatchMode

from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops.kernels import hamming as tham
from pli_slam_tpu_torch.utils import synthetic
from pli_slam_tpu_torch.utils.config import SlamConfig

torch.set_num_threads(1)
N_FRAMES = 14


def _cfg():
    return dataclasses.replace(_vi_cfg(), sensor="stereo")


@pytest.fixture(scope="module")
def frames():
    return list(synthetic.make_sequence(CAM, N_FRAMES, "cpu", fps=_cfg().fps, traj=synthetic.Trajectory(**TRAJ),
                                        room_half=2.55))


# ---------------------------------------------------------------------------
# (b) the decision on the device
# ---------------------------------------------------------------------------


def _host_decision(cfg, ok, n_in, last, n_kf, fs, allow) -> bool:
    """The decision as the host made it from the frame's read, in float64
    (`fs` counts this frame)."""
    tc = cfg.tracking
    return (bool(ok) and bool(allow) and n_in >= tc.kf_min_inliers and fs > max(tc.kf_min_interval, 1)
            and (fs >= tc.kf_max_interval or n_in < tc.kf_ref_ratio * max(last, 1))
            and n_kf < cfg.map.max_keyframes)


def _device_grid(cfg, n_in, last, fs, n_kf=0, ok=True, allow=True):
    i32 = torch.int32
    return tstep.need_keyframe(cfg, torch.tensor(ok), torch.as_tensor(n_in, dtype=i32),
                               torch.as_tensor(last, dtype=i32), torch.tensor(n_kf, dtype=i32),
                               torch.tensor(fs, dtype=i32), torch.tensor(allow)).numpy()


def test_device_decision_equals_host_on_the_shipped_ratio():
    """Every (n_in, last) pair up to 3000 at the shipped ratio, at a frame
    count inside the keyframe interval (the ratio decides) and at its end;
    and every other term on a small grid."""
    cfg = SlamConfig()
    assert cfg.tracking.kf_ref_ratio == 0.75
    tc = cfg.tracking
    n_in, last = np.meshgrid(np.arange(3001), np.arange(3001), indexing="ij")
    for fs in (max(tc.kf_min_interval, 1) + 1, tc.kf_max_interval):
        want = ((n_in >= tc.kf_min_inliers) & ((fs >= tc.kf_max_interval)
                                               | (n_in < tc.kf_ref_ratio * np.maximum(last, 1).astype(np.float64))))
        assert np.array_equal(_device_grid(cfg, n_in, last, fs), want), fs
    for ok in (False, True):
        for allow in (False, True):
            for fs in range(0, tc.kf_max_interval + 2):
                for n_kf in (0, cfg.map.max_keyframes - 1, cfg.map.max_keyframes):
                    for n_in_, last_ in ((0, 0), (tc.kf_min_inliers, 400), (300, 400), (300, 399), (500, 100)):
                        got = bool(_device_grid(cfg, n_in_, last_, fs, n_kf, ok, allow))
                        assert got == _host_decision(cfg, ok, n_in_, last_, n_kf, fs, allow), \
                            (ok, allow, fs, n_kf, n_in_, last_)


def test_device_decision_rounds_as_the_reference_at_ratio_06():
    """At ratio 0.6 the host's float64 product and the reference's float32
    one (a Python float times an int32 array, pli_slam_tpu/frontend/
    tracker.py:1181) decide differently at n_in 15, last 25: the port
    decides as the reference, there and on the whole grid."""
    cfg = SlamConfig()
    cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, kf_ref_ratio=0.6, kf_min_inliers=0))
    fs = max(cfg.tracking.kf_min_interval, 1) + 1
    n_in, last = np.meshgrid(np.arange(3001, dtype=np.int32), np.arange(3001, dtype=np.int32), indexing="ij")
    ref = np.asarray(jnp.asarray(n_in) < cfg.tracking.kf_ref_ratio * jnp.maximum(jnp.asarray(last), 1))
    got = _device_grid(cfg, n_in, last, fs)
    assert np.array_equal(got, ref)
    assert bool(got[15, 25]) and not _host_decision(cfg, True, 15, 25, 0, fs, True)


# ---------------------------------------------------------------------------
# (c) no host read inside the decision or the program
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def program_args(frames):
    """(segments, inputs, state) of the port's first fused keyframe with
    windowed BA in a tiny stereo run, as its fused step handed them over
    (the images in the inputs: T builds the frame)."""
    tracker = Tracker(CAM, _cfg(), "cpu")
    first, _ = own_fused_frames(tracker, frames, built=False)
    return (tracker._fused_step().segs, *first)


def _predicates(segs, inputs, state, carry):
    """The decision and the IF nodes' predicates FusedStep derives from it."""
    need = segs.decide(inputs, state, carry)
    n_kf2 = state["n_kf"] + 1
    return need & (n_kf2 >= 3), need & (n_kf2 < 3)


@pytest.mark.parametrize("traced", ["decision", "program"])
def test_decision_and_program_trace_in_fake_mode(program_args, traced):
    """What FusedStep captures, traced in fake mode a part at a time, each
    on the outputs of the parts before it: the decision with the IF nodes'
    predicates (the reference's float32 ratio comparison in it); T with the
    frame build and K with and without windowed BA (test_torch_graph_step.py's
    (b) for the visual step)."""
    segs, inputs, state = program_args
    if traced == "decision":
        new, _, carry = segs.track(inputs, state)
        gm = _fake_trace(partial(_predicates, segs), (inputs, {**state, **new}, carry))
        assert any("lt" in str(n.target) for n in gm.graph.nodes)
    else:
        assert check_segments_trace(segs, (inputs, state), without_ba=True) > 2000


# ---------------------------------------------------------------------------
# (d) FusedStep's bookkeeping on stand-in graphs
# ---------------------------------------------------------------------------


class _Look:
    """The stand-in branch: runs a body when its predicate holds, read on the
    host (the one host read of the stand-in, flagged while it happens)."""

    def __init__(self):
        self.looking, self.looks = False, 0

    def __call__(self, pred, body, pool):
        self.looking, self.looks = True, self.looks + 1
        holds = bool(pred)
        self.looking = False
        if holds:
            body()


class _HostReads(TorchDispatchMode):
    """Counts `aten._local_scalar_dense` (a tensor's value read on the host) outside the stand-in's look."""

    def __init__(self, look):
        super().__init__()
        self.look, self.reads = look, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default and not self.look.looking:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def _stand_in_tracker(look, calls):
    class StandIn(Tracker):
        def _fused_program(self, segs):
            fused = graphs.FusedStep(segs, self.device, True, capture=stand_in_capture, branch=look)
            set_counters = fused.set_counters

            def counted(*a):
                calls.append(a)
                set_counters(*a)

            fused.set_counters = counted
            return fused

    return StandIn(CAM, _cfg(), "cpu")


@pytest.fixture
def counted_matches(monkeypatch):
    """The gated match counting a launch on the CPU too (there it runs its plain version)."""
    match = tstep.gated_match

    def counting(*a, **k):
        tham.launches += 1
        return match(*a, **k)

    monkeypatch.setattr(tstep, "gated_match", counting)
    tham.reset_launches()
    yield
    tham.reset_launches()


def test_fused_step_on_stand_in_graphs(frames, counted_matches):
    """Without streaming: every frame's record, pose and launch count (read
    after the frame's stats) equal the eager tracker's; one capture at
    construction, one replay a fused frame; a keyframe adds K's launches,
    another frame only T's; counters a host path moves are handed over once
    and decide the next frame."""
    eager = Tracker(CAM, _cfg(), "cpu")
    look, calls = _Look(), []
    tracker = _stand_in_tracker(look, calls)
    fused = tracker._step
    assert fused.captures == 1 and fused.replays == 0 and tracker.fused_warmup_ms is not None
    per_frame = {}
    for k, fr in enumerate(frames[:10]):
        for name, tr in (("eager", eager), ("graphs", tracker)):
            n0 = tham.launches
            info = tr.process(fr["img_l"], fr["img_r"], fr["t"])
            per_frame.setdefault(k, {})[name] = (info, tham.launches - n0, tr.R.clone(), tr.t.clone())
        (ie, le, Re, te), (ig, lg, Rg, tg) = per_frame[k]["eager"], per_frame[k]["graphs"]
        assert ie == ig and le == lg and torch.equal(Re, Rg) and torch.equal(te, tg), (k, ie, ig, le, lg)
    assert fused.captures == 1 and fused.replays == 9  # the first frame initializes on the host path
    launches = {k: v["graphs"][1] for k, v in per_frame.items() if k > 0}
    kf_frames = {k for k, v in per_frame.items() if k > 0 and v["graphs"][0]["n_kf"] > per_frame[k - 1]["graphs"][0]["n_kf"]}
    assert kf_frames and len(kf_frames) < 9
    t_only = {launches[k] for k in launches if k not in kf_frames}
    assert len(t_only) == 1 and all(launches[k] > next(iter(t_only)) for k in kf_frames), (launches, kf_frames)
    # the counters: handed over at the first fused frame only, then chained on the device
    assert len(calls) == 1 and calls[0][0] == 1
    tracker.last_kf_inliers = 10 ** 6  # a host path moves a counter: every inlier count is below 0.75 of it
    eager.last_kf_inliers = 10 ** 6
    for fr in frames[10:12]:
        for tr in (eager, tracker):
            tr.process(fr["img_l"], fr["img_r"], fr["t"])
    assert len(calls) == 2 and calls[1][2] == 10 ** 6  # written at the next frame, once
    assert eager.stats[-2:] == tracker.stats[-2:]
    assert eager.n_kf == tracker.n_kf and np.array_equal(eager.positions(), tracker.positions())


def test_streaming_frame_reads_nothing_but_its_stats(frames, counted_matches):
    """Streaming: between a fused frame's start and its stats read (the
    previous frame's, inside `process`) nothing reads a tensor on the host
    but the stand-in's look at the two predicates; the launch counts equal
    the eager tracker's once the pending stats are read (`finalize`)."""
    look, calls = _Look(), []
    tracker = _stand_in_tracker(look, calls)
    eager = Tracker(CAM, _cfg(), "cpu")
    for tr in (tracker, eager):
        tr.streaming = True
    with _HostReads(look) as mode:
        int(torch.ones((), dtype=torch.int32))
    assert mode.reads == 1  # the mode sees a host read
    counts = {}
    for name, tr in (("eager", eager), ("graphs", tracker)):
        tham.reset_launches()
        for k, fr in enumerate(frames):
            if name == "graphs" and k >= 2:  # a fused frame with a frame's stats pending before it
                looks = look.looks
                with _HostReads(look) as mode:
                    tr.process(fr["img_l"], fr["img_r"], fr["t"])
                assert mode.reads == 0 and look.looks == looks + 2, (k, mode.reads, look.looks - looks)
            else:
                tr.process(fr["img_l"], fr["img_r"], fr["t"])
        tr.finalize()
        counts[name] = tham.launches
    assert counts["eager"] == counts["graphs"] > 0
    assert eager.stats == tracker.stats and np.array_equal(eager.positions(), tracker.positions())
    assert tracker._step.replays == N_FRAMES - 1 and tracker._step.captures == 1


def test_trajectory_record_takes_the_steps_reference_keyframe(frames):
    """A fused frame's record names the step's own reference keyframe (its
    `ref`, a device scalar); with the host mirror current (without
    streaming) that is the mirror's `max(n_kf - 1, 0)`, and composing either
    gives the same trajectory."""
    tracker = Tracker(CAM, _cfg(), "cpu")
    host_refs = []
    for fr in frames[:8]:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        host_refs.append(max(tracker.n_kf - 1, 0))
    pend = list(tracker._traj_pending)
    assert [int(e[1]) for e in pend[1:]] == host_refs[1:]
    assert all(isinstance(e[1], torch.Tensor) for e in pend[1:])
    from_step = tracker.positions()
    tracker._traj_done = []
    tracker._traj_pending = [(e[0], h, *e[2:]) for e, h in zip(pend, host_refs)]
    assert np.array_equal(tracker.positions(), from_step)


def test_fused_step_counters_need_setting():
    """A fused step never handed its counters refuses to run rather than start from a guess."""
    segs = tstep.visual_segments(CAM, _cfg(), None, None, None)
    fused = graphs.FusedStep(segs, "cpu", False)
    with pytest.raises(RuntimeError, match="counters"):
        fused._counter_state()
