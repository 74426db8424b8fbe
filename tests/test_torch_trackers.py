"""Any number of trackers in one process: the bookkeeping that keeps the
IF bodies' stream and memory apart from every capture (ops.kernels.
conditional, frontend.graphs), `System.reset()` twice with loop closing on
against the reference's `System`, and the one-ulp tracer's graph-run mode
(utils.rounding) on a tiny RGB-D run.

On the card the port captures on streams of its own (`csrc/cond_node.cu`,
`conditional.Streams`), so no `torch.cuda.Stream()` can hand one out;
chip_smoke.py phases 3e and 16 build the IF nodes and the trackers there.
Here the guard is a function of stream handles and the pool's release
runs on stand-ins.

Tolerances: the port's poses after each reset within 1e-5 m of the
reference's run on the same frames (float32 tracking on the accelerator
branch; measured 3.3e-7 m), keyframe counts and states equal; the tracer's
plain runs bit-identical to each other.
"""

import dataclasses
import gc
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.system import System as JSystem
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend.tracker import TrackingState
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.ops.kernels import conditional
from pli_slam_tpu_torch.system import System
from pli_slam_tpu_torch.utils import convert, rounding
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = JCamera.pinhole(**CAM_ARGS), TCamera.pinhole(**CAM_ARGS)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
N_FRAMES = 5


# ---------------------------------------------------------------------------
# The IF bodies' stream: refused as the parent capture's stream
# ---------------------------------------------------------------------------


def test_if_node_refuses_a_parent_on_the_body_stream():
    with pytest.raises(RuntimeError, match="parent capture's stream 0x7f40 is the IF bodies' stream 0x7f40"):
        conditional.check_parent(0x7F40, 0x7F40)


@pytest.mark.parametrize("parent", [0x7F00, 0x7F80])
def test_if_node_takes_a_parent_on_any_other_stream(parent):
    conditional.check_parent(parent, 0x7F40)
    with pytest.raises(RuntimeError, match=f"parent capture's stream {parent:#x} is the IF bodies' stream"):
        conditional.check_parent(parent, parent)


# ---------------------------------------------------------------------------
# The IF bodies' pool lives exactly as long as the graph that replays them
# ---------------------------------------------------------------------------


class _Graph:
    """A stand-in for the CUDAGraph the bodies were captured into."""


class _Owner:
    """A stand-in for the FusedStep that holds the graph."""

    def __init__(self, graph):
        self.program = graph


@pytest.fixture
def releases(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 7))
    monkeypatch.setattr(torch._C, "_cuda_releasePool", lambda index, pool: calls.append((index, pool)), raising=False)
    return calls


def test_body_pool_is_given_back_with_its_graph_not_its_owner(releases):
    graph = _Graph()
    pool = conditional.BodyPool(torch.device("cuda", 0))
    pool.refs = 3  # three IF bodies captured
    pool.tie(graph)
    owner = _Owner(graph)
    kept = owner.program  # a caller that still holds the graph (a profile, a test)
    del owner, graph
    gc.collect()
    assert releases == [] and pool.refs == 3  # the graph can still replay its bodies
    del kept
    gc.collect()
    assert releases == [(0, (0, 7))] * 3 and pool.refs == 0


def test_body_pool_of_a_failed_capture_is_given_back_at_once(releases):
    pool = conditional.BodyPool(torch.device("cuda", 0))
    pool.refs = 2
    pool.tie(None)  # no graph replays the bodies
    assert releases == [(0, (0, 7))] * 2 and pool.refs == 0
    graph = _Graph()
    conditional.BodyPool(torch.device("cuda", 0), graph).refs = 1  # tied at construction
    del graph
    gc.collect()
    assert releases == [(0, (0, 7))] * 3


# ---------------------------------------------------------------------------
# System.reset() twice, loop closing on, against the reference's System
# ---------------------------------------------------------------------------


def test_system_reset_twice_tracks_as_the_reference(monkeypatch):
    """The port's `System` (SlamConfig.tiny_test(): loop closing on) tracks
    N_FRAMES frames, resets, tracks them again, resets and tracks them a
    third time; each time every frame's pose, state and keyframe count
    agree with the reference's `System` on the same frames (the
    accelerator branch, which the port follows), and each reset made a new
    tracker with empty frame times."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    cfg = SlamConfig.tiny_test()
    assert cfg.loop.enabled
    frames = list(tsyn.make_sequence(TC, N_FRAMES, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ), room_half=2.55))
    ref = JSystem(JC, cfg)
    want = [ref.track_stereo(fr["img_l"].numpy(), fr["img_r"].numpy(), fr["t"]) for fr in frames]
    want_kf = ref.tracker.n_kf
    sysm = System(TC, convert.config_from_reference(dataclasses.asdict(cfg)), device="cpu")
    trackers = []
    for round_ in range(3):
        if round_:
            sysm.reset()
            assert sysm.timing_stats()["fps"] == 0.0
        assert sysm.tracker.loop_closer is not None and all(sysm.tracker is not t for t in trackers)
        trackers.append(sysm.tracker)
        for fr, w in zip(frames, want):
            got = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"])
            assert got["state"] == w["state"] == TrackingState.OK
            np.testing.assert_allclose(got["p_w"], np.asarray(w["p_w"]), atol=1e-5, err_msg=f"round {round_}")
        assert sysm.tracker.n_kf == want_kf


# ---------------------------------------------------------------------------
# The one-ulp tracer's graph-run mode (profile.py --rounding one-ulp)
# ---------------------------------------------------------------------------


def test_one_ulp_trace_parts_the_runs_and_gives_a_verdict():
    """`rounding.trace_phase` on phase 7's route (`System.track_rgbd`,
    streaming) at a tiny size: two plain runs bit-identical, the nudged
    run parting from frame 1 on; `ulp_verdict` reads `compare`'s rows."""
    cfg = convert.config_from_reference(dataclasses.asdict(SlamConfig.tiny_test().replace(sensor="rgbd")))
    frames = list(tsyn.make_sequence(TC, 4, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ), room_half=2.55,
                                     with_depth=True))
    data = (cfg, TC, frames)
    a, b = (rounding.trace_phase(torch.device("cpu"), "7", data) for _ in range(2))
    nudged = rounding.trace_phase(torch.device("cpu"), "7", data, nudge_after=1)
    same = rounding.compare(a["events"], b["events"])
    assert same["first"] is None and a["ate"] == b["ate"]
    cmp = rounding.compare(a["events"], nudged["events"])
    assert cmp["first"][:2] == (1, next(j for j, (k, _) in enumerate(a["events"][1]) if k == "pose"))
    assert len(cmp["rows"]) == len(frames) and np.isfinite(nudged["ate"])
    v = rounding.ulp_verdict(a, nudged, cmp)
    assert v["verdict"] in ("robust", "re-rolled") and v["cam_max"] > 0.0
    far = {**a, "ate": 1.0}
    assert rounding.ulp_verdict(far, {**nudged, "ate": 1.2}, cmp)["verdict"] == "re-rolled"  # ATE 20% apart
