"""The port's RGB-D-inertial path (`sensor="rgbd_imu"`, `Tracker.process_rgbd(...,
imu=)`) against the reference's: every frame is host-orchestrated in both
(the reference runs no fused step for RGB-D with an IMU), so each frame of
a reference run is replayed by the port from the reference's state, and
the IMU initialization runs in lockstep (test_torch_mono_inertial's
`replay_reference`). `System("rgbd_imu")` is refused by both packages.

Scene and settings: tests/test_torch_tracker_vi.py's (SlamConfig.tiny_test(),
the 128x96 camera with its rendered depth, IMU initialization after 1.0 s
and 5 keyframes, 16-sample batches at 20 fps, ideal IMU), so the IMU
initializes at frame 20; 26 frames. The reference takes its accelerator
branch (Pallas in interpret mode, store capacities a multiple of 2048).

Tolerances, test_torch_tracker_vi's host-path lockstep: decisions,
counters and the IMU bookkeeping exact; poses 1e-4 on frames without a
keyframe, 0.2 where a keyframe ran windowed BA (float32 BA on a 128x96
map), the keyframes moved by the initialization's full inertial BA 0.2,
gravity 0.1 there; the initialization's inertial-only MAP estimate (fixed
scale) from identical state as test_torch_inertial (gravity 0.02 degrees,
biases 1e-4, velocities 1e-3 m/s).
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_mono_inertial import (JC, TC, TRAJ, _accelerator_branch, check_init_lockstep, check_replays,
                                      port_cfg, replay_reference)

from pli_slam_tpu.system import System as JSystem
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.system import System
from pli_slam_tpu_torch.utils import synthetic as tsyn
from pli_slam_tpu_torch.utils.profile import imu_batch

torch.set_num_threads(1)
N_FRAMES = 26
INIT_FRAME = 20


def _cfg():
    base = SlamConfig.tiny_test().replace(sensor="rgbd_imu")
    return dataclasses.replace(
        base, loop=LoopConfig(enabled=False),
        map=dataclasses.replace(base.map, max_points=2048, local_map_points=2048),
        imu=dataclasses.replace(base.imu, init_time_sec=1.0, max_samples_per_frame=16, init_min_kfs=5))


@pytest.fixture(scope="module")
def ri_run():
    mp = _accelerator_branch()
    try:
        cfg = _cfg()
        frames = list(jsyn.make_sequence(JC, N_FRAMES, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55,
                                         with_depth=True))
        yield (cfg,) + replay_reference(cfg, JC, TC, frames, "rgbd")
    finally:
        mp.undo()


def test_replay_every_frame(ri_run):
    """The map's initialization, host-path tracking and keyframes, the IMU
    initialization at frame 20 and inertial tracking after it, each frame
    replayed by the port from the reference's state through
    `process_rgbd(..., imu=)`."""
    _, jt, replays, _ = ri_run
    ready = [r["imu_ready"] for r, _ in replays]
    assert ready.index(True) == INIT_FRAME
    assert all(r["info"]["state"] == TrackingState.OK for r, _ in replays)
    assert check_replays(replays, init_kf_tol=0.2) >= 5
    assert not hasattr(jt, "_vi_fused_active") or not jt._vi_fused_active


def test_try_imu_init_lockstep(ri_run):
    """`_try_imu_init` with the scale fixed (RGB-D has metric depth), from
    the reference's state at each of its calls."""
    inits = ri_run[3]
    check_init_lockstep(inits)
    assert inits[-1]["log_t"]["scale"] == inits[-1]["log_j"]["scale"] == 1.0


def test_rgbd_imu_never_runs_a_fused_step():
    """With an IMU every RGB-D frame takes the host path, as in the
    reference: the tracker builds no fused stereo-inertial step for it, and
    after the map's initialization a frame does not enter the fused visual
    step either."""
    cfg = port_cfg(_cfg())
    tr = Tracker(TC, cfg, "cpu")
    assert tr.use_imu and tr.is_rgbd and hasattr(tr, "_step_vi")  # built as in the reference, never called
    tr._step = tr._step_vi = None  # a fused step would now fail
    for fr in tsyn.make_sequence(TC, 3, "cpu", traj=tsyn.Trajectory(**TRAJ), room_half=2.55, with_depth=True):
        info = tr.process_rgbd(fr["img_l"], fr["depth"], fr["t"],
                               imu=imu_batch(fr))
        assert info["state"] == TrackingState.OK
    assert tr.n_kf >= 1 and tr._first_imu_stamp is not None


def test_system_refuses_rgbd_imu_in_both():
    """`System` takes the reference's sensors: rgbd_imu is a ValueError in
    both packages (the Tracker runs it)."""
    cfg = _cfg()
    with pytest.raises(ValueError, match="unknown sensor"):
        JSystem(JC, cfg)
    with pytest.raises(ValueError, match="unknown sensor"):
        System(TC, port_cfg(cfg), device="cpu")
    assert System.SENSORS == JSystem.SENSORS


@pytest.mark.slow
def test_full_width_reference_run(capsys):
    """The reference alone at full width over phase 12's frames (run_tum.py's
    deployment with sensor "rgbd_imu" and slice_config_vi()'s IMU settings):
    the numbers chip_smoke.py's REF_RGBD_VI holds (tests/full_width_slice6.py;
    ~10 min on a CPU)."""
    import chip_smoke
    from full_width_slice6 import describe, run_reference

    r = run_reference("rgbd_vi")
    with capsys.disabled():
        print("\n" + describe(r))
    ref = chip_smoke.REF_RGBD_VI
    assert r["init_frame"] == ref["imu_init"]
    assert abs(r["ate_init"] - ref["ate_init"]) < 5e-4 and abs(r["ate"] - ref["ate"]) < 5e-4
