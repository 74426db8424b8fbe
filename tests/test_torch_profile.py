"""The profiling module's configuration and trace arithmetic (the profile
itself needs a GPU; see pli_slam_tpu_torch/utils/profile.py), and its
closure runners (chip_smoke.py's phases 6a and 14a) on the CPU at
test_torch_flagship.py's size and scene."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from test_torch_flagship import INIT_FRAME, PLANT_GAP, TC, TRAJ, _flagship_tiny_cfg, port_cfg

from pli_slam_tpu.utils.config import SlamConfig as JSlamConfig
from pli_slam_tpu_torch import SlamConfig
from pli_slam_tpu_torch.utils import profile
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)


def test_slice_config_is_euroc_at_published_widths_with_loop_off():
    cfg, ref = profile.slice_config(), SlamConfig.euroc_stereo()
    assert not cfg.loop.enabled and ref.loop.enabled
    assert dataclasses.replace(cfg, loop=ref.loop) == ref
    assert (cfg.orb.n_features, cfg.orb.n_levels, cfg.lines.n_lines) == (1200, 8, 256)
    m = cfg.map
    assert (m.max_points, m.max_lines, m.max_keyframes, m.local_map_points) == (16384, 4096, 512, 4096)
    cam = profile.slice_camera()
    assert (cam.width, cam.height, cam.fx) == (752, 480, pytest.approx(435.2))
    assert cam.bf == pytest.approx(0.11 * 435.2)


def test_rgbd_and_mono_configs_are_the_published_deployments():
    """chip_smoke.py's phase 7: scripts/run_tum.py's SlamConfig(sensor="rgbd",
    640x480, 30 fps) on TUM3's intrinsics, everything else at its default;
    phase 8: SlamConfig.euroc_stereo() with sensor "mono", loop closing on."""
    cfg = profile.rgbd_config()
    assert cfg == SlamConfig(sensor="rgbd", width=640, height=480, fps=30.0) and cfg.loop.enabled
    cam = profile.rgbd_camera()
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height) == pytest.approx(
        (535.4, 539.2, 320.1, 247.6, 40.0, 640, 480))
    mono = profile.mono_config()
    assert mono == dataclasses.replace(SlamConfig.euroc_stereo(), sensor="mono") and mono.loop.enabled


@pytest.mark.parametrize("intervals, total", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (5.0, 1.0)], 3.0),            # disjoint
    ([(0.0, 4.0), (1.0, 1.0)], 4.0),            # nested
    ([(3.0, 4.0), (0.0, 4.0)], 7.0),            # overlapping, out of order
    ([(0.0, 1.0), (1.0, 1.0), (2.0, 0.5)], 2.5),  # touching
])
def test_union_us(intervals, total):
    assert profile.union_us(intervals) == pytest.approx(total)


def test_trace_busy_counts_device_activity_and_launches(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k0", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 12.0, "dur": 5.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30.0, "dur": 2.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 9.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 11.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 29.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "ts": 40.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 50.0, "dur": 1.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 9.5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, n_dev, launches, graph_launches = profile.trace_busy(str(path))
    assert busy == pytest.approx(9.0)
    assert (n_dev, launches, graph_launches) == (3, 3, 1)


def test_main_refuses_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        profile.main(["--out", str(tmp_path)])


def test_inertial_loop_run_tiny():
    """`utils.profile.inertial_loop_run` (chip_smoke.py's phase 14a) on the
    CPU at the test's size: the IMU initializes, the planted closure verifies
    with it, queues only "fiba" chunks, keeps every keyframe's gravity
    direction, and the queue drains."""
    cfg = _flagship_tiny_cfg()
    traj = tsyn.Trajectory(**TRAJ)
    frames = list(tsyn.make_sequence(TC, INIT_FRAME + 10, "cpu", fps=cfg.fps, traj=traj, room_half=2.55,
                                     imu_noise=tsyn.ImuNoiseModel.euroc()))
    for fr in frames:
        fr["imu"] = profile.imu_batch(fr)
    r = profile.inertial_loop_run(cfg, TC, traj, frames, "cpu", n_before=3, n_after=3, min_gap=PLANT_GAP)
    tr, p = r["tracker"], r["planted"]
    assert r["init"]["frame"] == INIT_FRAME and r["init"]["record"]["accepted"]
    assert r["natural"] == 0 and p["closed"] and p["imu_ready"] and set(p["queued"]) == {"fiba"}
    assert p["gravity_deg"] < 1e-3 and p["z_deg"] < 1e-3 and p["kf_after"] < p["kf_before"] + 0.05
    assert p["gravity_excess_deg"] < 1e-3 and p["gravity_pred_deg"] < 1e-3
    assert len(r["t_fiba"]) == len(p["queued"]) and not tr._deferred_ba
    assert r["n_frames"] == INIT_FRAME + 3 + 1 + 3 and np.all(np.isfinite(r["est"]))
    assert r["est"].shape == (r["n_frames"], 3) and r["ate"] < 0.2


def test_loop_run_tiny(monkeypatch):
    """`utils.profile.loop_run` (chip_smoke.py's phase 6a, which shares
    `_ClosureRun` with phase 14a's runner) on the CPU at the test's size,
    visual, loop closing on with the planted pair PLANT_GAP keyframes
    apart, 24 frames before the plant: the planted closure verifies, queues
    "gba" chunks, and the remaining frames and the drain run them all."""
    monkeypatch.setattr(profile, "N_FRAMES_LOOP", 24)
    base = port_cfg(JSlamConfig.tiny_test())  # the reference's, as test_torch_flagship builds its own
    cfg = dataclasses.replace(base, loop=dataclasses.replace(base.loop, min_kf_gap=PLANT_GAP))
    traj = tsyn.Trajectory(**TRAJ)
    frames = list(tsyn.make_sequence(TC, 30, "cpu", fps=cfg.fps, traj=traj, room_half=2.55))
    r = profile.loop_run(cfg, TC, traj, frames, "cpu")
    tr, p = r["tracker"], r["planted"]
    assert r["natural"] == 0 and p["closed"] and p["kf_cur"] - p["kf_loop"] >= PLANT_GAP
    assert r["n_queued"] >= 1 and len(r["t_gba"]) == r["n_queued"] and not tr._deferred_ba
    assert len(r["kf_errs"]) == r["n_queued"] and len(r["t_loop"]) == 1 and r["loop_frames"] == []
    assert r["ate_run"] < 0.2 and r["est"].shape == (30, 3) and np.all(np.isfinite(r["est"])) and r["ate"] < 0.2
