"""The profiling module's configuration and trace arithmetic (the profile
itself needs a GPU; see pli_slam_tpu_torch/utils/profile.py)."""

import dataclasses
import json

import pytest
import torch

from pli_slam_tpu_torch import SlamConfig
from pli_slam_tpu_torch.utils import profile

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
