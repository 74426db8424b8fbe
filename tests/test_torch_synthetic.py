"""The port's synthetic renderer and ATE against the reference's.

The texture thresholds value noise built from sin() (speckle at 0.38 /
0.62, grid lines at 0.06 m), and XLA's and torch's float32 sin differ in
the last ulps, so a pixel whose noise sits within rounding of a
threshold can flip: at least 99.5% of pixels must agree within 1e-3 of
a grey level. The trajectory, poses and ATE are numpy in both packages
and must agree exactly.
"""

import numpy as np
import torch

from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)


def test_sequence_matches_reference():
    traj_j = jsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    traj_t = tsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    seq_j = jsyn.make_sequence(JCamera.pinhole(**ARGS), 3, fps=20.0, traj=traj_j, room_half=2.55)
    seq_t = tsyn.make_sequence(TCamera.pinhole(**ARGS), 3, "cpu", fps=20.0, traj=traj_t, room_half=2.55)
    for fj, ft in zip(seq_j, seq_t):
        assert fj["t"] == ft["t"]
        np.testing.assert_array_equal(ft["R_wc"], fj["R_wc"])
        np.testing.assert_array_equal(ft["p_w"], fj["p_w"])
        for side in ("img_l", "img_r"):
            a, b = ft[side].numpy(), np.asarray(fj[side])
            assert a.shape == b.shape and a.dtype == b.dtype
            assert (np.abs(a - b) <= 1e-3).mean() >= 0.995, side


def test_ate_matches_reference():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(40, 3))
    c, s = np.cos(0.3), np.sin(0.3)
    est = gt @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T + 0.5 + rng.normal(size=gt.shape) * 0.01
    assert tsyn.ate_rmse(est, gt) == jsyn.ate_rmse(est, gt)
    assert tsyn.ate_rmse(est, gt) < 0.03


def test_device_defaults_to_the_gpu_and_cpu_is_honoured():
    """`Tracker` and `make_sequence` take `device=None`, which means the GPU
    (and raises where there is none: no silent CPU fallback); "cpu" is
    honoured when asked for."""
    import dataclasses
    import inspect

    import pytest

    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils.config import LoopConfig, SlamConfig

    assert inspect.signature(Tracker.__init__).parameters["device"].default is None
    assert inspect.signature(tsyn.make_sequence).parameters["device"].default is None
    cam = TCamera.pinhole(**ARGS)
    cfg = dataclasses.replace(SlamConfig.tiny_test(), loop=LoopConfig(enabled=False))
    tr = Tracker(cam, cfg, "cpu")
    assert tr.device == torch.device("cpu")
    for t in (tr.R, tr.pstore.x, tr.kstore.R, tr.bow_db.valid, tr._pints.valid, tr.ext.R_cb, tr._local_pt):
        assert t.device.type == "cpu"
    fr = next(iter(tsyn.make_sequence(cam, 1, "cpu", room_half=2.55)))
    assert fr["img_l"].device.type == "cpu" and fr["imu_gyro"].shape == (10, 3)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):  # torch refuses: it was not built with CUDA / finds no GPU
            Tracker(cam, cfg)
        with pytest.raises((RuntimeError, AssertionError)):
            next(iter(tsyn.make_sequence(cam, 1, room_half=2.55)))
