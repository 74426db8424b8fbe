"""The stereo-inertial path's checks that need no reference tracker run:

- (c) of test_torch_graph_step.py for its fused step: T and K traced in
  real mode at the port's first fused keyframe with visual-inertial BA and
  replayed on the fused frame after it (another n_kf and stamp), equal to
  eager bit for bit. Its frames are snapshots of the port's own CPU
  stereo-inertial tracker over test_torch_tracker_vi's scene and settings
  (test_torch_graph_step's `own_vi`, run again here: module fixtures are
  per file). The same step's (a), against the reference's `make_step_vi`,
  is test_torch_tracker_vi.py's `test_vi_segments_parity`, on that file's
  one reference run; its (b), the fake-mode trace, is in
  test_torch_graph_step.py.
- the host pieces that need no run: `_fiba_schedule` against the
  reference's, and the sensors the port builds with the IMU on.

They share a file because pytest-xdist 3.8's `--dist loadfile` starts the
files with the most tests first: alone, the replay (one to three minutes
under the whole suite) would start last and end the run (the verify
skill's budget rule).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_graph_step import check_replay_on_later_frame
from test_torch_graph_step import own_vi  # noqa: F401  (the fixture)
from test_torch_tracker_vi import _cams, _cfg, port_cfg

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu_torch.frontend.tracker import Tracker

torch.set_num_threads(1)


@pytest.mark.parametrize("step", ["vi"])
def test_replay_on_next_frame_equals_eager(own_vi, step):  # noqa: F811
    """(c) for the stereo-inertial step."""
    segs, first, later = own_vi
    check_replay_on_later_frame(segs, first, later, step)


def test_sensors_not_ported_raise():
    """No sensor of the reference is left unported: the inertial variants of
    mono and RGB-D build with the IMU on (tests/test_torch_mono_inertial.py,
    tests/test_torch_rgbd_inertial.py), their visual ones without it; a
    sensor the reference does not know is a ValueError."""
    _, tcam = _cams()
    for sensor in ("mono_imu", "rgbd_imu"):
        tr = Tracker(tcam, dataclasses.replace(port_cfg(_cfg(5)), sensor=sensor), "cpu")
        assert tr.use_imu and (tr.is_mono, tr.is_rgbd) == (sensor == "mono_imu", sensor == "rgbd_imu")
    for sensor in ("mono", "rgbd"):
        assert not Tracker(tcam, dataclasses.replace(port_cfg(_cfg(5)), sensor=sensor), "cpu").use_imu
    with pytest.raises(ValueError, match="sensor"):
        Tracker(tcam, dataclasses.replace(port_cfg(_cfg(5)), sensor="lidar"), "cpu")


@pytest.mark.parametrize("n_kf", [2, 3, 8, 9, 20, 32, 33, 70])
def test_fiba_schedule_equal(n_kf):
    cfg = _cfg(5)
    jcam, tcam = _cams()
    jt, tt = jtr.Tracker(jcam, cfg), Tracker(tcam, port_cfg(cfg), "cpu")
    assert tt._fiba_schedule() == []  # no gravity yet
    jt.n_kf = tt.n_kf = n_kf
    jt.gravity_w, tt.gravity_w = jnp.asarray([0.0, 0.0, -9.81]), torch.tensor([0.0, 0.0, -9.81])
    sj, st_ = jt._fiba_schedule(), tt._fiba_schedule()
    assert len(st_) == len(sj)
    for (wj, fj), (wt, ft) in zip(sj, st_):
        np.testing.assert_array_equal(wt, wj)
        np.testing.assert_array_equal(ft, fj)
    if n_kf < 3:
        assert st_ == []
    elif n_kf <= 32:
        assert len(st_) == 1 and len(st_[0][0]) == next(c for c in (8, 16, 32) if c >= n_kf)
    else:
        assert len(st_) >= 4 and all(len(w) == 32 for w, _ in st_)  # two passes of overlapping windows
        assert set(np.concatenate([w for w, _ in st_])) == set(range(n_kf))
