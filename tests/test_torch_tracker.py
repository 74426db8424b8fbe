"""The port's `Tracker` end to end against the reference's `Tracker`.

Both trackers see the same rendered stereo images (the reference's
renderer) and run the stereo visual path: `_initialize` on frame 0, the
fused step afterwards. The reference takes its accelerator branch (as in
test_torch_step: `jax.default_backend` patched, Pallas in interpret mode,
store capacities a multiple of its 2048-row tile), which the port follows
on every device.

Each package builds its own frames, so the few line segments whose order
differs between XLA's fused arithmetic and torch (test_torch_frame) and
the float32 BA (test_torch_step) make the two runs drift apart slowly.
Per frame the tracking state and keyframe count must be equal and the
inlier and landmark counts within 10%; trajectory bounds are in
`test_trajectory`.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
N_FRAMES = 8
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def _cfg(base):
    return dataclasses.replace(base, loop=LoopConfig(enabled=False),
                               map=dataclasses.replace(base.map, max_points=2048, local_map_points=2048))


def _run_both(cfg, jcam, n_frames, room_half):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    try:
        tcam = convert.camera(jax.tree_util.tree_map(np.asarray, jcam))
        jt = jtr.Tracker(jcam, cfg)
        tt = Tracker(tcam, convert.config_from_reference(dataclasses.asdict(cfg)), "cpu")
        infos, gt = [], []
        for fr in jsyn.make_sequence(jcam, n_frames, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=room_half):
            il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
            infos.append((jt.process(il, ir, fr["t"]), tt.process(il, ir, fr["t"])))
            gt.append(fr["p_w"])
        jt.finalize()
        tt.finalize()
        return jt, tt, infos, np.stack(gt)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def run():
    cfg = _cfg(SlamConfig.tiny_test())
    jcam = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    return _run_both(cfg, jcam, N_FRAMES, 2.55)


def test_per_frame_state(run):
    jt, tt, infos, _ = run
    for k, (ji, ti) in enumerate(infos):
        assert ti["state"] == ji["state"] == TrackingState.OK, k
        assert ti["n_kf"] == ji["n_kf"], (k, ti, ji)
        for key in ("n_inliers", "n_points", "n_lines"):
            assert abs(ti[key] - ji[key]) <= 0.1 * max(ji[key], 10), (k, key, ti, ji)
    assert tt.n_kf == jt.n_kf >= 3


def test_trajectory(run):
    """Frames recorded relative to KF0 (the BA's fixed gauge) agree to
    1e-4 m. Later frames are composed with keyframe poses that windowed BA
    refined, and on this 128x96 camera (5 px of disparity at 2.5 m) BA is
    ill-conditioned in float32 (test_torch_step): there the packages may
    differ by the BA's own uncertainty, measured at up to 8 cm over this
    0.17 m path with each package 4-6 cm ATE from ground truth. So the
    bound there is a divergence guard: 0.1 m per frame, ATE within 3 cm."""
    jt, tt, infos, gt = run
    pj, pt = jt.positions(), tt.positions()
    assert pt.shape == pj.shape == gt.shape
    assert [s for s, _, _ in tt.trajectory] == [s for s, _, _ in jt.trajectory]
    on_kf0 = np.array([ji["n_kf"] == 1 for ji, _ in infos])
    assert on_kf0.sum() >= 3
    np.testing.assert_allclose(pt[on_kf0], pj[on_kf0], atol=1e-4)
    assert np.abs(pt - pj).max() < 0.1, np.abs(pt - pj).max()
    ate_t, ate_j = tsyn.ate_rmse(pt, gt), jsyn.ate_rmse(pj, gt)
    assert abs(ate_t - ate_j) < 0.03, (ate_t, ate_j)


def test_streaming_matches_blocking():
    """Lag-1 stats consumption changes when the host reads the stats, not
    what the device computes: same trajectory, stats one frame late."""
    cfg = convert.config_from_reference(dataclasses.asdict(
        dataclasses.replace(SlamConfig.tiny_test(), loop=LoopConfig(enabled=False))))
    cam = convert.camera(jax.tree_util.tree_map(
        np.asarray, JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)))
    frames = list(tsyn.make_sequence(cam, 6, "cpu", fps=cfg.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55))
    runs = []
    for streaming in (False, True):
        tr = Tracker(cam, cfg, "cpu")
        tr.streaming = streaming
        infos = [tr.process(f["img_l"], f["img_r"], f["t"]) for f in frames]
        runs.append((tr.positions(), infos))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    blocking, streamed = runs[0][1], runs[1][1]
    assert streamed[1]["n_kf"] == 0  # placeholder: the first fused frame's stats are not read yet
    assert streamed[2:] == blocking[1:-1]


def test_rare_paths_raise():
    """The slices that are not ported yet raise instead of carrying on."""
    tiny = SlamConfig.tiny_test()
    cam = convert.camera(jax.tree_util.tree_map(
        np.asarray, JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)))
    with pytest.raises(NotImplementedError, match="LoopCloser"):
        Tracker(cam, tiny, "cpu")
    with pytest.raises(NotImplementedError, match="sensor"):
        Tracker(cam, dataclasses.replace(tiny, sensor="stereo_imu", loop=LoopConfig(enabled=False)), "cpu")
    tr = Tracker(cam, dataclasses.replace(tiny, loop=LoopConfig(enabled=False)), "cpu")
    frames = list(tsyn.make_sequence(cam, 2, "cpu", fps=tiny.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55))
    tr.process(frames[0]["img_l"], frames[0]["img_r"], 1.0)
    with pytest.raises(NotImplementedError, match="reset_active_map"):
        tr.process(frames[1]["img_l"], frames[1]["img_r"], 0.5)
    with pytest.raises(NotImplementedError, match="_relocalize"):
        tr._relocalize(None)


@pytest.mark.slow
def test_euroc_size_matches_reference():
    """752x480, EuRoC operating point (1200 ORB x 8 levels, 256 lines),
    12 frames in bench.py's room (ROOM_HALF) along the small trajectory
    TRAJ of the tiny tests: keyframe count within one, ATE within 1 cm and
    both under 5 cm (measured: port 8.5 mm, reference 5.1 mm). The
    keyframe decision compares the inlier count with 0.75x the last
    keyframe's; on this sequence it sat within one inlier of that threshold
    at frame 6 (603 vs 604 of a 603.75 bound, each package building its own
    frames), so the count may differ by one."""
    cfg = _cfg(SlamConfig.euroc_stereo())
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_points=16384, local_map_points=4096))
    jcam = JCamera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
    jt, tt, infos, gt = _run_both(cfg, jcam, 12, jsyn.ROOM_HALF)
    assert all(ti["state"] == TrackingState.OK for _, ti in infos)
    assert abs(tt.n_kf - jt.n_kf) <= 1, (tt.n_kf, jt.n_kf)
    ate_t, ate_j = tsyn.ate_rmse(tt.positions(), gt), jsyn.ate_rmse(jt.positions(), gt)
    assert abs(ate_t - ate_j) < 0.01 and max(ate_t, ate_j) < 0.05, (ate_t, ate_j)
