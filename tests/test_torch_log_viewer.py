"""The port's logger, live feed and viewer (mirrors tests/test_log.py,
tests/test_viewer.py and the live-feed tests of tests/test_datasets.py).

Log and live feed are held against the reference's behaviour on the same
calls (levels, the CSV's bytes but the times, the synchronizer's pairing,
IMU coverage, draining and time-outs); the viewer must write PNGs from a
port tracker's state, and the map plot must read the same map as the
reference's from the same stores. The bounded image queue keeps the newest
frames and counts the dropped ones (a port addition).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from pli_slam_tpu.utils import livefeed as jlive
from pli_slam_tpu.utils import log as jlog
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.utils import livefeed, log, synthetic, viewer
from pli_slam_tpu_torch.utils.config import LoopConfig, SlamConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("mod", [log, jlog], ids=["port", "reference"])
def test_levels(capsys, mod):
    mod.set_level(mod.NORMAL)
    mod.log("visible", mod.NORMAL)
    mod.log("hidden", mod.DEBUG)
    err = capsys.readouterr().err
    assert "visible" in err and "hidden" not in err
    mod.set_level(mod.QUIET)
    mod.log("quiet-hidden", mod.NORMAL)
    assert "quiet-hidden" not in capsys.readouterr().err
    assert (log.QUIET, log.NORMAL, log.VERBOSE, log.VERY_VERBOSE, log.DEBUG) == (
        jlog.QUIET, jlog.NORMAL, jlog.VERBOSE, jlog.VERY_VERBOSE, jlog.DEBUG)


def test_stage_timer(tmp_path):
    """Same CSV layout as the reference's; on the CPU (device given or not)
    it records host time only."""
    for device in (None, "cpu"):
        t, jt = log.StageTimer(["a", "b"], device=device), jlog.StageTimer(["a", "b"])
        assert t.device is None
        for timer in (t, jt):
            for _ in range(3):
                with timer.stage("a"):
                    time.sleep(0.001)
                with timer.stage("b"):
                    pass
                timer.end_frame()
        assert t.means_ms()["a"] >= 1.0 and t.means_ms()["b"] >= 0.0
        p, jp = tmp_path / "times.csv", tmp_path / "jtimes.csv"
        t.save_csv(str(p))
        jt.save_csv(str(jp))
        lines, jlines = p.read_text().strip().splitlines(), jp.read_text().strip().splitlines()
        assert lines[0] == jlines[0] == "frame,a,b" and len(lines) == len(jlines) == 4
        assert [r.split(",")[0] for r in lines] == [r.split(",")[0] for r in jlines]


def _pair_and_wait(mod):
    sync = mod.StereoInertialSync(use_imu=True)
    sync.left.push(0.90, "L_stale")  # no right partner: dropped
    sync.left.push(1.00, "L1")
    sync.right.push(1.002, "R1")  # within the skew
    for k in range(4):
        sync.imu.push(0.96 + 0.01 * k, [0, 0, k], [0, 0, 9.8])
    blocked = sync.next_frame(timeout=0.1)  # the IMU (0.99) does not reach the frame (1.00)
    sync.imu.push(1.01, [0, 0, 9], [0, 0, 9.8])
    return blocked, sync.next_frame(timeout=2.0), sync


def test_livefeed_sync_pairs_and_waits_for_imu():
    (blocked, item, sync), (jblocked, jitem, _) = _pair_and_wait(livefeed), _pair_and_wait(jlive)
    assert blocked is None and jblocked is None
    assert item["img_l"] == jitem["img_l"] == "L1" and item["img_r"] == jitem["img_r"] == "R1"
    assert item["t"] == jitem["t"] == 1.0
    for k in ("stamps", "gyro", "acc"):
        np.testing.assert_array_equal(item["imu"][k], jitem["imu"][k])
    assert len(item["imu"]["stamps"]) == 4 and np.all(item["imu"]["stamps"] <= 1.0)
    assert sync.imu.latest_stamp() > 1.0


def test_livefeed_sync_no_imu_mode():
    for mod in (livefeed, jlive):
        sync = mod.StereoInertialSync(use_imu=False)
        sync.left.push(2.0, "L")
        sync.right.push(2.0, "R")
        item = sync.next_frame(timeout=0.5)
        assert item is not None and item["imu"] is None


def test_livefeed_timeout_and_stop():
    for mod in (livefeed, jlive):
        sync = mod.StereoInertialSync()
        assert sync.next_frame(timeout=0.05) is None
        sync.stop()
        assert sync.next_frame(timeout=5.0) is None


def test_image_queue_keeps_the_newest():
    grab, jgrab = livefeed.ImageGrabber(maxlen=3), jlive.ImageGrabber(maxlen=3)
    for k in range(7):
        grab.push(float(k), k)
        jgrab.push(float(k), k)
    assert list(grab.buf) == list(jgrab.buf) == [(4.0, 4), (5.0, 5), (6.0, 6)]
    assert (grab.pushed, grab.dropped) == (7, 4)


@pytest.fixture(scope="module")
def mini_tracker():
    cfg = dataclasses.replace(SlamConfig.tiny_test(), loop=LoopConfig(enabled=False))
    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    tr = Tracker(cam, cfg, "cpu")
    last = None
    for fr in synthetic.make_sequence(cam, 6, "cpu", fps=cfg.fps, traj=traj, room_half=2.55):
        tr.process(fr["img_l"], fr["img_r"], fr["t"])
        last = fr
    return tr, last


def _is_png(path) -> bool:
    return open(path, "rb").read(8)[1:4] == b"PNG"


def test_draw_map(mini_tracker, tmp_path):
    tr, _ = mini_tracker
    p = str(tmp_path / "map.png")
    viewer.draw_map(tr, p, loop_edges=[(0, tr.n_kf - 1)])
    assert _is_png(p)


def test_draw_frame(mini_tracker, tmp_path):
    tr, fr = mini_tracker
    fd = tr.build_frame(fr["img_l"], fr["img_r"])
    p = str(tmp_path / "frame.png")
    viewer.draw_frame(fr["img_l"], fd, p, pt_inliers=fd.feats.valid)
    assert _is_png(p)


def test_draw_trajectory_comparison(mini_tracker, tmp_path, rng):
    tr, _ = mini_tracker
    est = tr.positions()
    gt = est + rng.normal(size=est.shape) * 0.01
    p = str(tmp_path / "traj.png")
    viewer.draw_trajectory_comparison(est, gt, p, ate=0.01)
    assert _is_png(p)
