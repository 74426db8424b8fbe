"""The port's front door against the reference's: `System`, the trajectory
files and metrics (utils.trajectory), and stereo rectification
(ops.rectify, `Tracker(..., rectifier=)`).

Tolerances, repeated in each test:
- rectification grids (numpy, float64 then float32) exactly equal;
  bilinear remap within 1e-4 grey levels (float32, the same arithmetic);
- trajectory files byte for byte equal between the packages; read back
  within the printed precision (1e-6 m, 1e-6 in the quaternion); the
  alignment and error metrics (numpy float64) within 1e-12;
- `System`: the API's behaviour as tests/test_system.py checks it (poses
  finite, files written, localization mode not growing the map, resets);
  map files interchangeable: a map written by either package loads into
  the other with every array equal (the int32 incidence bitsets through a
  uint32 view) and the same names and dtypes in both files.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import rectify as jrect
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.system import System as JSystem
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils import trajectory as jtio
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend.frame import build_frame
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import rectify as trect
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.system import System
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn
from pli_slam_tpu_torch.utils import trajectory as ttio

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = JCamera.pinhole(**CAM_ARGS), TCamera.pinhole(**CAM_ARGS)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


def _frames(n, with_depth=False):
    return list(tsyn.make_sequence(TC, n, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ), room_half=2.55,
                                   with_depth=with_depth))


# ---------------------------------------------------------------------------
# Rectification
# ---------------------------------------------------------------------------


def _tiny_kdrp():
    """A 128x96 rig with EuRoC-like distortion and rectifying rotations."""
    c = jrect.EUROC_KDRP
    K = np.array([[120.0, 0.0, 64.3], [0.0, 119.5, 47.6], [0.0, 0.0, 1.0]])
    P = np.array([[115.0, 0.0, 64.0, 0.0], [0.0, 115.0, 48.0, 0.0], [0.0, 0.0, 1.0, 0.0]])
    P_r = P.copy()
    P_r[0, 3] = -115.0 * 0.11
    return (K, c["D_l"], c["R_l"], P, K, c["D_r"], c["R_r"], P_r, 128, 96)


def test_rectify_maps_and_remap_parity():
    """`radtan_distort` and `build_rectify_map` (numpy in both) exactly
    equal at EuRoC's 752x480; `remap_bilinear` within 1e-4 on a random
    image, including source coordinates past every border (clamped)."""
    c = jrect.EUROC_KDRP
    for side in ("l", "r"):
        args = (c[f"K_{side}"], c[f"D_{side}"], c[f"R_{side}"], c[f"P_{side}"], 752, 480)
        for a, b in zip(trect.build_rectify_map(*args), jrect.build_rectify_map(*args)):
            np.testing.assert_array_equal(a, b)
    x, y = np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-0.7, 0.7, 7))
    for a, b in zip(trect.radtan_distort(x, y, c["D_l"]), jrect.radtan_distort(x, y, c["D_l"])):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (96, 128)).astype(np.float32)
    mx = rng.uniform(-5, 133, (96, 128)).astype(np.float32)
    my = rng.uniform(-5, 101, (96, 128)).astype(np.float32)
    out_t = trect.remap_bilinear(T(img), T(mx), T(my)).numpy()
    out_j = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    np.testing.assert_allclose(out_t, out_j, atol=1e-4)


def test_euroc_rectifier_parity():
    """`euroc_rectifier()` on a 752x480 pair (the device named, as every
    entry point of the port wants): grids equal to the reference's, the
    rectified pair within 1e-4 grey levels."""
    rng = np.random.default_rng(1)
    img_l, img_r = (rng.uniform(0, 255, (480, 752)).astype(np.float32) for _ in range(2))
    rt, rj = trect.euroc_rectifier("cpu"), jrect.euroc_rectifier()
    for name in ("map_x_l", "map_y_l", "map_x_r", "map_y_r"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)))
    for a, b in zip(rt(T(img_l), T(img_r)), rj(jnp.asarray(img_l), jnp.asarray(img_r))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_tracker_rectifies_raw_pairs():
    """`Tracker(..., rectifier=)`: raw pairs are rectified inside the frame
    build, on the host path (the first frame) and in the fused step alike:
    a tracker fed raw pairs gives exactly what a plain tracker fed the
    pairs rectified beforehand gives."""
    cfg = port_cfg(SlamConfig.tiny_test())
    rect = trect.StereoRectifier.from_kdrp(*_tiny_kdrp(), device="cpu")
    frames = _frames(4)
    with_rect = Tracker(TC, cfg, "cpu", rectifier=rect)
    plain = Tracker(TC, cfg, "cpu")
    for fr in frames:
        a = with_rect.process(fr["img_l"], fr["img_r"], fr["t"])
        b = plain.process(*rect(fr["img_l"], fr["img_r"]), fr["t"])
        assert a == b
    np.testing.assert_array_equal(with_rect.positions(), plain.positions())
    assert with_rect.n_kf >= 1 and with_rect.state == TrackingState.OK
    fr = frames[0]
    f_rect = with_rect.build_frame(fr["img_l"], fr["img_r"])
    f_ref = build_frame(TC, cfg, *rect(fr["img_l"], fr["img_r"]))
    assert torch.equal(f_rect.feats.uv, f_ref.feats.uv) and torch.equal(f_rect.depth, f_ref.depth)


# ---------------------------------------------------------------------------
# Trajectory files and metrics
# ---------------------------------------------------------------------------


def _trajectory(rng, n=12):
    traj = tsyn.Trajectory(**TRAJ)
    out = []
    for k in range(n):
        R, p = traj.pose(0.05 * k + 1e-3 * rng.random())
        out.append((1.5 + 0.05 * k, R.astype(np.float32), p.astype(np.float32)))
    return out


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_trajectory_files_parity(tmp_path, fmt):
    """Each saver writes the reference's bytes; each loader reads the file
    back (both packages' loaders agree within 1e-6)."""
    traj = _trajectory(np.random.default_rng(2))
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    getattr(ttio, f"save_{fmt}")(pt, traj)
    getattr(jtio, f"save_{fmt}")(pj, traj)
    assert open(pt).read() == open(pj).read()
    back_t, back_j = getattr(ttio, f"load_{fmt}")(pt), getattr(jtio, f"load_{fmt}")(pj)
    assert len(back_t) == len(back_j) == len(traj)
    for (st, Rt, ptt), (sj, Rj, pjj), (s0, R0, p0) in zip(back_t, back_j, traj):
        assert st == pytest.approx(sj, abs=1e-9)
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        np.testing.assert_allclose(ptt, pjj, atol=1e-6)
        np.testing.assert_allclose(Rt, R0, atol=1e-5)
        np.testing.assert_allclose(ptt, p0, atol=1e-6)


def test_trajectory_metrics_parity():
    """`align_umeyama` with and without scale, `ate_rmse`, `rpe_rmse`:
    numpy in both packages, equal within 1e-12."""
    rng = np.random.default_rng(4)
    traj = _trajectory(rng, 20)
    gt = np.stack([p for _, _, p in traj]).astype(np.float64)
    est = 1.7 * gt @ np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]).T + 0.3
    est = est + rng.normal(size=est.shape) * 0.01
    for with_scale in (False, True):
        for a, b in zip(ttio.align_umeyama(est, gt, with_scale), jtio.align_umeyama(est, gt, with_scale)):
            np.testing.assert_allclose(a, b, atol=1e-12)
        assert ttio.ate_rmse(est, gt, with_scale) == pytest.approx(jtio.ate_rmse(est, gt, with_scale), abs=1e-12)
    assert ttio.ate_rmse(est, gt, True) < 0.05 < ttio.ate_rmse(est, gt, False)
    noisy = [(s, R @ np.eye(3), p + rng.normal(size=3) * 0.01) for s, R, p in traj]
    for delta in (1, 3):
        np.testing.assert_allclose(ttio.rpe_rmse(noisy, traj, delta), jtio.rpe_rmse(noisy, traj, delta), atol=1e-12)


# ---------------------------------------------------------------------------
# System
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stereo_system():
    """tests/test_system.py's short run: 14 stereo frames through the
    port's `System` on the CPU."""
    frames = _frames(15)
    sysm = System(TC, port_cfg(SlamConfig.tiny_test()), device="cpu")
    infos = [sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"]) for fr in frames[:14]]
    return sysm, frames, infos


def test_track_returns_pose(stereo_system):
    sysm, frames, infos = stereo_system
    assert all(i["state"] == TrackingState.OK for i in infos)
    info = sysm.track_stereo(frames[14]["img_l"], frames[14]["img_r"], frames[14]["t"])
    assert info["R_wc"].shape == (3, 3) and np.isfinite(info["p_w"]).all()
    np.testing.assert_allclose(info["R_wc"] @ info["R_wc"].T, np.eye(3), atol=1e-5)
    stats = sysm.timing_stats()
    assert stats["fps"] > 0 and stats["median_ms"] > 0


def test_savers_write_every_frame(stereo_system, tmp_path):
    """The three trajectory savers write one line per tracked frame, the
    keyframe savers one per keyframe; the IMU-init log its header (a visual
    system makes no attempt)."""
    sysm, _, _ = stereo_system
    n_frames, n_kf = len(sysm.tracker.trajectory), sysm.tracker.n_kf
    for fn, n in ((sysm.save_trajectory_tum, n_frames), (sysm.save_trajectory_euroc, n_frames),
                  (sysm.save_trajectory_kitti, n_frames), (sysm.save_keyframe_trajectory_tum, n_kf),
                  (sysm.save_keyframe_trajectory_euroc, n_kf), (sysm.save_keyframe_trajectory_kitti, n_kf)):
        p = str(tmp_path / f"{fn.__name__}.txt")
        fn(p)
        assert len(open(p).readlines()) == n, fn.__name__
    back = ttio.load_tum(str(tmp_path / "save_keyframe_trajectory_tum.txt"))
    ks = sysm.tracker.kstore
    np.testing.assert_allclose(back[-1][2], -(ks.R[n_kf - 1].T @ ks.t[n_kf - 1]).numpy(), atol=1e-6)
    p = str(tmp_path / "imu.csv")
    sysm.save_imu_init_log(p)
    assert open(p).read().startswith("n_kf,accepted,reason,scale")


def test_map_round_trip_and_localization_mode(stereo_system, tmp_path):
    """save_map / load_map into a new `System`: every store equal, the pose
    and keyframe count restored; in localization mode 5 frames are tracked
    and the map does not grow; `reset_active_map` empties it, `reset`
    starts a new tracker."""
    sysm, frames, _ = stereo_system
    p = str(tmp_path / "map.npz")
    sysm.save_map(p)
    sys2 = System(TC, sysm.cfg, device="cpu")
    sys2.load_map(p)
    for attr in ("pstore", "lstore", "kstore"):
        a, b = convert.to_numpy(getattr(sys2.tracker, attr)), convert.to_numpy(getattr(sysm.tracker, attr))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sys2.tracker.n_kf == sysm.tracker.n_kf and sys2.tracker.state == TrackingState.OK
    assert torch.equal(sys2.tracker.t, sysm.tracker.t)
    sys2.activate_localization_mode()
    n_pts, n_kf = int(sys2.tracker.pstore.valid.sum()), sys2.tracker.n_kf
    for k in range(10, 15):
        info = sys2.track_stereo(frames[k]["img_l"], frames[k]["img_r"], frames[k]["t"])
        assert info["state"] == TrackingState.OK and np.isfinite(info["p_w"]).all()
    assert int(sys2.tracker.pstore.valid.sum()) == n_pts and sys2.tracker.n_kf == n_kf
    sys2.reset_active_map()
    assert sys2.tracker.n_kf == 0 and int(sys2.tracker.pstore.valid.sum()) == 0
    tracker = sys2.tracker
    sys2.reset()
    assert sys2.tracker is not tracker and sys2.tracker.n_kf == 0 and sys2.timing_stats()["fps"] == 0.0
    sys2.shutdown()


def test_map_files_interchange_with_the_reference(stereo_system, tmp_path):
    """A map written by the port loads into the reference's `System` with
    every array equal (the bitsets as uint32 words), and one written by the
    reference (its own 6-frame run) loads into the port's the same way; the
    two files hold the same names and dtypes."""
    sysm, _, _ = stereo_system
    cfg = SlamConfig.tiny_test()
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    sysm.save_map(p_t)
    jsys = JSystem(JC, cfg)
    jsys.load_map(p_t)
    for attr in ("pstore", "lstore", "kstore"):
        a = convert.to_numpy(getattr(sysm.tracker, attr))
        b = convert.to_numpy(jax.tree_util.tree_map(np.asarray, getattr(jsys.tracker, attr)))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
    assert jsys.tracker.n_kf == sysm.tracker.n_kf

    jsys2 = JSystem(JC, cfg)
    for fr in jsyn.make_sequence(JC, 6, fps=20.0, traj=jsyn.Trajectory(**TRAJ), room_half=2.55):
        jsys2.track_stereo(np.asarray(fr["img_l"]), np.asarray(fr["img_r"]), fr["t"])
    jsys2.save_map(p_j)
    tsys = System(TC, port_cfg(cfg), device="cpu")
    tsys.load_map(p_j)
    for attr in ("pstore", "lstore", "kstore"):
        a = convert.to_numpy(getattr(tsys.tracker, attr))
        b = convert.to_numpy(jax.tree_util.tree_map(np.asarray, getattr(jsys2.tracker, attr)))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tsys.tracker.n_kf == jsys2.tracker.n_kf >= 1 and tsys.tracker.state == TrackingState.OK
    with np.load(p_t) as ft, np.load(p_j) as fj:
        assert sorted(ft.files) == sorted(fj.files)
        for k in ft.files:
            assert ft[k].dtype == fj[k].dtype and ft[k].shape == fj[k].shape, k
    assert os.path.getsize(p_t) > 0


def test_load_map_fills_missing_fields_from_the_live_store(stereo_system, tmp_path):
    """The reference's known defect, ported as it is: a field missing from
    the file keeps the live store's value (here the incidence bitsets)."""
    sysm, _, _ = stereo_system
    p = str(tmp_path / "map.npz")
    sysm.save_map(p)
    with np.load(p) as f:
        arrays = {k: f[k] for k in f.files if k != "pt_obs_bits"}
    np.savez(str(tmp_path / "old.npz"), **arrays)
    sys2 = System(TC, sysm.cfg, device="cpu")
    live = sys2.tracker.pstore.obs_bits
    sys2.load_map(str(tmp_path / "old.npz"))
    assert sys2.tracker.pstore.obs_bits is live
    assert torch.equal(sys2.tracker.pstore.x, sysm.tracker.pstore.x)


@pytest.mark.parametrize("sensor", ["rgbd", "mono", "stereo_imu"])
def test_other_sensors_through_system(sensor):
    """`track_rgbd`, `track_monocular` and `track_stereo` with IMU batches
    return a pose every frame: RGB-D tracks from its first frame, mono after
    its two-view initialization (every 3rd frame, as
    tests/test_mono_rgbd.py), stereo-inertial on its host path before the
    IMU initialization."""
    cfg = port_cfg(SlamConfig.tiny_test().replace(sensor=sensor))
    sysm = System(TC, cfg, device="cpu")
    if sensor == "stereo_imu":
        infos = [sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"], {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"],
                                                                       "stamps": fr["imu_stamps"]})
                 for fr in _frames(4)]
        assert all(i["state"] == TrackingState.OK for i in infos) and sysm.tracker.last_preint is not None
    elif sensor == "rgbd":
        infos = [sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"]) for fr in _frames(4, with_depth=True)]
        assert all(i["state"] == TrackingState.OK for i in infos)
    else:
        infos = [sysm.track_monocular(fr["img_l"], fr["t"]) for fr in _frames(30)[::3]]
        assert infos[0]["state"] == TrackingState.NOT_INITIALIZED and infos[-1]["state"] == TrackingState.OK
        assert sysm.tracker.n_kf >= 2
    assert all(i["R_wc"].shape == (3, 3) and np.isfinite(i["p_w"]).all() for i in infos)


def test_sensors_the_system_refuses():
    """`System` takes the reference's sensors: mono_imu is taken, rgbd_imu
    (which the Tracker runs) and an unknown sensor are ValueErrors, as in
    the reference."""
    assert System(TC, port_cfg(SlamConfig.tiny_test().replace(sensor="mono_imu")), device="cpu").tracker.use_imu
    with pytest.raises(ValueError, match="unknown sensor"):
        System(TC, port_cfg(SlamConfig.tiny_test().replace(sensor="rgbd_imu")), device="cpu")
    with pytest.raises(ValueError, match="unknown sensor"):
        System(TC, dataclasses.replace(port_cfg(SlamConfig.tiny_test()), sensor="lidar"), device="cpu")
