"""The port's dataset loaders against the reference's, field by field, on
folders written here (mirrors tests/test_datasets.py's loader tests and
tests/test_tbc.py's YAML parse).

Every fixture is written by the test: the reference's own KITTI / TUM
fixtures (pillow PNGs) and, through `utils.dataset_writers`, EuRoC, TUM
and KITTI folders of rendered frames. Images, stamps, IMU slices, ground
truth, calibration and associations must be exactly equal between the
packages. Also held: the renderer's bits (`utils.synthetic.frame_digest`
of chip_smoke.py's phase 4 first pair, which chip_smoke.py checks on the
card), and the writers' output read back.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image

from pli_slam_tpu.utils import config as jcfg
from pli_slam_tpu.utils import datasets as jds
from pli_slam_tpu.utils import euroc as jeu
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.utils import config as tcfg
from pli_slam_tpu_torch.utils import dataset_writers as dw
from pli_slam_tpu_torch.utils import datasets as tds
from pli_slam_tpu_torch.utils import euroc as teu
from pli_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)
CAM = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
TRAJ = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def _same_frames(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        assert fa.keys() == fb.keys()
        for k in fa:
            va, vb = np.asarray(fa[k]), np.asarray(fb[k])
            assert va.dtype == vb.dtype and va.shape == vb.shape, k
            np.testing.assert_array_equal(va, vb, err_msg=k)


@pytest.fixture(scope="module")
def room():
    return list(synthetic.make_sequence(CAM, 6, "cpu", fps=20.0, traj=TRAJ, room_half=2.55, with_depth=True,
                                        imu_noise=synthetic.ImuNoiseModel.euroc()))


@pytest.fixture
def kitti_dir(tmp_path):
    """tests/test_datasets.py's KITTI fixture."""
    root = tmp_path / "seq00"
    (root / "image_0").mkdir(parents=True)
    (root / "image_1").mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        img = rng.integers(0, 255, (60, 200), dtype=np.uint8)
        Image.fromarray(img).save(root / "image_0" / f"{i:06d}.png")
        Image.fromarray(img).save(root / "image_1" / f"{i:06d}.png")
    (root / "times.txt").write_text("0.0\n0.1\n0.2\n")
    (root / "calib.txt").write_text("P0: 700 0 100 0 0 700 30 0 0 0 1 0\nP1: 700 0 100 -378.0 0 700 30 0 0 0 1 0\n"
                                    "P2: " + " ".join(["0"] * 12) + "\n")
    poses = np.zeros((3, 12))
    poses[:, 0] = poses[:, 5] = poses[:, 10] = 1.0
    poses[:, 3] = [0.0, 0.5, 1.0]
    np.savetxt(root / "poses.txt", poses)
    return str(root)


def _kitti_equal(path, poses=None):
    js, ts = jds.KittiSequence(path, poses), tds.KittiSequence(path, poses)
    assert len(js) == len(ts)
    np.testing.assert_array_equal(js.stamps, ts.stamps)
    _same_frames(js.frames(), ts.frames())
    assert dataclasses.asdict(js.calib) == dataclasses.asdict(ts.calib)
    stamps = list(ts.stamps)
    np.testing.assert_array_equal(js.gt_positions_at(stamps), ts.gt_positions_at(stamps))
    return ts


def test_kitti_loader(kitti_dir):
    ts = _kitti_equal(kitti_dir)
    assert ts.calib.fx == 700.0 and abs(ts.calib.bf - 378.0) < 1e-6
    assert ts.calib.width == 200 and ts.calib.height == 60


@pytest.fixture
def tum_dir(tmp_path):
    """tests/test_datasets.py's TUM fixture: RGB, 16-bit depth 4 ms after its image."""
    root = tmp_path / "fr3_seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rng = np.random.default_rng(1)
    rgb_lines, depth_lines = [], []
    for i in range(3):
        t = 100.0 + i * 0.033
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(root / "rgb" / f"{t:.4f}.png")
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.png")
        td = t + 0.004
        depth = (rng.uniform(0.5, 4.0, (48, 64)) * 5000).astype(np.uint16)
        Image.fromarray(depth).save(root / "depth" / f"{td:.4f}.png")
        depth_lines.append(f"{td:.4f} depth/{td:.4f}.png")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb_lines) + "\n")
    (root / "depth.txt").write_text("# depth\n" + "\n".join(depth_lines) + "\n")
    (root / "groundtruth.txt").write_text(
        "# gt\n" + "\n".join(f"{100.0 + i * 0.033:.4f} {i * 0.1} 0 0 0 0 0 1" for i in range(3)))
    return str(root)


def _tum_equal(path, n=3):
    js, ts = jds.TumRgbdSequence(path, jds.TumCalib.freiburg(n)), tds.TumRgbdSequence(path, tds.TumCalib.freiburg(n))
    assert js.assoc == ts.assoc
    assert dataclasses.asdict(js.calib) == dataclasses.asdict(ts.calib)
    _same_frames(js.frames(), ts.frames())
    stamps = [a[0] for a in ts.assoc]
    np.testing.assert_array_equal(js.gt_positions_at(stamps), ts.gt_positions_at(stamps))
    return ts


def test_tum_loader(tum_dir):
    ts = _tum_equal(tum_dir)
    assert len(ts) == 3
    frames = list(ts.frames())
    assert frames[0]["img"].shape == (48, 64) and 0.3 < frames[0]["depth"].mean() < 5.0


def test_tum_calibrations_and_associations_file(tum_dir):
    for n in (1, 2, 3):
        assert dataclasses.asdict(jds.TumCalib.freiburg(n)) == dataclasses.asdict(tds.TumCalib.freiburg(n))
    with open(f"{tum_dir}/associations.txt", "w") as f:
        f.write("# pre-built\n100.0000 rgb/100.0000.png 100.0040 depth/100.0040.png\n")
    assert len(_tum_equal(tum_dir, 1)) == 1


@pytest.mark.parametrize("max_dt", [0.02, 0.004, 0.5])
def test_associate(max_dt):
    rgb = [(1.0, "a"), (2.0, "b"), (2.1, "c"), (3.0, "d")]
    depth = [(1.005, "da"), (2.06, "db"), (2.5, "dc"), (3.001, "dd")]
    assert tds.associate(rgb, depth, max_dt) == jds.associate(rgb, depth, max_dt)
    out = tds.associate(rgb[:2], [(1.005, "da"), (2.5, "db")], max_dt=0.02)
    assert len(out) == 1 and out[0][1] == "a"


def test_euroc_loader(tmp_path, room):
    """An ASL folder of the rendered room (all five PNG filters, 200 Hz IMU,
    ground truth): frames, IMU slices (prev, t] and interpolated ground truth
    equal the reference's; the native prefetcher's stream equals frames()."""
    root = str(tmp_path / "MH_tiny")
    stamps = dw.write_euroc(root, room, 20.0, filter_type=None)
    js, ts = jeu.EurocSequence(root), teu.EurocSequence(root)
    assert js.stamps == ts.stamps == stamps
    np.testing.assert_array_equal(js.imu, ts.imu)
    np.testing.assert_array_equal(js.gt, ts.gt)
    _same_frames(js.frames(), ts.frames())
    _same_frames(ts.frames(1, 5), ts.frames_native(1, 5, n_workers=2))
    q = [s * 1e-9 + 0.013 for s in stamps[:-1]]
    np.testing.assert_array_equal(js.gt_positions_at(q), ts.gt_positions_at(q))
    for k, fr in enumerate(ts.frames()):  # the written samples come back, frame by frame
        np.testing.assert_array_equal(fr["img_l"], dw.to_uint8(room[k]["img_l"]).astype(np.float32))
        if k:
            np.testing.assert_array_equal(fr["imu_gyro"], room[k]["imu_gyro"])
            np.testing.assert_array_equal(fr["imu_acc"], room[k]["imu_acc"])
            np.testing.assert_allclose(fr["imu_stamps"], room[k]["imu_stamps"], atol=1e-6)
    assert dataclasses.asdict(jeu.EurocCalib()) == dataclasses.asdict(teu.EurocCalib())


def test_written_tum_and_kitti_folders(tmp_path, room):
    """`write_tum` / `write_kitti` layouts read by both packages alike."""
    stamps = dw.write_tum(str(tmp_path / "tum"), room, 30.0)
    ts = _tum_equal(str(tmp_path / "tum"))
    assert len(ts) == len(room) and [a[0] for a in ts.assoc] == stamps
    dw.write_kitti(str(tmp_path / "kitti"), room, 10.0, CAM.fx, CAM.fy, CAM.cx, CAM.cy, 0.11)
    ts = _kitti_equal(str(tmp_path / "kitti"))
    assert abs(ts.calib.bf - 0.11 * 120.0) < 1e-9
    gt = ts.gt_positions_at(list(ts.stamps))
    R0, p0 = room[0]["R_wc"].astype(np.float64), room[0]["p_w"].astype(np.float64)
    np.testing.assert_allclose(gt, (np.stack([f["p_w"] for f in room]) - p0) @ R0, atol=1e-6)


def test_yaml_parse(tmp_path):
    """A written EuRoC YAML (and tests/test_tbc.py's Tbc node) loads into the
    same configuration, camera and rectification in both packages."""
    T = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
                  [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
                  [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
                  [0.0, 0.0, 0.0, 1.0]])
    path = str(tmp_path / "cam.yaml")
    dw.write_euroc_yaml(path, CAM, tcfg.SlamConfig.euroc_stereo_inertial(), Tbc=T)
    jc, jcam, jrect = jcfg.load_yaml_full(path)
    tc, tcam, trect = tcfg.load_yaml_full(path)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jrect is None and trect is None
    for f in ("fx", "fy", "cx", "cy", "bf", "width", "height"):
        assert float(getattr(jcam, f)) == float(getattr(tcam, f)) == float(getattr(CAM, f))
    np.testing.assert_allclose(np.asarray(tc.imu.Tbc).reshape(4, 4), T, atol=1e-12)
    assert tcfg.parse_yaml_matrices(path) == jcfg.parse_yaml_matrices(path)


def test_renderer_digest():
    """chip_smoke.py's phase 4 first stereo pair, rendered on this host: the
    card renders on its host too and must print the same digest."""
    import chip_smoke
    from pli_slam_tpu_torch.utils.profile import slice_camera, slice_config

    fr = next(iter(synthetic.make_sequence(slice_camera(), 1, "cpu", fps=slice_config().fps)))
    assert synthetic.frame_digest(fr["img_l"], fr["img_r"]) == chip_smoke.FRAME0_SHA256
