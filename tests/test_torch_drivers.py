"""The port's drivers end to end (`pli_slam_tpu_torch/scripts/`), on the CPU.

`run_euroc` against the reference's scripts/run_euroc.py on one written
128x96 ASL folder (stereo, 8 frames): both read the same PNGs, so both
track the same pixels. The YAML turns line features off (`has_lines: 0`):
on these 8-bit images the two packages' line detectors pick a few
different segments (test_torch_frame.py holds them to 90% of segments),
which at 128x96 moves the two trajectories centimetres apart from the
first frame with a differing set; with points only the drivers must agree
as the trackers do. A YAML has no keys for the map's capacities or the
tracking floors, so both packages' `load_yaml_full` are wrapped to put the
YAML's camera, ORB and IMU settings onto test_torch_tracker's tiny
configuration (loop closing off, stores of 2048 rows, which the
reference's accelerator branch needs); the reference runs that branch as
in test_torch_tracker.py. Tolerances as there: frames recorded against
keyframe 0 within 1e-4 m, ATE within 3 cm, keyframes within 10%.

Every other driver runs once with `--cpu` on a tiny fixture (tiny_test
settings where the driver builds its configuration itself) and must write
its outputs; without `--cpu` and without a GPU each exits with an error.
The `slow` test runs the reference's scripts/run_kitti.py at full width
on chip_smoke.py's phase 9c folder and prints the ATE that its guard is
set from.
"""

import dataclasses
import importlib.util
import json
import os
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.utils import config as jcfg
from pli_slam_tpu.utils import trajectory as jtio
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.scripts import (diag_ate, profile_stages, run_euroc, run_kitti, run_live, run_synthetic,
                                        run_tum, train_vocab)
from pli_slam_tpu_torch.utils import config as tcfg
from pli_slam_tpu_torch.utils import convert, synthetic
from pli_slam_tpu_torch.utils import dataset_writers as dw
from pli_slam_tpu_torch.utils import trajectory as tio

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
TRAJ = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
N_FRAMES = 8


def _tiny(base, yaml_cfg=None):
    """test_torch_tracker's configuration, with a YAML's camera / ORB / IMU settings."""
    cfg = dataclasses.replace(base, loop=dataclasses.replace(base.loop, enabled=False),
                              map=dataclasses.replace(base.map, max_points=2048, local_map_points=2048))
    if yaml_cfg is not None:
        cfg = dataclasses.replace(cfg, width=yaml_cfg.width, height=yaml_cfg.height, fps=yaml_cfg.fps,
                                  orb=yaml_cfg.orb, imu=yaml_cfg.imu, sensor=yaml_cfg.sensor,
                                  use_points=yaml_cfg.use_points, use_lines=yaml_cfg.use_lines)
    return cfg


def _tiny_yaml_loader(mod):
    orig = mod.load_yaml_full

    def load(path):
        cfg, cam, rect = orig(path)
        return _tiny(mod.SlamConfig.tiny_test(), cfg), cam, rect

    return load


@pytest.fixture(scope="module")
def room():
    return list(synthetic.make_sequence(CAM, N_FRAMES, "cpu", fps=20.0, traj=TRAJ, room_half=2.55, with_depth=True,
                                        imu_noise=synthetic.ImuNoiseModel.euroc()))


@pytest.fixture(scope="module")
def euroc_dir(room, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("euroc") / "MH_tiny")
    dw.write_euroc(root, room, 20.0, filter_type=None)
    dw.write_euroc_yaml(os.path.join(root, "cam.yaml"), CAM, tcfg.SlamConfig.tiny_test().replace(use_lines=False))
    return root


def _reference_script(name):
    spec = importlib.util.spec_from_file_location(f"reference_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_traj(path):
    return [(s, np.asarray(R), np.asarray(p)) for s, R, p in tio.load_tum(path)]


def test_run_euroc_matches_reference(euroc_dir, tmp_path, monkeypatch):
    yaml = os.path.join(euroc_dir, "cam.yaml")
    monkeypatch.setattr(tcfg, "load_yaml_full", _tiny_yaml_loader(tcfg))
    monkeypatch.setattr(jcfg, "load_yaml_full", _tiny_yaml_loader(jcfg))
    assert dataclasses.asdict(jcfg.load_yaml_full(yaml)[0]) == dataclasses.asdict(tcfg.load_yaml_full(yaml)[0])
    out_t, out_j = str(tmp_path / "port"), str(tmp_path / "reference")
    assert run_euroc.main([euroc_dir, "--stereo", "--config", yaml, "--native-loader", "--out", out_t, "--cpu",
                           "--no-plots"]) == 0
    ref = _reference_script("run_euroc")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    monkeypatch.setattr(sys, "argv", ["run_euroc.py", euroc_dir, "--stereo", "--config", yaml, "--out", out_j])
    assert ref.main() == 0

    tt, tj = _load_traj(f"{out_t}/trajectory_tum.txt"), _load_traj(f"{out_j}/trajectory_tum.txt")
    assert len(tt) == len(tj) == N_FRAMES
    assert [round(s, 6) for s, _, _ in tt] == [round(s, 6) for s, _, _ in tj]
    kt, kj = _load_traj(f"{out_t}/keyframes_tum.txt"), _load_traj(f"{out_j}/keyframes_tum.txt")
    assert abs(len(kt) - len(kj)) <= max(1, 0.1 * len(kj)) and len(kj) >= 2
    second_kf = min(kt[1][0], kj[1][0])
    on_kf0 = np.array([s < second_kf - 1e-6 for s, _, _ in tj])
    pt, pj = np.stack([p for _, _, p in tt]), np.stack([p for _, _, p in tj])
    assert on_kf0.sum() >= 2
    np.testing.assert_allclose(pt[on_kf0], pj[on_kf0], atol=1e-4)
    gt = _gt_positions(euroc_dir)
    ate_t, ate_j = tio.ate_rmse(pt, gt), jtio.ate_rmse(pj, gt)
    assert abs(ate_t - ate_j) < 0.03, (ate_t, ate_j)
    with open(f"{out_j}/ate.txt") as f:
        assert abs(float(f.read()) - ate_j) < 1e-6
    with open(f"{out_t}/ate.txt") as f:
        assert abs(float(f.read()) - ate_t) < 1e-6
    summary = json.load(open(f"{out_t}/summary.json"))
    assert summary["frames"] == N_FRAMES and summary["n_kf"] == len(kt)
    lines = open(f"{out_t}/track_times.csv").read().splitlines()
    assert lines[0] == "frame,ingest,track" and len(lines) == N_FRAMES + 1
    assert sorted(os.listdir(out_t)) == ["ate.txt", "keyframes_tum.txt", "summary.json", "track_times.csv",
                                         "trajectory_euroc.csv", "trajectory_tum.txt"]


def _gt_positions(euroc_dir):
    """Ground-truth positions at each frame, from the folder's CSV."""
    return np.loadtxt(os.path.join(euroc_dir, "mav0", "state_groundtruth_estimate0", "data.csv"),
                      delimiter=",")[:, 1:4]


@pytest.fixture
def tiny_slam_config(monkeypatch):
    """Drivers that build their own SlamConfig get tiny_test's settings at the
    fixture's raster (the sensor, rate and line switch they ask for kept)."""
    base = _tiny(tcfg.SlamConfig.tiny_test())

    class Tiny:
        def __new__(cls, **kw):
            return dataclasses.replace(base, **{k: kw[k] for k in ("sensor", "fps", "use_lines") if k in kw})

        euroc_stereo = staticmethod(lambda: base)
        euroc_stereo_inertial = staticmethod(lambda: base.replace(sensor="stereo_imu"))
        tiny_test = staticmethod(lambda: base)

    monkeypatch.setattr(tcfg, "SlamConfig", Tiny)
    monkeypatch.setattr(tcfg, "load_yaml_full", _tiny_yaml_loader(tcfg))


def test_run_tum(room, tmp_path, tiny_slam_config, monkeypatch):
    from pli_slam_tpu_torch.utils import datasets

    root, out = str(tmp_path / "tum"), str(tmp_path / "out")
    dw.write_tum(root, room, 30.0)
    small = datasets.TumCalib(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, width=128, height=96, bf=CAM.bf)
    monkeypatch.setattr(datasets.TumCalib, "freiburg", staticmethod(lambda n: small))
    assert run_tum.main([root, "--freiburg", "3", "--out", out, "--cpu", "--no-plots"]) == 0
    s = json.load(open(f"{out}/summary.json"))
    assert s["frames"] == N_FRAMES and s["ate"] < 0.2 and s["n_kf"] >= 2
    assert len(_load_traj(f"{out}/trajectory_tum.txt")) == N_FRAMES


def test_run_kitti(room, tmp_path, tiny_slam_config):
    root, out = str(tmp_path / "kitti"), str(tmp_path / "out")
    dw.write_kitti(root, room, 10.0, CAM.fx, CAM.fy, CAM.cx, CAM.cy, 0.11)
    assert run_kitti.main([root, "--out", out, "--cpu", "--no-plots"]) == 0
    s = json.load(open(f"{out}/summary.json"))
    assert s["frames"] == N_FRAMES and s["ate"] < 0.3
    assert len(tio.load_kitti(f"{out}/trajectory_kitti.txt")) == N_FRAMES


def test_run_live(euroc_dir, tmp_path, tiny_slam_config):
    out = str(tmp_path / "out")
    assert run_live.main([euroc_dir, "--rate", "40", "--config", os.path.join(euroc_dir, "cam.yaml"), "--out", out,
                          "--cpu"]) == 0
    s = json.load(open(f"{out}/summary.json"))
    assert s["pushed"] == N_FRAMES and s["delivered"] >= 1
    assert s["delivered"] + s["dropped"] + s["left"] == s["pushed"]
    assert sum(s["states"].values()) == s["delivered"]
    assert len(_load_traj(f"{out}/trajectory_live_tum.txt")) == s["delivered"]


def test_train_vocab(euroc_dir, tmp_path, tiny_slam_config):
    from pli_slam_tpu_torch.worldmap.vocab import TrainedVocabulary

    prefix = str(tmp_path / "voc")
    assert train_vocab.main(["--euroc", euroc_dir, "--out", prefix, "--words", "64", "--line-words", "16",
                             "--frames", "3", "--cpu"]) == 0
    pt, ln = TrainedVocabulary.load(prefix + "_pt.npz"), TrainedVocabulary.load(prefix + "_ln.npz")
    assert pt.n_words == 64 and ln.n_words == 16 and pt.centroids.dtype == np.int8


def test_run_synthetic_and_diag_ate(capsys, monkeypatch):
    ate = run_synthetic.main([str(N_FRAMES), "--tiny", "--cpu"])
    assert ate < 0.2
    monkeypatch.setenv("BENCH_FRAMES", "6")
    assert diag_ate.main(["--tiny", "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n_kf"] >= 2 and out["ate_frames_m"] < 0.2


@pytest.mark.parametrize("driver, argv", [(run_euroc, ["x"]), (run_tum, ["x"]), (run_kitti, ["x"]),
                                          (run_synthetic, []), (run_live, ["x"]), (train_vocab, []),
                                          (diag_ate, []), (profile_stages, [])],
                         ids=["euroc", "tum", "kitti", "synthetic", "live", "train_vocab", "diag_ate", "profile_stages"])
def test_drivers_need_a_gpu_without_cpu_flag(driver, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        driver.main(argv)
    assert e.value.code not in (0, None)


@pytest.mark.slow
def test_full_width_reference_kitti(tmp_path, monkeypatch, capsys):
    """The reference's scripts/run_kitti.py, on its accelerator branch on a
    CPU, over chip_smoke.py's phase 9c folder (1241x376, 2000 ORB, 30
    frames): the ATE that chip_smoke.py's REF_ATE_KITTI records."""
    import chip_smoke

    c = chip_smoke.KITTI_CAM
    root, out = str(tmp_path / "kitti"), str(tmp_path / "out")
    dw.write_kitti(root, chip_smoke.kitti_frames("cpu"), 10.0, c["fx"], c["fy"], c["cx"], c["cy"], c["baseline"])
    ref = _reference_script("run_kitti")
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    monkeypatch.setattr(sys, "argv", ["run_kitti.py", root, "--out", out])
    assert ref.main() == 0
    stdout = capsys.readouterr().out
    ate = float(stdout.split("ATE RMSE vs ground truth:")[1].split()[0])
    with capsys.disabled():
        print(f"\nreference run_kitti on chip_smoke's 9c folder: {stdout.strip().splitlines()[-2:]}")
    assert abs(ate - chip_smoke.REF_ATE_KITTI) < 5e-3 and ate < chip_smoke.KITTI_ATE_BOUND
