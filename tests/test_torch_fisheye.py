"""The port's fisheye (Kannala-Brandt8) stereo path against the reference's:
`epipolar_gate`, the KB8 renderer, `build_frame_fisheye_stereo` and the
stereo `Tracker` on a KB8 rig (`T_rl`), plus the reference's scenario tests
of tests/test_fisheye.py run on the port.

The scene is tests/test_fisheye.py's: the 128x96 KB8 camera (fx 120,
k = (0.08, -0.02, 0.004, -0.001)), a pure 0.11 m baseline, the small room.
The reference takes its accelerator branch (as in test_torch_step:
`jax.default_backend` patched, Pallas in interpret mode, store capacities
a multiple of its 2048-row tile), which the port follows on every device.

Tolerances:
- `epipolar_gate`: equal, except for pairs whose squared distance lies
  within 1e-3 relative of the 3.84 threshold (K^-1 and the products are
  float32 in both, summed in another order);
- the KB8 renderer: at least 99.5% of pixels within 1e-3 grey levels, as
  test_torch_synthetic (float32 sin, tan and the Newton steps round in
  the last ulps);
- `build_frame_fisheye_stereo` against the reference run eagerly:
  keypoints and descriptors exact (undistorted coordinates within 1e-4
  px of float32 Newton steps); the stereo verdicts equal but for features
  whose match sits at the gate's threshold; depth 1e-4 relative. Under
  jit the reference's own depths move by up to 1.7e-3 relative: the DLT
  inverts a near-singular 4x4 in float32 at this 5 px disparity, and XLA
  fuses its arithmetic in another order;
- the KB8 stereo trackers over 8 frames: state and keyframe count exact,
  inlier and landmark counts within 10%, frames recorded relative to KF0
  within 1e-4 m, the rest as test_torch_tracker (0.1 m per frame, ATE
  within 3 cm).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import frame as jframe
from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import camera as jcam_ops
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.solve import triangulate as jtri
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import camera as tcam_ops
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.solve import triangulate as ttri
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
KB8_K = [0.08, -0.02, 0.004, -0.001]
BASELINE = 0.11
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
N_FRAMES = 8


def _cams(bf=120.0 * BASELINE):
    args = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, k=KB8_K, bf=bf, width=128, height=96)
    return JCamera.kannala_brandt8(**args), TCamera.kannala_brandt8(**args)


def _T_rl():
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -BASELINE  # x_right = x_left - baseline: the right camera sits at +x
    return T


def _cfg():
    cfg = SlamConfig.tiny_test()
    return dataclasses.replace(cfg, loop=LoopConfig(enabled=False),
                               map=dataclasses.replace(cfg.map, max_points=2048, local_map_points=2048))


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def pairs():
    """Two KB8 stereo pairs from each package's renderer."""
    jcam, tcam = _cams()
    seq_j = jsyn.make_sequence(jcam, 2, fps=20.0, traj=jsyn.Trajectory(**TRAJ), room_half=2.55)
    seq_t = tsyn.make_sequence(tcam, 2, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ), room_half=2.55)
    return list(zip(seq_j, seq_t))


def test_kb8_renderer_matches_reference(pairs):
    for fj, ft in pairs:
        np.testing.assert_array_equal(ft["p_w"], fj["p_w"])
        for side in ("img_l", "img_r"):
            a, b = ft[side].numpy(), np.asarray(fj[side])
            assert a.shape == b.shape == (96, 128) and a.dtype == b.dtype
            assert (np.abs(a - b) <= 1e-3).mean() >= 0.995, side
    # a fisheye view is not the pinhole one: the rays bend away from the centre
    pin = dataclasses.replace(_cams()[1], model=tcam_ops.PINHOLE)
    fr = next(iter(tsyn.make_sequence(pin, 1, "cpu", traj=tsyn.Trajectory(**TRAJ), room_half=2.55)))
    assert (np.abs(fr["img_l"].numpy() - pairs[0][1]["img_l"].numpy()) > 1.0).mean() > 0.2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epipolar_gate(seed):
    rng = np.random.default_rng(seed)
    jcam, tcam = _cams()
    jpin, tpin = dataclasses.replace(jcam, model=0), dataclasses.replace(tcam, model=0)
    w = rng.normal(size=3) * 0.2
    R2 = np.asarray(jax.scipy.linalg.expm(jnp.asarray([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])),
                    np.float32)
    t2 = (rng.normal(size=3) * 0.3).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    uv1 = rng.uniform([0, 0], [128, 96], size=(200, 2)).astype(np.float32)
    uv2 = rng.uniform([0, 0], [128, 96], size=(300, 2)).astype(np.float32)
    gj = np.asarray(jtri.epipolar_gate(jpin, *map(jnp.asarray, (R1, t1, R2, t2, uv1, uv2))))
    T = torch.as_tensor
    gt = ttri.epipolar_gate(tpin, *map(T, (R1, t1, R2, t2, uv1, uv2))).numpy()
    assert gt.shape == gj.shape == (200, 300) and 0.01 < gj.mean() < 0.5
    # the squared distances in float64, to find the pairs at the threshold
    K = np.array([[120.0, 0, 64.0], [0, 120.0, 48.0], [0, 0, 1]])
    tx = np.array([[0, -t2[2], t2[1]], [t2[2], 0, -t2[0]], [-t2[1], t2[0], 0]], np.float64)
    F = np.linalg.inv(K).T @ tx @ R2 @ np.linalg.inv(K)
    lines = np.c_[uv1, np.ones(200)] @ F.T
    d2 = (np.abs(np.c_[uv2, np.ones(300)] @ lines.T).T / np.hypot(lines[:, 0], lines[:, 1])[:, None]) ** 2
    edge = np.abs(d2 / 3.84 - 1.0) < 1e-3
    np.testing.assert_array_equal(gt[~edge], gj[~edge])


@pytest.fixture(scope="module")
def fisheye_frames(pairs):
    cfg = SlamConfig.tiny_test()
    jcam, tcam = _cams()
    T = _T_rl()
    # eager: under jit, XLA's fusion moves the reference's own depths by up to 1.7e-3 relative (the DLT's
    # float32 4x4 inverse is near-singular at this baseline); the port agrees with the eager run to 4e-6
    build_j = partial(jframe.build_frame_fisheye_stereo, jcam, jcam, cfg, jnp.asarray(T[:3, :3]),
                      jnp.asarray(T[:3, 3]))
    out = []
    for fj, _ in pairs:
        il, ir = np.array(fj["img_l"]), np.array(fj["img_r"])
        jf = convert.to_numpy(jax.tree_util.tree_map(np.asarray, build_j(jnp.asarray(il), jnp.asarray(ir))))
        tf = convert.to_numpy(tframe.build_frame_fisheye_stereo(
            tcam, tcam, port_cfg(cfg), torch.as_tensor(T[:3, :3]), torch.as_tensor(T[:3, 3]),
            torch.as_tensor(il), torch.as_tensor(ir)))
        out.append((jf, tf, il, ir))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_build_frame_fisheye_stereo(fisheye_frames, k):
    jf, tf, il, ir = fisheye_frames[k]
    assert jf.keys() == tf.keys()
    for key in jf:
        assert jf[key].dtype == tf[key].dtype and jf[key].shape == tf[key].shape, key
    for key in ("feats.octave", "feats.scale", "feats.desc", "feats.valid", "sigma2", "line_ok", "line_disp"):
        np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
    # undistorted keypoints: the same raw keypoints through float32 Newton steps
    np.testing.assert_allclose(tf["feats.uv"], jf["feats.uv"], rtol=0, atol=1e-4)
    m_j, m_t = jf["stereo_ok"], tf["stereo_ok"]
    assert m_j.sum() > 30, m_j.sum()
    # a verdict may differ only where the match sits at the epipolar gate's threshold
    cfg = SlamConfig.tiny_test()
    _, tcam = _cams()
    pin = dataclasses.replace(tcam, model=0)
    fr_r = convert.to_numpy(tframe.orb.extract(torch.as_tensor(ir), port_cfg(cfg).orb))
    uv_r = tframe.undistort_uv(tcam, torch.as_tensor(fr_r["uv"])).numpy().astype(np.float64)
    K = np.array([[120.0, 0, 64.0], [0, 120.0, 48.0], [0, 0, 1]])
    tx = np.array([[0, 0, 0], [0, 0, BASELINE], [0, -BASELINE, 0]])  # [t]x for t = (-b, 0, 0)
    F = np.linalg.inv(K).T @ tx @ np.linalg.inv(K)
    lines = np.c_[tf["feats.uv"], np.ones(len(m_t))] @ F.T
    d2 = (np.abs(np.c_[uv_r, np.ones(len(uv_r))] @ lines.T).T / np.hypot(lines[:, 0], lines[:, 1])[:, None]) ** 2
    at_edge = (np.abs(d2 / 3.84 - 1.0) < 1e-3).any(1)
    diff = m_j != m_t
    assert not (diff & ~at_edge).any(), np.nonzero(diff & ~at_edge)
    both = m_j & m_t
    np.testing.assert_allclose(tf["depth"][both], jf["depth"][both], rtol=1e-4)
    np.testing.assert_allclose(tf["u_right"][both], jf["u_right"][both], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tf["depth"][~(m_j | m_t)], jf["depth"][~(m_j | m_t)])


def _accelerator_branch():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    return mp


@pytest.fixture(scope="module")
def stereo_run(pairs):
    mp = _accelerator_branch()
    try:
        cfg = _cfg()
        jcam, tcam = _cams()
        jt = jtr.Tracker(jcam, cfg, T_rl=_T_rl())
        tt = Tracker(tcam, port_cfg(cfg), "cpu", T_rl=_T_rl())
        infos, gt = [], []
        for fr in jsyn.make_sequence(jcam, N_FRAMES, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55):
            il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
            infos.append((jt.process(il, ir, fr["t"]), tt.process(il, ir, fr["t"])))
            gt.append(fr["p_w"])
        jt.finalize()
        tt.finalize()
        return jt, tt, infos, np.stack(gt)
    finally:
        mp.undo()


def test_kb8_stereo_tracker_per_frame(stereo_run):
    jt, tt, infos, _ = stereo_run
    for k, (ji, ti) in enumerate(infos):
        assert ti["state"] == ji["state"] == TrackingState.OK, k
        assert ti["n_kf"] == ji["n_kf"], (k, ti, ji)
        for key in ("n_inliers", "n_points"):
            assert abs(ti[key] - ji[key]) <= 0.1 * max(ji[key], 10), (k, key, ti, ji)
    assert tt.n_kf == jt.n_kf >= 2
    assert tt.cam.model == tcam_ops.PINHOLE and tt.cam_raw.model == tcam_ops.KANNALA_BRANDT8


def test_kb8_stereo_tracker_trajectory(stereo_run):
    jt, tt, infos, gt = stereo_run
    pj, pt = jt.positions(), tt.positions()
    assert pt.shape == pj.shape == gt.shape
    on_kf0 = np.array([ji["n_kf"] == 1 for ji, _ in infos])
    assert on_kf0.sum() >= 3
    np.testing.assert_allclose(pt[on_kf0], pj[on_kf0], atol=1e-4)
    assert np.abs(pt - pj).max() < 0.1, np.abs(pt - pj).max()
    ate_t, ate_j = tsyn.ate_rmse(pt, gt), jsyn.ate_rmse(pj, gt)
    assert abs(ate_t - ate_j) < 0.03, (ate_t, ate_j)


def test_kb8_stereo_builds_through_the_fisheye_builder():
    """Every path of a KB8 stereo tracker builds its frames with the fisheye
    builder: the host path, the fused visual step, the fused stereo-inertial
    step and relocalization all call `self.build_frame` or the builder the
    steps were made with; a rectifier is ignored, as in the reference."""
    _, tcam = _cams()
    calls = []
    orig = tframe.build_frame_fisheye_stereo

    def spy(*a):
        calls.append(a[0])
        return orig(*a)

    class Refused:
        def to(self, device):
            return self

        def __call__(self, *images):
            raise AssertionError("a KB8 rig is not rectified")

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr("pli_slam_tpu_torch.frontend.tracker.build_frame_fisheye_stereo", spy)
        for sensor in ("stereo", "stereo_imu"):
            tr = Tracker(tcam, dataclasses.replace(port_cfg(_cfg()), sensor=sensor), "cpu", rectifier=Refused(),
                         T_rl=_T_rl())
            frames = list(tsyn.make_sequence(tcam, 2, "cpu", traj=tsyn.Trajectory(**TRAJ), room_half=2.55))
            for fr in frames:
                tr.process(fr["img_l"], fr["img_r"], fr["t"],
                           imu={"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]})
            assert tr.n_kf >= 1 and tr.state == TrackingState.OK
    finally:
        mp.undo()
    assert len(calls) == 4 and all(c == tcam for c in calls)


def test_kb8_sensor_checks():
    """As the reference: KB8 stereo without `T_rl` and KB8 with an RGB-D
    sensor raise ValueError; mono and mono_imu take a KB8 camera."""
    jcam, tcam = _cams()
    for sensor in ("stereo", "stereo_imu", "rgbd", "rgbd_imu"):
        cfg = dataclasses.replace(_cfg(), sensor=sensor)
        with pytest.raises(ValueError):
            jtr.Tracker(jcam, cfg)
        with pytest.raises(ValueError):
            Tracker(tcam, port_cfg(cfg), "cpu")
    with pytest.raises(ValueError):
        Tracker(tcam, port_cfg(dataclasses.replace(_cfg(), sensor="rgbd")), "cpu", T_rl=_T_rl())
    for sensor in ("mono", "mono_imu"):
        tr = Tracker(tcam, port_cfg(dataclasses.replace(_cfg(), sensor=sensor)), "cpu")
        assert tr.is_mono and tr.cam_raw == tcam and tr.cam.model == tcam_ops.PINHOLE


# ---------------------------------------------------------------------------
# tests/test_fisheye.py on the port
# ---------------------------------------------------------------------------


def test_undistort_uv_maps_to_pinhole_projection():
    _, cam = _cams(bf=0.0)
    pin = dataclasses.replace(cam, model=tcam_ops.PINHOLE)
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-1.5, 1.5, (64, 3)) + np.array([0, 0, 4.0]), dtype=torch.float32)
    err = (tframe.undistort_uv(cam, tcam_ops.project(cam, pts)) - tcam_ops.project(pin, pts)).abs()
    assert err.max().item() < 0.05, err.max().item()
    # and the same numbers as the reference's
    jc = JCamera.kannala_brandt8(fx=120.0, fy=120.0, cx=64.0, cy=48.0, k=KB8_K, width=128, height=96)
    ju = np.asarray(jframe.undistort_uv(jc, jcam_ops.project(jc, jnp.asarray(pts.numpy()))))
    np.testing.assert_allclose(tframe.undistort_uv(cam, tcam_ops.project(cam, pts)).numpy(), ju, atol=1e-4)


def test_kb8_stereo_requires_rig_extrinsics():
    _, cam = _cams()
    with pytest.raises(ValueError):
        Tracker(cam, port_cfg(SlamConfig.tiny_test()), "cpu")  # no T_rl


def _sim3_ate(est, gt):
    n = min(len(est), len(gt))
    est, gtn = est[:n], gt[:n]
    mu_e, mu_g = est.mean(0), gtn.mean(0)
    E, G = est - mu_e, gtn - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E / n)
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max((E ** 2).sum() / n, 1e-12)
    aligned = (s * (R @ E.T)).T + mu_g
    return float(np.sqrt(((aligned - gtn) ** 2).sum(axis=1).mean())), np.linalg.norm(np.diff(gtn, axis=0), axis=1).sum()


@pytest.mark.slow
def test_kb8_stereo_e2e_tracks():
    """Fisheye stereo, 24 frames: metric depth from the rig, so the
    trajectory aligns without scale (tests/test_fisheye.py's bounds)."""
    _, cam = _cams()
    cfg = port_cfg(SlamConfig.tiny_test())
    tracker = Tracker(cam, cfg, "cpu", T_rl=_T_rl())
    gt, infos = [], []
    for fr in tsyn.make_sequence(cam, 24, "cpu", fps=cfg.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55):
        infos.append(tracker.process(fr["img_l"], fr["img_r"], fr["t"]))
        gt.append(fr["p_w"])
    assert sum(1 for i in infos if i["state"] == TrackingState.OK) >= 20
    assert infos[-1]["n_points"] > 30
    gt = np.stack(gt)
    ate = tsyn.ate_rmse(tracker.positions(), gt)
    path = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert ate < 0.35 * path, (ate, path)


@pytest.mark.slow
def test_mono_fisheye_e2e_tracks():
    """Monocular on KB8 imagery: initializes, tracks, and recovers the
    trajectory's shape up to scale (tests/test_fisheye.py's bounds)."""
    _, cam = _cams(bf=0.0)
    cfg = port_cfg(SlamConfig.tiny_test().replace(sensor="mono"))
    frames = list(tsyn.make_sequence(cam, 54, "cpu", fps=cfg.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55))[::3]
    tr = Tracker(cam, cfg, "cpu")
    infos = [tr.process_mono(fr["img_l"], fr["t"]) for fr in frames]
    assert tr.n_kf >= 2, "fisheye mono never initialized"
    assert sum(1 for i in infos if i["state"] == TrackingState.OK) >= len(infos) * 0.5
    ate, path = _sim3_ate(tr.positions(), np.stack([fr["p_w"] for fr in frames]))
    assert ate < 0.4 * path, (ate, path)


def test_phase10_first_pair_digest():
    """chip_smoke.py's phase 10 renders its KB8 pairs on the host; the card
    tracks the pixels this CPU computes for the first pair."""
    import chip_smoke

    from pli_slam_tpu_torch.utils import profile

    _, cam, frames = profile.slice6_frames("fisheye_vi", "cpu", 1)
    assert (cam.width, cam.height, cam.model) == (512, 512, tcam_ops.KANNALA_BRANDT8)
    assert tsyn.frame_digest(frames[0]["img_l"], frames[0]["img_r"]) == chip_smoke.FISHEYE0_SHA256


@pytest.mark.slow
@pytest.mark.parametrize("which", ["fisheye", "fisheye_vi"])
def test_full_width_reference_runs(which, capsys):
    """The reference alone at full width over phase 10's frames (TUM-VI's KB8
    rig, 512x512): the numbers chip_smoke.py's REF_FISHEYE / REF_FISHEYE_VI
    hold (tests/full_width_slice6.py; 5-10 min each on a CPU)."""
    import chip_smoke
    from full_width_slice6 import describe, run_reference

    # 10b stops at the IMU initialization: the reference's fused stereo-inertial step at 512x512 does not
    # compile on a CPU (XLA's LLVM runs out of memory and the process dies)
    r = run_reference(which, None if which == "fisheye" else chip_smoke.REF_FISHEYE_VI["imu_init"] + 1)
    with capsys.disabled():
        print("\n" + describe(r))
    if which == "fisheye":
        ref = chip_smoke.REF_FISHEYE
        assert (r["mono_init"], r["n_kf"]) == (ref["init"], ref["n_kf"]) and abs(r["ate"] - ref["ate"]) < 5e-4
    else:
        ref = chip_smoke.REF_FISHEYE_VI
        assert (r["mono_init"], r["init_frame"]) == (ref["map_init"], ref["imu_init"])
        assert abs(r["ate_pre"] - ref["ate_pre"]) < 5e-4 and abs(r["ate_init"] - ref["ate_init"]) < 5e-4


@pytest.mark.slow
@pytest.mark.parametrize("which", ["fisheye_vi", "stereo_vi"])
def test_full_width_init_fiba_from_identical_input(which, capsys):
    """A defect both packages share (ROADMAP queue 3 B1): the IMU
    initialization's full inertial BA is a fixed number of damped
    Gauss-Newton steps with no acceptance test, so from the same map float32
    rounding decides whether it lands near its minimum or far above it.
    Here the port's `_try_imu_init` starts from the reference's exact state
    at its initialization on phase 10b's frames (the fisheye rig) and on
    phase 5's (the pinhole rig): the maps before the BA agree to 1e-5, and
    the two BAs' objectives are printed with how far each moved the
    keyframes (measured on a CPU: on phase 10b's map the port's solution
    lies 86x above the reference's, moving keyframes 1.47 m against 0.22 m;
    on phase 5's the reference's lies 7.9x above the port's). ~6 min each."""
    from full_width_slice6 import fiba_from_identical_input

    r = fiba_from_identical_input(which)
    with capsys.disabled():
        print(f"\n{which}: {r}")
    assert r["pre_diff"] < 1e-5 and r["n_kf"] >= 10
