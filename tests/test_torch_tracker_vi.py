"""The port's stereo-inertial path against the reference's: the device
stages (`track_step_inertial`, `local_inertial_ba`, `make_step_vi`) from
identical state, both `Tracker`s over the same images and IMU batches, and
the host pieces (`_imu_batch_arrays`, `_fiba_schedule`, the deferred queue).

Scene and settings are those of tests/test_tracker_inertial.py:
`SlamConfig.tiny_test()` with `sensor="stereo_imu"`, `init_time_sec=1.0`,
`max_samples_per_frame=16`, the 128x96 camera, its trajectory, ideal IMU.
The reference takes its accelerator branch (as in test_torch_step:
`jax.default_backend` patched, Pallas in interpret mode, point-store
capacity 2048, a multiple of its tile), which the port follows on every
device. `init_min_kfs` is 5 instead of 10 in the tests that are not slow:
IMU initialization then fires at frame 20 (the first frame 1.0 s after the
first IMU sample) instead of frame ~45, before the float32 chaos of windowed
BA (test_torch_step) has moved the two runs' keyframe decisions apart, and
the file runs in about two minutes. The 70-frame run with the default 10
is the `slow` test.

One reference run (`ref_run`) feeds every comparison: before each of its
fused stereo-inertial frames the state is carried across with
`utils.convert.inertial_state`, the port's `make_step_vi` runs that one
frame from it on the reference's own FrameData, and its outputs are held
against what the reference's step returned.

Tolerances:
- the packed IMU batch, `_fiba_schedule`, stats counters, match ids and
  masks, keyframe decisions: exact;
- a frame without a keyframe: pose 2e-4, velocity 2e-3 m/s, biases 5e-4,
  accumulator as in test_torch_imu, stores as in test_torch_step. The pose
  comes out of two 15-dof solves whose information matrix holds 1e8-sized
  entries (test_torch_inertial);
- a keyframe frame runs visual-inertial BA on a 128x96 map. As in the
  visual BA (test_torch_step) the reduced camera system S = Hpp - W Hll^-1
  W^T is formed by cancellation: from identical input its 6x6 blocks differ
  between the packages by 5% (8e4 of 1.5e6) while the IMU factors' residuals,
  Jacobians and information agree to 1e-6 relative, and one iteration's
  step then differs by up to 1.4e-2 in the poses and 1.5e-2 m/s in the
  velocities (measured on this scene). So a keyframe frame is held to
  window poses 3e-2, velocities 0.1 m/s, biases 5e-2, and its bookkeeping
  exactly;
- `local_inertial_ba` from identical input: the same bounds, 90% of the
  points within 5% of their distance, and the port's solution at least as
  good a minimum of the visual-inertial objective as the reference's
  (within 10%);
- a host-path frame replayed from the reference's state
  (`test_host_path_lockstep`): decisions, counters and bookkeeping exact;
  poses 1e-4 without a keyframe; a keyframe's windowed BA is held to 0.2
  only, a divergence guard: on this scene the first BA with free poses
  (frame 15, window [0 1 2 3 4 4 4 4], three poses fixed) differs by 0.14 m
  between the packages from identical input. There the reference's solve
  moves the window by 0.153 m and RAISES the common robust objective from
  3927 to 4227, while the port's moves it by 0.029 m and lowers it to 3892
  (measured with the port's `evaluate_cost` on both solutions): float32
  cancellation in the reduced camera system, not a difference of the
  algorithm (test_torch_step holds `local_ba` itself, step by step);
- whole runs, each tracker building its own frames: by frame 19 the two
  maps differ by 15 cm in the live pose (the same BA chaos, measured), so
  the runs are compared by their decisions and by loose bounds: IMU
  initialization at the same frame with the same log, keyframe counts
  within two at the end (equal up to the initialization), every frame
  tracked, gravity within 10 degrees of the truth in each and 8 degrees of
  each other (measured 7.3 and 2.4 from the truth, 6.9 apart; the
  reference's own test allows 7), biases within 0.25 rad/s and 0.5 m/s^2 of
  each other, ATE within 10 cm of each other.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import imu as jimu
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.solve import inertial as jinr
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import imu as timu
from pli_slam_tpu_torch.solve import inertial as tinr
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
N_FRAMES = 28
INIT_FRAME = 20  # the first frame 1.0 s after the first IMU sample (t = -0.045 s)


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _cfg(init_min_kfs):
    cfg = SlamConfig.tiny_test()
    return dataclasses.replace(
        cfg, sensor="stereo_imu", loop=LoopConfig(enabled=False),
        imu=dataclasses.replace(cfg.imu, init_time_sec=1.0, max_samples_per_frame=16, init_min_kfs=init_min_kfs),
        map=dataclasses.replace(cfg.map, max_points=2048, local_map_points=2048))


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


def _cams():
    jcam = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
    return jcam, convert.camera(np_tree(jcam))


def _accelerator_branch():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    return mp


def _force_host_state(tt, jt):
    """Put the port tracker `tt` into the reference tracker's state, as far as
    the host-orchestrated path reads it."""
    T = lambda x: convert.tensor(np.asarray(x))  # noqa: E731
    tt.pstore, tt.lstore = convert.point_store(jt.pstore), convert.line_store(jt.lstore)
    tt.kstore, tt.bow_db = convert.keyframe_store(jt.kstore), convert.bow_database(jt.bow_db)
    tt._pints = convert.preint_store(jt._pints)
    for name in ("R", "t", "R_prev", "t_prev", "vel_xi", "v_w", "bg", "ba", "_local_pt"):
        setattr(tt, name, T(getattr(jt, name)))
    tt.has_vel = torch.tensor(bool(jt.has_vel))
    tt.gravity_w = None if jt.gravity_w is None else T(jt.gravity_w)
    tt._preint_since_kf = None if jt._preint_since_kf is None else convert.preintegrated(jt._preint_since_kf)
    tt._last_imu_raw = None if jt._last_imu_raw is None else (jt._last_imu_raw[0], jt._last_imu_raw[1].copy(),
                                                              jt._last_imu_raw[2].copy())
    for name in ("n_kf", "frames_since_kf", "last_kf_inliers"):
        setattr(tt, name, int(getattr(jt, name)))
    for name in ("state", "_lost_frames", "imu_ready", "_first_imu_stamp", "_viba_stage", "_imu_init_stamp",
                 "_map_event_cooldown", "_prev_stamp"):
        setattr(tt, name, getattr(jt, name))


def _host_summary(tr):
    """What a host-path frame leaves behind, as numpy."""
    n = lambda x: None if x is None else (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))  # noqa: E731
    k = int(tr.n_kf)
    return dict(R=n(tr.R), t=n(tr.t), v_w=n(tr.v_w), bg=n(tr.bg), ba=n(tr.ba), gravity_w=n(tr.gravity_w), n_kf=k,
                fs=int(tr.frames_since_kf), last=int(tr.last_kf_inliers), imu_ready=tr.imu_ready,
                kR=n(tr.kstore.R)[:k], kt=n(tr.kstore.t)[:k], kv=n(tr.kstore.v_w)[:k], kvalid=n(tr.kstore.valid),
                pvalid=n(tr.pstore.valid), x=n(tr.pstore.x), pints_valid=n(tr._pints.valid),
                pints_dt=n(tr._pints.data.dt), local=n(tr._local_pt), info=dict(tr.stats[-1]),
                log=[(r["accepted"], r["reason"]) for r in tr.imu_init_log])


def _run_both(cfg, n_frames, record=False, free_run=True):
    """Both trackers over the same images and IMU batches (without
    `free_run` the port's own whole run is left out). With `record`,
    also: every packed IMU batch of both; for each host-path frame of the
    reference what a third port tracker makes of that one frame when it
    starts from the reference's state and FrameData (`lockstep`); and for
    each fused stereo-inertial frame of the reference the state before it
    (converted), its FrameData and what its step returned."""
    jcam, tcam = _cams()
    jt = jtr.Tracker(jcam, cfg)
    tt = Tracker(tcam, port_cfg(cfg), "cpu")
    helper = Tracker(tcam, port_cfg(cfg), "cpu")  # only its _imu_batch_arrays runs
    lock = Tracker(tcam, port_cfg(cfg), "cpu")  # restarted from the reference's state every frame
    rec = dict(infos=[], gt=[], imu=[], fused=[], ready=[], lockstep=[])
    step_out = []
    if record:
        orig = jt._step_vi
        jt._step_vi = lambda *a: step_out.append(orig(*a)) or step_out[-1]
    for k, fr in enumerate(jsyn.make_sequence(jcam, n_frames, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ),
                                              room_half=2.55)):
        imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
        before = None
        host_frame = record and not jt.imu_ready
        if host_frame:
            _force_host_state(lock, jt)
            frame_np = np_tree(jt.build_frame(il, ir))
        if record:
            packed_t = helper._imu_batch_arrays(imu, packed=True)
            if jt.imu_ready and jt.state == TrackingState.OK:
                before = dict(state=convert.inertial_state(jt), wide=jt._map_event_cooldown > 0,
                              frame=np_tree(jt.build_frame(il, ir)), stamp=fr["t"], imu=packed_t)
        ji = jt.process(il, ir, fr["t"], imu=imu)
        if host_frame:
            lock._process_frame(convert.frame_data(frame_np), fr["t"], True, imu)
            rec["lockstep"].append((_host_summary(jt), _host_summary(lock)))
        if before is not None:
            before["out"] = np_tree(step_out[-1])
            rec["fused"].append(before)
        if record:
            # the reference's own packed batch of this frame, from the sample it carried
            rec["imu"].append((packed_t.numpy(), imu))
        rec["infos"].append((ji, tt.process(il, ir, fr["t"], imu=imu) if free_run else None))
        rec["ready"].append((jt.imu_ready, tt.imu_ready))
        rec["gt"].append(fr["p_w"])
    jt.finalize()
    tt.finalize()
    rec["gt"] = np.stack(rec["gt"])
    return jt, tt, rec


@pytest.fixture(scope="module")
def ref_run():
    mp = _accelerator_branch()
    try:
        cfg = _cfg(init_min_kfs=5)
        yield (cfg,) + _run_both(cfg, N_FRAMES, record=True)
    finally:
        mp.undo()


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------


def _gravity_angle_deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.degrees(np.arccos(np.clip(a @ b / np.linalg.norm(a) / np.linalg.norm(b), -1, 1))))


def _assert_runs_agree(jt, tt, rec, init_frame=None):
    ready_j = [r[0] for r in rec["ready"]].index(True)
    ready_t = [r[1] for r in rec["ready"]].index(True)
    assert ready_j == ready_t, (ready_j, ready_t)
    if init_frame is not None:
        assert ready_t == init_frame
    log = lambda tr: [(r["accepted"], r["reason"]) for r in tr.imu_init_log]  # noqa: E731
    assert log(tt) == log(jt) and log(tt)[-1] == (True, "ok")
    assert set(tt.imu_init_log[-1]) == set(jt.imu_init_log[-1])
    assert abs(tt.n_kf - jt.n_kf) <= 2, (tt.n_kf, jt.n_kf)
    for ji, ti in rec["infos"]:
        assert ti["state"] == ji["state"] == TrackingState.OK
    R0, _ = jsyn.Trajectory(**TRAJ).pose(0.0)
    g_j, g_t = R0 @ np.asarray(jt.gravity_w), R0 @ tt.gravity_w.numpy()
    assert _gravity_angle_deg(g_t, g_j) < 8.0
    assert _gravity_angle_deg(g_t, [0, 0, -9.81]) < 10.0 and _gravity_angle_deg(g_j, [0, 0, -9.81]) < 10.0
    np.testing.assert_allclose(np.linalg.norm(g_t), 9.81, rtol=0.15)
    np.testing.assert_allclose(tt.bg.numpy(), np.asarray(jt.bg), atol=0.25)
    np.testing.assert_allclose(tt.ba.numpy(), np.asarray(jt.ba), atol=0.5)
    pj, pt = jt.positions(), tt.positions()
    assert pt.shape == pj.shape == rec["gt"].shape and np.all(np.isfinite(pt))
    ate_t, ate_j = tsyn.ate_rmse(pt, rec["gt"]), jsyn.ate_rmse(pj, rec["gt"])
    assert abs(ate_t - ate_j) < 0.1, (ate_t, ate_j)
    return ready_t


def test_whole_slice_imu_init_and_fused_vi(ref_run):
    """Host path, IMU initialization at the same frame with the same log,
    then the fused stereo-inertial step in both, through at least one
    keyframe with visual-inertial BA."""
    cfg, jt, tt, rec = ref_run
    ready = _assert_runs_agree(jt, tt, rec, INIT_FRAME)
    for k, (ji, ti) in enumerate(rec["infos"][:ready + 1]):  # the host path, frame by frame
        assert ti["n_kf"] == ji["n_kf"], (k, ti, ji)
        assert abs(ti["n_inliers"] - ji["n_inliers"]) <= 0.1 * max(ji["n_inliers"], 10), (k, ti, ji)
    assert tt._vi_fused_active and jt._vi_fused_active
    kf_at_init = rec["infos"][ready][1]["n_kf"]
    assert tt.n_kf > kf_at_init and jt.n_kf > kf_at_init  # a keyframe was made by the fused step
    assert tt._viba_stage == jt._viba_stage == 0
    assert bool(tt._pints.valid[tt.n_kf - 1]) and bool(np.asarray(jt._pints.valid)[jt.n_kf - 1])
    # the chain's factors span the keyframe gaps
    gaps = np.diff(tt.kstore.stamp[:tt.n_kf].numpy())
    np.testing.assert_allclose(tt._pints.data.dt[1:tt.n_kf].numpy(), gaps, atol=1e-3)


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


def test_host_path_lockstep(ref_run):
    """Every host-orchestrated frame of the reference run (initialization,
    tracking against the whole point store, host-side keyframes with their
    windowed BA, culling and BoW, and the frame that initializes the IMU),
    each replayed by a port tracker restarted from the reference's state:
    decisions and bookkeeping exact; poses 1e-4 on frames without a
    keyframe, 0.2 (a divergence guard, see the module docstring) where a
    keyframe ran windowed BA or the initialization ran full inertial BA;
    the gravity directions, which come out of the inertial-only MAP problem
    before that BA, within 0.5 degrees."""
    cfg, _, _, rec = ref_run
    _check_host_lockstep(rec, INIT_FRAME)


def _check_host_lockstep(rec, init_frame):
    assert len(rec["lockstep"]) == init_frame + 1
    kf_frames = 0
    for k, (sj, st_) in enumerate(rec["lockstep"]):
        label = f"frame {k}"
        for key in ("n_kf", "fs", "imu_ready", "log"):
            assert st_[key] == sj[key], (label, key, st_[key], sj[key])
        assert st_["info"] == sj["info"], (label, st_["info"], sj["info"])
        np.testing.assert_array_equal(st_["kvalid"], sj["kvalid"], err_msg=label)
        np.testing.assert_array_equal(st_["pints_valid"], sj["pints_valid"], err_msg=label)
        np.testing.assert_allclose(st_["pints_dt"], sj["pints_dt"], atol=1e-6, err_msg=label)
        made_kf = sj["fs"] == 0
        kf_frames += made_kf
        if sj["imu_ready"]:
            assert k == init_frame and sj["log"][-1] == (True, "ok")
            assert _gravity_angle_deg(st_["gravity_w"], sj["gravity_w"]) < 0.5
            np.testing.assert_allclose(st_["gravity_w"], sj["gravity_w"], atol=0.1)
            pose_tol, v_tol, b_tol = 0.2, 0.5, 0.1
        else:
            assert st_["gravity_w"] is None and sj["gravity_w"] is None
            pose_tol, v_tol, b_tol = (0.2, 0.0, 0.0) if made_kf else (1e-4, 0.0, 0.0)
            assert st_["last"] == sj["last"], label
            np.testing.assert_array_equal(st_["pvalid"], sj["pvalid"], err_msg=label)
        for key, tol in (("R", pose_tol), ("t", pose_tol), ("kR", pose_tol), ("kt", pose_tol), ("v_w", v_tol),
                         ("kv", v_tol), ("bg", b_tol), ("ba", b_tol)):
            np.testing.assert_allclose(st_[key], sj[key], atol=tol, err_msg=f"{label} {key}")
        if not made_kf and not sj["imu_ready"]:
            np.testing.assert_allclose(st_["x"], sj["x"], atol=1e-5, err_msg=label)
            np.testing.assert_array_equal(st_["local"], sj["local"], err_msg=label)
    assert kf_frames >= 5


# ---------------------------------------------------------------------------
# The device stages from identical state
# ---------------------------------------------------------------------------


def _assert_store_close(tstate, jstate, label, loose=()):
    a, b = convert.to_numpy(tstate), convert.to_numpy(np_tree(jstate))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (label, k)
        if k in loose:
            continue
        if k in ("x", "seg"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=f"{label}.{k}")
        elif k in ("hist_pt", "hist_ln"):
            np.testing.assert_allclose(a[k], b[k], atol=0.05, err_msg=f"{label}.{k}")
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2e-4, err_msg=f"{label}.{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}.{k}")


def _jax_store(cls, tstore):
    """A store of the reference (class `cls`) from the port's."""
    return jax.tree_util.tree_map(jnp.asarray, cls(**convert.to_numpy(tstore)))


def test_make_step_vi_parity(ref_run):
    """Every fused frame of the reference run, replayed by the port from the
    reference's state: frames without a keyframe tightly, the keyframe
    frames (insertion, chain factor, VI-BA, BoW, view ring, local map) by
    what they decide and by BA's float32 bounds."""
    cfg, jt, _, rec = ref_run
    assert len(_check_fused_replay(cfg, jt, rec)) >= 1  # the keyframe branch with VI-BA was compared
    assert any(fz["wide"] for fz in rec["fused"]) and not all(fz["wide"] for fz in rec["fused"])


def _check_fused_replay(cfg, jt, rec, hold_ba=True):
    """Replays every recorded fused frame; returns how far each keyframe
    frame's window poses lie from the reference's (largest |dt| over the
    keyframes). Without `hold_ba` a keyframe frame is held only to what does
    not pass through visual-inertial BA."""
    _, tcam = _cams()
    voc = (convert.vocabulary(jt.voc_pt), convert.vocabulary(jt.voc_ln))
    step = tstep.make_step_vi(tcam, port_cfg(cfg), *voc, lambda fd: fd)
    assert len(rec["fused"]) >= 6
    kf_frames = []
    before_ba = [jtr.ST_OK, jtr.ST_NIN, jtr.ST_NKF, jtr.ST_KF_CREATED, jtr.ST_FSKF, jtr.ST_KF_SLOT]
    for i, fz in enumerate(rec["fused"]):
        s, jo = fz["state"], fz["out"]
        to = step((convert.frame_data(fz["frame"]),), fz["imu"], fz["stamp"], s["R"], s["t"], s["v_w"], s["bg"],
                  s["ba"], s["gravity_w"], s["preint_acc"], s["ext"], s["n_kf"], s["frames_since_kf"],
                  s["last_kf_inliers"], True, fz["wide"], s["pstore"], s["lstore"], s["kstore"], s["bow_db"],
                  s["kf_view"], s["local_pt"], s["pints"])
        label = f"fused frame {i}"
        stats = jo[20]
        made_kf = stats[jtr.ST_KF_CREATED] > 0
        if hold_ba or not made_kf:
            np.testing.assert_array_equal(to[20].numpy(), stats, err_msg=f"{label} stats")
        np.testing.assert_array_equal(to[20].numpy()[before_ba], stats[before_ba], err_msg=f"{label} stats")
        for j in (15, 16, 17, 18):  # pt_idx, pt_in, ln_idx, ln_in
            np.testing.assert_array_equal(to[j].numpy(), jo[j], err_msg=f"{label} out {j}")
        assert (to[19][0], to[19][1]) == tuple(int(c) for c in jo[19][:2]), label
        assert to[21][0] == int(jo[21][0])
        np.testing.assert_allclose(to[2].numpy(), jo[2], atol=1e-6)  # R_prev, t_prev: the inputs
        np.testing.assert_allclose(to[3].numpy(), jo[3], atol=1e-6)
        pose_tol, v_tol, b_tol = (3e-2, 0.1, 5e-2) if made_kf else (2e-4, 2e-3, 5e-4)
        if hold_ba or not made_kf:
            assert int(to[19][2]) == int(jo[19][2]), label
            for j, tol in ((0, pose_tol), (1, pose_tol), (4, v_tol), (5, b_tol), (6, b_tol)):
                np.testing.assert_allclose(to[j].numpy(), jo[j], atol=tol, err_msg=f"{label} out {j}")
        np.testing.assert_array_equal(to[14].valid.numpy(), jo[14].valid, err_msg=f"{label} pints.valid")
        for a, b in zip(to[12], jo[12]):  # the view ring
            np.testing.assert_array_equal(a.numpy(), b)
        if made_kf:
            n_kf = int(stats[jtr.ST_NKF])
            kf_frames.append(float(np.abs(to[10].t[:n_kf].numpy() - jo[10].t[:n_kf]).max()))
            # the accumulator starts again at the refined biases; the chain got its factor
            assert float(to[7].dt) == 0.0 and float(jo[7].dt) == 0.0
            np.testing.assert_allclose(to[7].bg.numpy(), to[5].numpy(), atol=0)
            np.testing.assert_allclose(to[14].data.dt.numpy(), jo[14].data.dt, atol=1e-6)
            np.testing.assert_allclose(to[14].data.dV.numpy(), jo[14].data.dV, atol=2e-5)
            if not hold_ba:
                continue
            loose = ("R", "t", "v_w", "bg", "ba", "x", "seg", "obs_pt", "obs_ln")
            for a, b, name in zip(to[8:11], jo[8:11], ("pstore", "lstore", "kstore")):
                _assert_store_close(a, b, f"{label} {name}", loose=loose)
            np.testing.assert_allclose(to[10].R[:n_kf].numpy(), jo[10].R[:n_kf], atol=3e-2)
            np.testing.assert_allclose(to[10].t[:n_kf].numpy(), jo[10].t[:n_kf], atol=3e-2)
            np.testing.assert_allclose(to[10].v_w[:n_kf].numpy(), jo[10].v_w[:n_kf], atol=0.1)
            np.testing.assert_array_equal(to[10].obs_pt.numpy(), jo[10].obs_pt)  # VI-BA erases no observation
            lt, lj = to[13].numpy(), jo[13]
            assert len(np.intersect1d(lt[lt >= 0], lj[lj >= 0])) >= 0.99 * (lj >= 0).sum()
        else:
            for (ka, a), (_, b) in zip(convert.to_numpy(to[7]).items(), convert.to_numpy(jo[7]).items()):
                np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-5 if ka != "cov" else 1e-11, err_msg=ka)
            for a, b, name in zip(to[8:12], jo[8:12], ("pstore", "lstore", "kstore", "bow_db")):
                _assert_store_close(a, b, f"{label} {name}")
            np.testing.assert_array_equal(to[13].numpy(), jo[13])
            np.testing.assert_allclose(to[21][1].numpy(), jo[21][1], atol=2e-4)
            np.testing.assert_allclose(to[21][2].numpy(), jo[21][2], atol=2e-4)
    return kf_frames


def _inertial_inputs(cfg, fz):
    """prev / init body states and this frame's preintegration, as the fused
    step derives them, on the reference's side (numpy leaves)."""
    s = fz["state"]
    n = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    imu = jnp.asarray(fz["imu"].numpy())
    bg, ba = n(s["bg"]), n(s["ba"])
    p = jimu.preintegrate(imu[:, 0:3], imu[:, 3:6], imu[:, 6], imu[:, 7] > 0.5, bg, ba, cfg.imu)
    ext = jinr.Extrinsics(R_cb=n(s["ext"].R_cb), t_cb=n(s["ext"].t_cb))
    prev = jinr.body_state_from_camera(n(s["R"]), n(s["t"]), n(s["v_w"]), bg, ba, ext)
    Rp, vp, pp = jimu.predict_state(prev.R_wb, prev.v_w, prev.p_w, p, bg, ba, n(s["gravity_w"]))
    return p, prev, jinr.BodyState(R_wb=Rp, p_w=pp, v_w=vp, bg=bg, ba=ba), ext


@pytest.mark.parametrize("wide", [False, True], ids=["nominal_window", "wide_window"])
def test_track_step_inertial_parity(ref_run, wide):
    cfg, jt, _, rec = ref_run
    jcam, tcam = _cams()
    fz = rec["fused"][2]
    s = fz["state"]
    p, prev, init, ext = _inertial_inputs(cfg, fz)
    jps, jls = _jax_store(type(jt.pstore), s["pstore"]), _jax_store(type(jt.lstore), s["lstore"])
    local = jnp.asarray(s["local_pt"].numpy())
    g = jnp.asarray(s["gravity_w"].numpy())
    jo = jax.jit(partial(jtr.track_step_inertial, jcam, cfg))(fz["frame"], p, prev, init, g, ext, jps, jls, local,
                                                              jnp.asarray(wide))
    to = tstep.track_step_inertial(tcam, port_cfg(cfg), convert.frame_data(fz["frame"]),
                                   convert.preintegrated(np_tree(p)), convert.body_state(np_tree(prev)),
                                   convert.body_state(np_tree(init)), s["gravity_w"], s["ext"], s["pstore"],
                                   s["lstore"], s["local_pt"], wide=wide)
    for (k, a), (_, b) in zip(convert.to_numpy(to[0]).items(), convert.to_numpy(np_tree(jo[0])).items()):
        np.testing.assert_allclose(a, b, atol={"v_w": 2e-3, "bg": 5e-4, "ba": 5e-4}.get(k, 2e-4), err_msg=k)
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=2e-4)
    np.testing.assert_allclose(to[2].numpy(), np.asarray(jo[2]), atol=2e-4)
    for i in range(3, 8):  # pt_idx, pt_in, ln_idx, ln_in, n_in
        np.testing.assert_array_equal(to[i].numpy(), np.asarray(jo[i]))
    assert int(to[7]) > 30
    _assert_store_close(to[8], jo[8], "pstore")
    _assert_store_close(to[9], jo[9], "lstore")
    # a 0-d device bool widens like the host bool
    tw = tstep.track_step_inertial(tcam, port_cfg(cfg), convert.frame_data(fz["frame"]),
                                   convert.preintegrated(np_tree(p)), convert.body_state(np_tree(prev)),
                                   convert.body_state(np_tree(init)), s["gravity_w"], s["ext"], s["pstore"],
                                   s["lstore"], s["local_pt"], wide=torch.tensor(wide))
    np.testing.assert_array_equal(tw[3].numpy(), to[3].numpy())


def _vi_objective(tcam, tcfg, kstore, pstore, lstore, window, fixed, chain, imu_mask, gravity_w, ext):
    """The visual-inertial BA objective of a map state over `window`: the
    robust visual cost plus the chain factors' information-weighted residuals."""
    from pli_slam_tpu_torch.solve import ba as tba
    from pli_slam_tpu_torch.solve import vi_ba as tvib

    base, _, _ = tstep.window_problem(kstore, pstore, lstore, window, fixed, pt_cap=tcfg.opt.ba_pt_cap,
                                      ln_cap=tcfg.opt.ba_ln_cap)
    win = window.long()
    prob = tvib.VIBAProblem(base=base, v=kstore.v_w[win], bg=kstore.bg[win], ba=kstore.ba[win], preint=chain,
                            imu_mask=imu_mask, gravity_w=gravity_w, R_cb=ext.R_cb, t_cb=ext.t_cb)
    visual = float(tba.evaluate_cost(tcam, base, base.R, base.t, base.pts, base.lns, tcfg.opt)[0])
    r = tvib.chain_linearization(prob, base.R, base.t, prob.v, prob.bg, prob.ba, tcfg.imu)[0][:, :9]
    info = torch.linalg.inv(chain.cov + torch.eye(9) * 1e-6)
    inertial = float(torch.einsum("ka,kab,kb->k", r, info, r)[imu_mask].sum())
    return visual + inertial


def test_local_inertial_ba_parity(ref_run):
    """The fused step's temporal window (the last W keyframes, padded with
    duplicates of the newest, the first two fixed) from the state the first
    fused frame starts from."""
    cfg, jt, _, rec = ref_run
    jcam, tcam = _cams()
    tcfg = port_cfg(cfg)
    s = rec["fused"][0]["state"]
    n_kf, W = s["n_kf"], cfg.opt.local_ba_window
    assert 5 <= n_kf < W
    window = np.clip(np.arange(W), 0, n_kf - 1).astype(np.int32)  # [0 .. n_kf-1, n_kf-1, ...]
    fixed = np.arange(W) < 2
    fixed[1:] |= window[1:] <= window[:-1]
    valid = s["pints"].valid.numpy()
    imu_mask = valid[window[1:]] & (window[1:] == window[:-1] + 1)
    assert imu_mask.sum() >= 3 and not imu_mask[-1]
    jks, jps, jls = (_jax_store(type(getattr(jt, name)), s[name]) for name in ("kstore", "pstore", "lstore"))
    jchain = jimu.Preintegrated(**{k: jnp.asarray(v[window[1:]]) for k, v in convert.to_numpy(s["pints"].data).items()})
    jext = jinr.Extrinsics(R_cb=jnp.asarray(s["ext"].R_cb.numpy()), t_cb=jnp.asarray(s["ext"].t_cb.numpy()))
    jo = jax.jit(partial(jtr.local_inertial_ba, jcam, cfg))(
        jks, jps, jls, jnp.asarray(window), jnp.asarray(fixed), jchain, jnp.asarray(imu_mask),
        jnp.asarray(s["gravity_w"].numpy()), jext)
    tw, tf, tm = torch.as_tensor(window), torch.as_tensor(fixed), torch.as_tensor(imu_mask)
    chain = s["pints"].gather(tw[1:])
    to = tstep.local_inertial_ba(tcam, tcfg, s["kstore"], s["pstore"], s["lstore"], tw, tf, chain, tm,
                                 s["gravity_w"], s["ext"])
    tk, jk = to[0], np_tree(jo[0])
    np.testing.assert_allclose(tk.R.numpy(), jk.R, atol=3e-2)
    np.testing.assert_allclose(tk.t.numpy(), jk.t, atol=3e-2)
    np.testing.assert_allclose(tk.v_w.numpy(), jk.v_w, atol=0.1)
    np.testing.assert_allclose(tk.bg.numpy(), jk.bg, atol=5e-2)
    np.testing.assert_allclose(tk.ba.numpy(), jk.ba, atol=5e-2)
    assert float((tk.t - s["kstore"].t).abs().max()) > 1e-5  # and it moved something
    np.testing.assert_array_equal(tk.t[window[:2]].numpy(), s["kstore"].t[window[:2]].numpy())  # the gauge stays
    # A padded window repeats the newest keyframe as fixed rows, and the result is scattered back by
    # window slot with the last write winning (XLA on the CPU, the port's scatter_set): the newest
    # keyframe's own refined pose is overwritten by its padding's unchanged one, in both packages.
    np.testing.assert_array_equal(jk.t[n_kf - 1], s["kstore"].t[n_kf - 1].numpy())
    np.testing.assert_array_equal(tk.t[n_kf - 1].numpy(), s["kstore"].t[n_kf - 1].numpy())
    assert float((tk.t[2:n_kf - 1] - s["kstore"].t[2:n_kf - 1]).abs().min()) > 0
    v = np.asarray(jo[1].valid)
    xj, xt = np.asarray(jo[1].x)[v], to[1].x.numpy()[v]
    rel = np.abs(xt - xj).max(-1) / np.linalg.norm(xj, axis=-1)
    assert np.quantile(rel, 0.9) < 0.05, np.quantile(rel, [0.5, 0.9, 1.0])
    _assert_store_close(to[0], jo[0], "kstore", loose=("R", "t", "v_w", "bg", "ba"))
    # the port's solution is no worse on the common objective (on this map neither solve lowers it much)
    sol_j = (convert.keyframe_store(np_tree(jo[0])), convert.point_store(np_tree(jo[1])),
             convert.line_store(np_tree(jo[2])))
    obj = lambda sol: _vi_objective(tcam, tcfg, *sol, tw, tf, chain, tm, s["gravity_w"], s["ext"])  # noqa: E731
    obj_0, obj_j, obj_t = obj((s["kstore"], s["pstore"], s["lstore"])), obj(sol_j), obj(to)
    assert np.isfinite(obj_0) and obj_t <= 1.1 * obj_j + 1.0, (obj_0, obj_j, obj_t)


def _to_float64(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to_float64(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x.double() if isinstance(x, torch.Tensor) and x.dtype == torch.float32 else x


def test_reduced_camera_system_float32_error_is_no_larger_than_the_references(ref_run, capsys):
    """Where the keyframe bounds above come from: the reduced camera system
    S = Hpp - W Hll^-1 W^T of the window that visual-inertial BA solves is
    formed by cancellation, and in float32 its blocks are off by percents.
    From the state before the first fused frame, the port's
    `assemble_visual` in float32 and the reference's in float32 are both held
    against the port's in float64: the port's error is at most three times
    the reference's in the worst block (measured: about equal, either may be
    the smaller), so the two packages' steps differ by float32 rounding of
    one algorithm, not by the algorithm."""
    from pli_slam_tpu.solve import ba as jba
    from pli_slam_tpu_torch.solve import ba as tba

    cfg, jt, _, rec = ref_run
    jcam, tcam = _cams()
    tcfg = port_cfg(cfg)
    s = rec["fused"][0]["state"]
    n_kf, W = s["n_kf"], cfg.opt.local_ba_window
    window = np.clip(np.arange(W), 0, n_kf - 1).astype(np.int32)
    fixed = np.arange(W) < 2
    fixed[1:] |= window[1:] <= window[:-1]
    jks, jps, jls = (_jax_store(type(getattr(jt, name)), s[name]) for name in ("kstore", "pstore", "lstore"))
    jb, _, _ = jtr.window_problem(jks, jps, jls, jnp.asarray(window), jnp.asarray(fixed),
                                  pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap)
    tb, _, _ = tstep.window_problem(s["kstore"], s["pstore"], s["lstore"], torch.as_tensor(window),
                                    torch.as_tensor(fixed), pt_cap=tcfg.opt.ba_pt_cap, ln_cap=tcfg.opt.ba_ln_cap)
    damping = np.float32(cfg.opt.damping_init)
    Sj = np.asarray(jba.assemble_visual(jcam, jb, *jba.prepare_indices(jb), jb.R, jb.t, jb.pts, jb.lns, cfg.opt,
                                        damping)[0], np.float64)
    idx = tba.prepare_indices(tb)
    St = tba.assemble_visual(tcam, tb, *idx, tb.R, tb.t, tb.pts, tb.lns, tcfg.opt,
                             torch.as_tensor(damping))[0].numpy().astype(np.float64)
    tb64 = _to_float64(tb)
    S64 = tba.assemble_visual(tcam, tb64, *idx, tb64.R, tb64.t, tb64.pts, tb64.lns, tcfg.opt,
                              torch.tensor(float(damping), dtype=torch.float64))[0]
    assert S64.dtype == torch.float64
    S64 = S64.numpy()
    live = [w for w in range(n_kf - 1) if np.abs(S64[w, w]).max() > 0]
    assert len(live) >= 3
    rel_t = [np.abs(St[w, w] - S64[w, w]).max() / np.abs(S64[w, w]).max() for w in live]
    rel_j = [np.abs(Sj[w, w] - S64[w, w]).max() / np.abs(S64[w, w]).max() for w in live]
    with capsys.disabled():
        print(f"\nreduced camera system, float32 against float64, worst entry of each pose block over its largest: "
              f"port {np.round(rel_t, 5).tolist()}, reference {np.round(rel_j, 5).tolist()}")
    assert max(rel_t) <= 3.0 * max(rel_j) + 1e-6, (rel_t, rel_j)
    assert max(rel_j) > 1e-5  # float32 rounding alone would be 1e-7: the cancellation is real


# ---------------------------------------------------------------------------
# The host pieces
# ---------------------------------------------------------------------------


def test_imu_batch_arrays_carry_the_boundary_sample(ref_run):
    """Packed [T, 8] batches against the reference's arrays for the same raw
    stream: from the second frame on the previous batch's last sample is
    prepended, so the batch spans the whole frame interval."""
    cfg, _, _, rec = ref_run
    jcam, _ = _cams()
    jt = jtr.Tracker(jcam, cfg)
    for k, (packed_t, imu) in enumerate(rec["imu"][:6]):
        packed_j = np.asarray(jt._imu_batch_arrays(imu, packed=True))
        assert packed_t.dtype == packed_j.dtype == np.float32 and packed_t.shape == (16, 8)
        np.testing.assert_array_equal(packed_t, packed_j)
        n_valid = int(packed_t[:, 7].sum())
        assert n_valid == (9 if k == 0 else 10)  # 10 raw samples: 9 gaps alone, 10 with the carried one
        if k > 0:
            np.testing.assert_allclose(packed_t[:, 6].sum(), 1.0 / cfg.fps, rtol=1e-4)
    # the four-array form, no batch at all, and a batch longer than the pad
    _, tcam = _cams()
    tt = Tracker(tcam, port_cfg(cfg), "cpu")
    for a, b in zip(tt._imu_batch_arrays(None), jt._imu_batch_arrays(None)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(0)
    long = {"gyro": rng.normal(size=(20, 3)), "acc": rng.normal(size=(20, 3)), "stamps": 5.0 + 0.005 * np.arange(20)}
    jt._last_imu_raw = tt._last_imu_raw = None
    for a, b in zip(tt._imu_batch_arrays(long), jt._imu_batch_arrays(long)):
        assert a.dtype == {np.dtype("float32"): torch.float32, np.dtype("bool"): torch.bool}[np.asarray(b).dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tt._last_imu_raw[0] == jt._last_imu_raw[0]


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


def test_deferred_fiba_queue_drains_one_chunk_per_frame(ref_run):
    """After IMU initialization a queued full-inertial-BA sweep runs one
    chunk per later frame without a keyframe, carries the live pose along,
    and `finalize` drains what is left. A loop closure's queue: the
    full-inertial-BA sweep with the IMU initialized, else ceil(gba_iters /
    gba_chunk_iters) "gba" chunks of whole-map BA, which run the same way."""
    cfg, _, tt, rec = ref_run
    tt = _copy_tracker(tt)
    assert tt.imu_ready and not tt._deferred_ba
    chunks = tt._fiba_schedule()
    assert len(chunks) == 1
    tt._deferred_ba = [("fiba", c) for c in chunks * 3]
    jcam, _ = _cams()
    frames = list(jsyn.make_sequence(jcam, N_FRAMES + 6, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55))
    left, drained_on = [3], []
    for fr in frames[N_FRAMES:]:
        imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        n_kf = tt.n_kf
        info = tt.process(np.array(fr["img_l"]), np.array(fr["img_r"]), fr["t"], imu=imu)
        assert info["state"] == TrackingState.OK
        left.append(len(tt._deferred_ba))
        drained_on.append((tt.n_kf == n_kf, left[-2] - left[-1]))
        if left[-1] == 1:
            break
    assert all(d == (1 if no_kf else 0) for no_kf, d in drained_on), drained_on
    assert left[-1] == 1 and tt._map_event_cooldown >= 1
    tt.finalize()
    assert tt._deferred_ba == [] and np.all(np.isfinite(tt.positions()))
    tt._queue_gba(inertial=True)
    assert [k for k, _ in tt._deferred_ba] == ["fiba"] * len(tt._fiba_schedule())
    tt._queue_gba(inertial=False)
    assert tt._deferred_ba == [("gba", 3)] * 4  # gba_iters 10 in chunks of 3
    R0 = tt.kstore.R.clone()
    tt.run_deferred_ba()
    assert len(tt._deferred_ba) == 3 and not torch.equal(tt.kstore.R, R0)
    tt.finalize()
    assert tt._deferred_ba == [] and np.all(np.isfinite(tt.positions()))


def _copy_tracker(tt):
    """A shallow copy is a snapshot: the tracker replaces its tensors, it never writes into them."""
    import copy

    new = copy.copy(tt)
    for name in ("_deferred_ba", "_traj_pending", "_traj_done", "stats", "imu_init_log"):
        setattr(new, name, list(getattr(tt, name)))
    new.atlas = copy.copy(tt.atlas)  # a new map appends to the Atlas's list
    new.atlas.maps = list(tt.atlas.maps)
    return new


def test_forward_time_jump_reaches_the_unported_paths(ref_run):
    """A forward jump of more than 1 s breaks the preintegration chain: once
    the IMU is initialized the map is parked in the Atlas and a new one
    starts (both packages, from the same state), before it the map is reset."""
    cfg, jt, tt, rec = ref_run
    tt = _copy_tracker(tt)
    jt = _copy_tracker(jt)
    img = np.zeros((96, 128), np.float32)
    for tr in (jt, tt):
        tr.process(img, img, tr._prev_stamp + 1.5)
        assert tr.atlas.n_maps() == 2 and not tr.imu_ready and tr.n_kf == 0
        assert tr.state == TrackingState.NOT_INITIALIZED
    _, tcam = _cams()
    fresh = Tracker(tcam, port_cfg(cfg), "cpu")
    fr = next(iter(tsyn.make_sequence(tcam, 1, "cpu", fps=cfg.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55)))
    fresh.process(fr["img_l"], fr["img_r"], 0.0)
    kstore = fresh.kstore
    fresh.process(fr["img_l"], fr["img_r"], 1.5)
    assert fresh.atlas.n_maps() == 1 and fresh.kstore is not kstore and fresh.n_kf == 1  # reset, then initialized


@pytest.mark.slow
def test_full_70_frame_run_matches_reference(capsys):
    """The 70-frame scene of tests/test_tracker_inertial.py with its own
    settings (init_min_kfs = 10): the initialization fires near frame 46 and
    some twenty fused frames follow, a third of them keyframes with
    visual-inertial BA. Two free-running trackers cannot be compared over
    this length: after the initialization every such BA moves the
    accelerometer bias further off in both packages (see the module
    docstring), a little differently in each, and the run that drifts faster
    loses tracking and reaches relocalization, which the port does not have
    yet. So every one of the reference's 70 frames is replayed by the port
    from the reference's own state: the host-orchestrated frames through the
    initialization and the fused frames without a keyframe with the bounds of
    the short run; a fused keyframe frame exactly in what does not pass
    through visual-inertial BA (matches, decisions, counters, the chain
    factor, the accumulator, the view ring). That BA itself is not held frame
    by frame here: from identical state its window poses came out 0.157,
    0.045, 1.198, 0.054, 0.017, 0.003, 0.004 and 0.010 m apart at the eight
    keyframes of this run (the third is a step that ran away in one package:
    the port's solution has seven times the reference's objective there, and
    equal objectives from the fourth on), which is the float32 error of the
    reduced camera system
    (test_reduced_camera_system_float32_error_is_no_larger_than_the_references)
    amplified by six iterations. The median stays under 0.08 m and at least
    three keyframes within the short run's 3e-2. The reference's run must
    itself pass its own test's bounds."""
    mp = _accelerator_branch()
    try:
        cfg = _cfg(init_min_kfs=10)
        jt, _, rec = _run_both(cfg, 70, record=True, free_run=False)
    finally:
        mp.undo()
    ready = [r[0] for r in rec["ready"]].index(True)
    assert 40 <= ready <= 55 and jt.imu_init_log[-1]["accepted"]
    R0, _ = jsyn.Trajectory(**TRAJ).pose(0.0)
    g = R0 @ np.asarray(jt.gravity_w)
    np.testing.assert_allclose(np.linalg.norm(g), 9.81, rtol=0.15)
    np.testing.assert_allclose(g / np.linalg.norm(g), [0, 0, -1], atol=0.12)
    assert sum(1 for ji, _ in rec["infos"] if ji["state"] == TrackingState.OK) >= 62
    path = np.linalg.norm(np.diff(rec["gt"], axis=0), axis=1).sum()
    assert jsyn.ate_rmse(jt.positions(), rec["gt"]) < 0.35 * path
    assert float(np.abs(np.asarray(jt.bg)).max()) < 0.2 and float(np.abs(np.asarray(jt.ba)).max()) < 2.0
    _check_host_lockstep(rec, ready)
    assert len(rec["fused"]) == 70 - ready - 1
    kf_dt = _check_fused_replay(cfg, jt, rec, hold_ba=False)
    with capsys.disabled():
        print(f"\nkeyframe frames, largest |dt| of the window's poses against the reference's: {np.round(kf_dt, 4).tolist()}")
    assert len(kf_dt) >= 5 and np.median(kf_dt) < 0.08 and sum(d < 3e-2 for d in kf_dt) >= 3


# (trajectory, frames, frames at which the initialization may fire, frame by which the ATE has passed 0.25 m)
FULL_WIDTH_SCENES = {
    "room": (dict(), 62, (30, 31), 51),  # the trajectory of chip_smoke.py and bench.py's visual run
    # bench.py's flagship (stereo-inertial) trajectory: under 1 m/s, "the EuRoC MAV envelope"
    "bench_flagship": (dict(amp=(1.0, 0.5, 0.3), freq=(1 / 7, 2 / 7, 3 / 7), yaw_amp=0.4, yaw_freq=1 / 7),
                       116, (72, 73, 74), 95),
}


@pytest.mark.slow
@pytest.mark.parametrize("scene", list(FULL_WIDTH_SCENES))
def test_full_width_reference_drifts_after_imu_init_too(scene, capsys):
    """What the port's full-width run on a GPU (chip_smoke.py, phase 5) is
    judged against: the reference itself, on its own CPU branch, over the
    same 752x480 scene with 200 Hz IMU under the EuRoC noise model and the
    same settings ("room"), and over bench.py's slower flagship trajectory.
    It tracks the host-orchestrated frames well and initializes the IMU with
    gravity within 8 degrees; from the first keyframe after that,
    visual-inertial BA drives velocity and accelerometer bias off, the ATE
    passes 0.25 m within some twenty frames, and tracking is lost (measured,
    room: initialization at frame 30, ATE 0.032 m there, 1.70 m at frame 51,
    lost at frame 57; flagship: frame 73, 0.017 m, 0.40 m at frame 93, lost
    at frame 112). Prints the per-frame record. Each case takes five to ten
    minutes and 2 GB."""
    traj_args, n_frames, init_frames, drifted_by = FULL_WIDTH_SCENES[scene]
    traj = jsyn.Trajectory(**traj_args)
    cfg = SlamConfig.euroc_stereo_inertial()
    cfg = dataclasses.replace(cfg, loop=LoopConfig(enabled=False),
                              imu=dataclasses.replace(cfg.imu, init_time_sec=1.5, max_samples_per_frame=16))
    cam = JCamera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
    jt = jtr.Tracker(cam, cfg)
    gt, ate, states, init_frame = [], [], [], None
    for k, fr in enumerate(jsyn.make_sequence(cam, n_frames, fps=cfg.fps, traj=traj,
                                              imu_noise=jsyn.ImuNoiseModel.euroc())):
        imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        info = jt.process(fr["img_l"], fr["img_r"], fr["t"], imu=imu)
        gt.append(fr["p_w"])
        states.append(info["state"])
        ate.append(jsyn.ate_rmse(jt.positions(), np.stack(gt)) if k > 3 else 0.0)
        if jt.imu_ready and init_frame is None:
            init_frame = k
        if jt.imu_ready:
            with capsys.disabled():
                print(f"\nreference [{scene}], frame {k}: {info['state']} inliers {info['n_inliers']} "
                      f"n_kf {info['n_kf']} |v - v_true| {np.linalg.norm(np.asarray(jt.v_w) - fr['v_w']):.3f} m/s "
                      f"ba {np.round(np.asarray(jt.ba), 3).tolist()} ATE {ate[-1]:.4f} m", end="")
    assert init_frame in init_frames and jt.imu_init_log[-1]["accepted"]
    R0, _ = traj.pose(0.0)
    assert _gravity_angle_deg(R0 @ np.asarray(jt.gravity_w), [0, 0, -9.81]) < 8.0
    assert ate[init_frame] < 0.10
    assert ate[drifted_by] > 0.25 and TrackingState.RECENTLY_LOST in states[init_frame:]
