"""bench.py's flagship path in the port against the reference: the
tracker-level inertial loop closure (verification, the 4-DoF essential
graph, the deferred full-inertial-BA sweep) held in lockstep, the 4-DoF
correction's free axis, and the port's counterpart of bench.py
(`pli_slam_tpu_torch.scripts.bench`). chip_smoke.py's phase-14a and 6a
runners at this file's size: test_torch_profile.py.

Scene: test_torch_tracker_vi's (SlamConfig.tiny_test() with
`sensor="stereo_imu"`, the 128x96 camera in the small room, IMU after
1.0 s and 5 keyframes: the initialization fires at frame 20), with loop
closing ON at its defaults. Its `min_kf_gap` of 12 keeps every BoW
candidate away on a map this young, so no closure comes before the IMU
initialization (one would go through the reference's visual `_queue_gba`,
which raises AttributeError: ROADMAP queue 3 C). The reference runs on its
accelerator branch (Pallas in interpret mode, store capacities of 2048)
through the initialization and N_FRAMES - 21 fused frames. Free runs of
the two packages drift apart after the initialization (queue 3 B1, B6),
so every check starts the port from the reference's state (`_install_vi`)
and hands both the reference's RANSAC draw (`reference_draw`).

The closure is planted after the initialization, as chip_smoke.py's phase
14a plants it: the newest keyframe against the keyframe that ground truth
says overlaps best, the consistency counter pre-set. Its matches are the
landmarks both keyframes observe, so the verified transform is near the
identity and the correction moves the map little; the correction's free
axis is held separately with a planted drift
(`test_4dof_correction_turns_gravity_unless_world_z_is_gravity`).

Tolerances:
- decisions (verified, which candidate, the queue of ("fiba", (window,
  fixed)) chunks): exact;
- the stores and the live pose after the correction: 2e-4
  (test_torch_loop's `test_apply_loop_correction_parity`: 20 Gauss-Newton
  iterations of a dense [7K, 7K] solve);
- each keyframe's gravity direction in its camera frame (roll and pitch)
  across that correction: within 1e-3 degrees in each package;
- each "fiba" chunk from the reference's state: both packages' float64
  solves of it (the reference under `jax.enable_x64`) agree to 1e-5
  (keyframes, points); the port's float32 chunk is held to that solution at
  `test_local_inertial_ba_parity`'s bounds (tests/test_torch_tracker_vi.py:
  530-533): poses 3e-2, velocities 0.1 m/s, biases 5e-2, 90% of the points
  within 5% of their distance. The reference's float32 chunk lands 4.7 cm
  from it on this map while the port's lands 0.4 cm (the float32 reduced
  camera system, queue 3 B6), so the two float32 chunks, 4.2 cm apart, are
  compared through the float64 solution and the reference's is held to it
  at 0.1 m only. The live pose, carried along, at 3e-2; after the last
  chunk v, bg and ba equal the newest keyframe's in each package (bit for
  bit) and the reference's within the bounds above, and the newest
  keyframe, which the padded window leaves in place (queue 3 B7), and the
  live pose riding it unchanged (1e-6);
- a keyframe added between the queue and the chunk: not in any window,
  still valid, its pose and the live pose unchanged by the chunk (1e-6), and
  the live v / bg / ba taken from it, in both packages;
- the 4-DoF correction of a planted 0.1 rad drift about gravity: stores
  2e-4 (far points 1e-5 relative), the keyframes' world z axes kept to
  1e-3 degrees, the turn of the gravity directions equal in both packages
  to 1e-3 degrees, above 0.05 degrees in the tracker's
  world and below 1e-3 degrees in a world turned to gravity (queue 3 B13).
"""

import copy
import dataclasses
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import reference_draw
from test_torch_mono_inertial import install
from test_torch_tracker_vi import _to_float64

from pli_slam_tpu.frontend import loop_closing as jlc
from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import imu as jimu
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.solve import inertial as jinr
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu_torch.frontend import loop_closing as tlc
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.graphs import FusedStep
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.scripts import bench
from pli_slam_tpu_torch.utils import convert, profile
from pli_slam_tpu_torch.utils import synthetic as tsyn

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = JCamera.pinhole(**CAM_ARGS), TCamera.pinhole(**CAM_ARGS)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
N_FRAMES = 26
INIT_FRAME = 20
PLANT_GAP = 4  # keyframes between the planted pair; ~10 keyframes exist at frame 25


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


def _cfg():
    base = SlamConfig.tiny_test()
    return dataclasses.replace(
        base, sensor="stereo_imu",
        imu=dataclasses.replace(base.imu, init_time_sec=1.0, max_samples_per_frame=16, init_min_kfs=5),
        map=dataclasses.replace(base.map, max_points=2048, local_map_points=2048))


def _accelerator_branch():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    return mp


def _frames(n):
    out = []
    for fr in jsyn.make_sequence(JC, n, fps=20.0, traj=jsyn.Trajectory(**TRAJ), room_half=2.55):
        out.append(dict(il=np.array(fr["img_l"]), ir=np.array(fr["img_r"]), t=fr["t"],
                        imu={"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}))
    return out


@pytest.fixture(scope="module")
def ref_run():
    """The reference tracker after N_FRAMES frames (the IMU initialized at
    INIT_FRAME, then fused frames), and the frames that follow."""
    mp = _accelerator_branch()
    try:
        cfg = _cfg()
        frames = _frames(N_FRAMES + 2)
        jt = jtr.Tracker(JC, cfg)
        ready = []
        for fr in frames[:N_FRAMES]:
            jt.process(fr["il"], fr["ir"], fr["t"], imu=fr["imu"])
            ready.append(jt.imu_ready)
        assert ready.index(True) == INIT_FRAME and jt.loop_closer.n_loops_closed == 0
        assert jt._vi_fused_active and jt.state == TrackingState.OK and not jt._deferred_ba
        yield cfg, jt, frames[N_FRAMES:], mp
    finally:
        mp.undo()


def _fork(jt):
    """A snapshot of a reference tracker that can be driven on: its arrays
    are immutable, so the containers and the loop closer are copied."""
    new = copy.copy(jt)
    for name in ("_deferred_ba", "_traj_pending", "_traj_done", "stats", "imu_init_log"):
        setattr(new, name, list(getattr(jt, name)))
    new.loop_closer = copy.copy(jt.loop_closer)
    new.atlas = copy.copy(jt.atlas)
    new.atlas.maps = list(jt.atlas.maps)
    return new


def _install_vi(tt, jt):
    """Put the port tracker `tt` into the reference tracker's state, the
    fused stereo-inertial mode, the deferred queue and the loop closer's
    counters included."""
    install(tt, jt)
    tt._vi_fused_active = jt._vi_fused_active
    tt._preint_acc = None if jt._preint_acc is None else convert.preintegrated(np_tree(jt._preint_acc))
    tt._deferred_ba = [(kind, (np.asarray(w), np.asarray(f))) for kind, (w, f) in jt._deferred_ba]
    for name in ("_consistency", "_consistent_with", "n_loops_closed", "_last_closed_kf"):
        setattr(tt.loop_closer, name, getattr(jt.loop_closer, name))


def _port_tracker(cfg, jt):
    tt = Tracker(TC, port_cfg(cfg), "cpu")
    tt.draw = tt.loop_closer.draw = reference_draw
    _install_vi(tt, jt)
    return tt


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gravity_dirs(tr):
    """Each keyframe's unit gravity direction in its camera frame (either package)."""
    g = _n(tr.gravity_w).astype(np.float64)
    return np.einsum("kij,j->ki", _n(tr.kstore.R)[:int(tr.n_kf)].astype(np.float64), g / np.linalg.norm(g))


def _plant(cfg, jt, tt):
    """The closure of chip_smoke.py's phase 14a, in both packages from the
    same state: the newest keyframe, its candidates the keyframes at least
    PLANT_GAP older, the ground-truth-nearest first. Returns (kf_cur, the
    verified candidate, the gravity directions before (reference, port))."""
    n = int(jt.n_kf)
    stamps, valid = np.asarray(jt.kstore.stamp[:n]), np.asarray(jt.kstore.valid[:n])
    cands = [(j, 1.0) for j, _ in profile.loop_candidates(stamps, valid, tsyn.Trajectory(**TRAJ), n - 1, PLANT_GAP)]
    assert cands, "no keyframe pair to plant"
    g0 = (_gravity_dirs(jt), _gravity_dirs(tt))
    closed = []
    for tr in (jt, tt):
        lc = tr.loop_closer
        lc._consistency, lc._consistent_with = cfg.loop.consistency_kfs, cands[0][0]
        closed.append(lc.on_keyframe(tr, n - 1, cands))
    assert closed == [True, True], closed
    return n - 1, g0


def _assert_stores_close(tt, jt, atol):
    for name in ("kstore", "pstore", "lstore"):
        a, b = convert.to_numpy(getattr(tt, name)), convert.to_numpy(np_tree(getattr(jt, name)))
        for k in a:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=f"{name}.{k}")
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}.{k}")


def _exact_chunk(cfg, tt, window, fixed):
    """The "fiba" chunk `(window, fixed)` from the port tracker's current
    state, solved in float64 by both packages (the reference under
    `jax.enable_x64`): (port (kstore, pstore), reference (kstore, pstore))."""
    fixed = fixed | ~tt.kstore.valid.numpy()[window]
    chain, mask = tstep.kf_chain(tt._pints, torch.as_tensor(window, dtype=torch.int32))
    tw, tf, tm = torch.as_tensor(window, dtype=torch.int32), torch.as_tensor(fixed), torch.as_tensor(mask)
    ks, ps, ls, chain64, ext64 = (_to_float64(x) for x in (tt.kstore, tt.pstore, tt.lstore, chain, tt.ext))
    out_t = tstep.local_inertial_ba(TC, port_cfg(cfg), ks, ps, ls, tw, tf, chain64, tm, tt.gravity_w.double(), ext64)

    def j64(cls, obj):
        return cls(**{k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32 else v)
                      for k, v in convert.to_numpy(obj).items()})

    with jax.enable_x64(True):
        out_j = jtr.local_inertial_ba(
            JC, cfg, j64(jst.KeyFrameStore, tt.kstore), j64(jst.PointStore, tt.pstore), j64(jst.LineStore, tt.lstore),
            jnp.asarray(window, jnp.int32), jnp.asarray(fixed), j64(jimu.Preintegrated, chain), jnp.asarray(mask),
            jnp.asarray(tt.gravity_w.numpy().astype(np.float64)), j64(jinr.Extrinsics, tt.ext))
        out_j = np_tree(out_j)
    assert out_t[0].t.dtype == torch.float64 and out_j[0].t.dtype == np.float64
    return (out_t[0], out_t[1]), (out_j[0], out_j[1])


def _kf_arrays(ks, n):
    return {name: _n(getattr(ks, name))[:n].astype(np.float64) for name in ("R", "t", "v_w", "bg", "ba")}


def _assert_chunk_close(ks, ps, ks_ref, ps_ref, n, label):
    """test_local_inertial_ba_parity's bounds between two solutions of a chunk."""
    a, b = _kf_arrays(ks, n), _kf_arrays(ks_ref, n)
    for name, tol in (("R", 3e-2), ("t", 3e-2), ("v_w", 0.1), ("bg", 5e-2), ("ba", 5e-2)):
        np.testing.assert_allclose(a[name], b[name], atol=tol, err_msg=f"{label} kstore.{name}")
    v = _n(ps_ref.valid)
    np.testing.assert_array_equal(_n(ps.valid), v, err_msg=label)
    xr, x = _n(ps_ref.x)[v].astype(np.float64), _n(ps.x)[v].astype(np.float64)
    rel = np.abs(x - xr).max(-1) / np.linalg.norm(xr, axis=-1)
    assert np.quantile(rel, 0.9) < 0.05, (label, np.quantile(rel, [0.5, 0.9, 1.0]))


def _assert_schedule_equal(tt, jt):
    assert [k for k, _ in tt._deferred_ba] == [k for k, _ in jt._deferred_ba]
    for (_, (wt, ft)), (_, (wj, fj)) in zip(tt._deferred_ba, jt._deferred_ba):
        np.testing.assert_array_equal(wt, np.asarray(wj))
        np.testing.assert_array_equal(ft, np.asarray(fj))


def _run_chunks(cfg, jt, tt):
    """Each queued chunk in both packages, the port from the reference's
    state. The algorithm is held where rounding does not decide it: both
    packages' float64 solves of the chunk agree to 1e-5. The port's float32
    chunk is held to that solution at test_local_inertial_ba_parity's bounds;
    the reference's float32 chunk only to 0.1 m of it: on this scene it
    lands up to 4.7 cm from it while the port's lands within 0.5 cm (the
    float32 reduced camera system, ROADMAP queue 3 B6). The live pose,
    carried along relative to the newest keyframe, at 3e-2; after the last
    chunk v, bg and ba are the newest keyframe's. Returns per chunk the
    largest keyframe distance of each package's float32 chunk from the
    float64 solution (port, reference)."""
    dists = []
    while jt._deferred_ba:
        _install_vi(tt, jt)
        _, (w, f) = tt._deferred_ba[0]
        (ks_t, ps_t), (ks_j, ps_j) = _exact_chunk(cfg, tt, w, f)
        tt.run_deferred_ba(1)
        jt.run_deferred_ba(1)
        n, label = int(jt.n_kf), f"fiba chunk {len(dists) + 1}"
        a, b = _kf_arrays(ks_t, n), _kf_arrays(ks_j, n)
        for name in a:
            np.testing.assert_allclose(a[name], b[name], atol=1e-5, err_msg=f"{label} float64 {name}")
        np.testing.assert_allclose(ps_t.x.numpy(), ps_j.x, atol=1e-5, err_msg=f"{label} float64 points")
        _assert_chunk_close(tt.kstore, tt.pstore, ks_t, ps_t, n, f"{label}, the port's float32 chunk")
        d_t, d_j = (float(np.abs(_n(ks.t)[:n] - a["t"]).max()) for ks in (tt.kstore, jt.kstore))
        assert d_j < 0.1, (label, d_j)
        dists.append((d_t, d_j))
        np.testing.assert_array_equal(tt.kstore.valid.numpy(), np.asarray(jt.kstore.valid), err_msg=label)
        np.testing.assert_allclose(tt.R.numpy(), np.asarray(jt.R), atol=3e-2, err_msg=f"{label} live R")
        np.testing.assert_allclose(tt.t.numpy(), np.asarray(jt.t), atol=3e-2, err_msg=f"{label} live t")
        assert len(tt._deferred_ba) == len(jt._deferred_ba)
        assert tt._map_event_cooldown == jt._map_event_cooldown
    assert not tt._deferred_ba
    k = int(jt.n_kf) - 1
    for name, tol in (("v_w", 0.1), ("bg", 5e-2), ("ba", 5e-2)):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), getattr(tt.kstore, name)[k].numpy())
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)), np.asarray(getattr(jt.kstore, name)[k]))
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)), atol=tol, err_msg=name)
    return dists


def test_inertial_closure_lockstep(ref_run):
    """The planted closure after the IMU initialization in both packages
    from the same state: verified, the 4-DoF correction, the queued "fiba"
    sweep exactly, roll and pitch of every keyframe kept; then each chunk
    from the reference's state, and the live state after the last."""
    cfg, ref, _, _ = ref_run
    jt = _fork(ref)
    tt = _port_tracker(cfg, jt)
    assert tt.imu_ready and jt.imu_ready
    kf_cur, (gj0, gt0) = _plant(cfg, jt, tt)
    assert jt.loop_closer.n_loops_closed == tt.loop_closer.n_loops_closed == 1
    assert jt.loop_closer._last_closed_kf == tt.loop_closer._last_closed_kf == kf_cur
    _assert_stores_close(tt, jt, 2e-4)
    np.testing.assert_allclose(tt.R.numpy(), np.asarray(jt.R), atol=2e-4)
    np.testing.assert_allclose(tt.t.numpy(), np.asarray(jt.t), atol=2e-4)
    valid = np.asarray(jt.kstore.valid[:jt.n_kf])
    dg_j = profile.gravity_turn_deg(gj0, _gravity_dirs(jt))[valid].max()
    dg_t = profile.gravity_turn_deg(gt0, _gravity_dirs(tt))[valid].max()
    assert dg_j < 1e-3 and dg_t < 1e-3, (dg_j, dg_t)
    # the whole-map sweep, drawn at queue time: one window of the smallest padded capacity that holds the map
    _assert_schedule_equal(tt, jt)
    cap = next(c for c in Tracker._FIBA_CAPS if c >= tt.n_kf)
    assert [k for k, _ in tt._deferred_ba] == ["fiba"] and len(tt._deferred_ba[0][1][0]) == cap
    assert tt._map_event_cooldown == jt._map_event_cooldown == 5
    newest = [(_n(tr.kstore.t)[kf_cur].copy(), _n(tr.t).copy()) for tr in (jt, tt)]
    dists = _run_chunks(cfg, jt, tt)
    assert len(dists) == 1 and dists[0][0] < 3e-2, dists
    # the padded window's last write leaves the newest keyframe, and the live pose riding it, in place (B7)
    for tr, (kt0, t0) in zip((jt, tt), newest):
        np.testing.assert_allclose(_n(tr.kstore.t)[kf_cur], kt0, atol=1e-6)
        np.testing.assert_allclose(_n(tr.t), t0, atol=1e-6)


def test_keyframe_added_after_the_queue(ref_run):
    """The sweep's windows are drawn when the closure queues it. A keyframe
    made on the next frame (the fused step's keyframe branch, forced by the
    keyframe counter, replayed by the port from the reference's state on the
    reference's FrameData) lies in no window: the chunk neither drops nor
    moves it, and the live state, carried relative to the newest keyframe,
    stays with it, in both packages."""
    cfg, ref, frames, _ = ref_run
    jt = _fork(ref)
    tt = _port_tracker(cfg, jt)
    _plant(cfg, jt, tt)
    _install_vi(tt, jt)
    n_queued = len(jt._deferred_ba)
    fr = frames[0]
    jt.frames_since_kf = tt.frames_since_kf = cfg.tracking.kf_max_interval
    tt._step_vi = FusedStep(tstep.vi_segments(TC, port_cfg(cfg), convert.vocabulary(jt.voc_pt),
                                              convert.vocabulary(jt.voc_ln), lambda fd: fd), "cpu", graphs=False)
    fd = convert.frame_data(np_tree(jt.build_frame(fr["il"], fr["ir"])))
    n_kf = int(jt.n_kf)
    info_t = tt._process_fused_vi((fd,), fr["t"], True, fr["imu"])
    info_j = jt.process(fr["il"], fr["ir"], fr["t"], imu=fr["imu"])
    assert info_t["state"] == info_j["state"] == TrackingState.OK
    assert int(tt.n_kf) == int(jt.n_kf) == n_kf + 1  # the keyframe branch, and no chunk on that frame
    assert len(tt._deferred_ba) == len(jt._deferred_ba) == n_queued
    new = n_kf
    for _, (w, _f) in jt._deferred_ba:
        assert new not in np.asarray(w)
    _install_vi(tt, jt)
    live = [(_n(tr.R).copy(), _n(tr.t).copy()) for tr in (jt, tt)]
    kf_new = [(_n(tr.kstore.R[new]).copy(), _n(tr.kstore.t[new]).copy()) for tr in (jt, tt)]
    assert len(_run_chunks(cfg, jt, tt)) == n_queued
    for tr, (R0, t0), (kR0, kt0) in zip((jt, tt), live, kf_new):
        assert bool(_n(tr.kstore.valid)[new])
        np.testing.assert_array_equal(_n(tr.kstore.R[new]), kR0)
        np.testing.assert_array_equal(_n(tr.kstore.t[new]), kt0)
        np.testing.assert_allclose(_n(tr.R), R0, atol=1e-6)
        np.testing.assert_allclose(_n(tr.t), t0, atol=1e-6)
        for name in ("v_w", "bg", "ba"):
            np.testing.assert_array_equal(_n(getattr(tr, name)), _n(getattr(tr.kstore, name)[new]))


def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _rotate_world(jt, R_a):
    """The reference's stores, gravity and a loop transform expressed in a
    world turned by R_a (x' = R_a x): keyframe rotations R_cw R_a^T, points
    and line endpoints R_a x."""
    R_a = jnp.asarray(R_a, jnp.float32)
    ks = dataclasses.replace(jt.kstore, R=jnp.einsum("kij,lj->kil", jt.kstore.R, R_a))
    ps = dataclasses.replace(jt.pstore, x=jnp.einsum("ij,nj->ni", R_a, jt.pstore.x))
    seg = jt.lstore.seg
    ls = dataclasses.replace(jt.lstore, seg=jnp.concatenate([jnp.einsum("ij,nj->ni", R_a, seg[:, :3]),
                                                             jnp.einsum("ij,nj->ni", R_a, seg[:, 3:])], -1))
    return (ks, ps, ls), R_a @ jt.gravity_w


@pytest.mark.parametrize("world", ["tracker_world", "gravity_aligned"])
def test_4dof_correction_turns_gravity_unless_world_z_is_gravity(ref_run, world):
    """The 4-DoF essential graph frees the rotation about the WORLD z axis
    (dofs 3, 4 and 6 pinned, the increment applied on the right), which is
    yaw only when gravity lies along z. The tracker's world is its first
    camera's frame, and neither package turns it to gravity at the IMU
    initialization (ROADMAP queue 3 B13). A loop drift of 0.1 rad about
    gravity, corrected on the reference's map in both packages (stores within
    2e-4, far points 1e-5 relative), every keyframe's world z axis kept
    (1e-3 degrees) and its gravity turn what `b13_gravity_turn_deg` predicts
    from its rotation about world z (1e-3 degrees) in both: in the tracker's world (gravity 2.1
    degrees off z on this scene; a horizontal camera puts it near 90) the
    correction turns keyframes' gravity directions by 0.18 degrees, the same
    in both to 1e-3 degrees; with the world turned so that gravity is -z, it
    keeps them (< 1e-3 degrees)."""
    cfg, ref, _, _ = ref_run
    jt = _fork(ref)
    n = int(jt.n_kf)
    g = np.asarray(jt.gravity_w, np.float64)
    tilt = np.degrees(np.arccos(-g[2] / np.linalg.norm(g)))
    R_a = np.eye(3)
    if world == "gravity_aligned":
        axis = np.cross(g, [0.0, 0.0, -1.0])
        R_a = _rotation(axis, np.radians(tilt))
    (ks, ps, ls), g_w = _rotate_world(jt, R_a)
    g_w = np.asarray(g_w, np.float64)
    assert np.degrees(np.arccos(-g_w[2] / np.linalg.norm(g_w))) < (1e-3 if world == "gravity_aligned" else 90.0)
    R_rel = (R_a @ _rotation(g, 0.1) @ R_a.T).astype(np.float32)
    t_rel = (R_a @ np.array([0.05, -0.03, 0.02])).astype(np.float32)
    kf_cur, kf_loop = n - 1, 0
    out_j = jlc.apply_loop_correction(ks, ps, ls, n, kf_cur, kf_loop, jnp.asarray(R_rel), jnp.asarray(t_rel), cfg,
                                      inertial=True)
    stores_t = (convert.keyframe_store(np_tree(ks)), convert.point_store(np_tree(ps)), convert.line_store(np_tree(ls)))
    out_t = tlc.apply_loop_correction(*stores_t, kf_cur, kf_loop, torch.as_tensor(R_rel), torch.as_tensor(t_rel),
                                      port_cfg(cfg), inertial=True)
    for a, b in zip(out_t, out_j):
        a, b = convert.to_numpy(a), convert.to_numpy(np_tree(b))
        for k in a:  # rtol: a far point (~160 m here) moves by the poses' 1e-6 rad over its lever arm
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=2e-4, err_msg=k)
    valid = np.asarray(jt.kstore.valid[:n])
    gu = g_w / np.linalg.norm(g_w)

    def dirs(R):
        return np.einsum("kij,j->ki", np.asarray(R)[:n].astype(np.float64), gu)

    d0 = dirs(ks.R)
    dg_j = profile.gravity_turn_deg(d0, dirs(out_j[0].R))[valid].max()
    dg_t = profile.gravity_turn_deg(d0, dirs(out_t[0].R.numpy()))[valid].max()
    # what the graph keeps: every keyframe's world z axis in its camera frame
    z0 = np.asarray(ks.R)[:n, :, 2].astype(np.float64)
    for R in (np.asarray(out_j[0].R), out_t[0].R.numpy()):
        assert profile.gravity_turn_deg(z0, R[:n, :, 2].astype(np.float64))[valid].max() < 1e-3
        # and each keyframe's gravity turn is the one B13 predicts from its own rotation about world z
        excess = profile.gravity_turn_deg(d0, dirs(R)) - profile.b13_gravity_turn_deg(np.asarray(ks.R)[:n], R[:n], g_w)
        assert np.abs(excess)[valid].max() < 1e-3, excess
    moved = np.linalg.norm(np.asarray(out_j[0].t)[:n] - np.asarray(ks.t)[:n], axis=1).max()
    print(f"\n4-DoF correction in the {world}: gravity {tilt:.3f} deg off -z, keyframes moved up to {moved:.4f} m, "
          f"largest change of a keyframe's gravity direction {dg_j:.5f} deg (reference) / {dg_t:.5f} deg (port)")
    assert moved > 0.02  # the correction does move the map
    assert abs(dg_t - dg_j) < 1e-3, (dg_t, dg_j)
    if world == "gravity_aligned":
        assert dg_j < 1e-3 and dg_t < 1e-3, (dg_j, dg_t)
    else:
        assert tilt > 1.0
        assert dg_j > 0.05 and dg_t > 0.05, (dg_j, dg_t, tilt)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 14a runner, and the bench program, on the port alone
# ---------------------------------------------------------------------------


def _flagship_tiny_cfg(loop=None):
    """The flagship configuration's form at the test's size: the tiny
    capacities, stereo-inertial, loop closing on, bench.py's IMU settings
    but for an initialization after 1.0 s and 5 keyframes."""
    base = port_cfg(SlamConfig.tiny_test())
    return dataclasses.replace(
        base, sensor="stereo_imu",
        imu=dataclasses.replace(base.imu, init_time_sec=1.0, max_samples_per_frame=16, init_min_kfs=5),
        tracking=dataclasses.replace(base.tracking, kf_max_new_points=256),
        loop=dataclasses.replace(base.loop, **(loop or {})))


def test_bench_prints_bench_py_line(monkeypatch, capsys):
    """`python3 -m pli_slam_tpu_torch.scripts.bench --cpu` at the test's size
    (both runs given the test's camera and configurations through their
    `cam=` / `cfg=` arguments; 30 + 9 frames): one JSON
    line on stdout, whose keys, those of "extra" included, are the ones
    bench.py's source prints (read with `ast`; bench.py sets a JAX compile
    cache at import and is not imported), and the flagship run initializes
    the IMU."""
    import chip_smoke

    monkeypatch.setattr(bench, "run_flagship", partial(bench.run_flagship, cam=TC, cfg=_flagship_tiny_cfg()))
    monkeypatch.setattr(bench, "run_visual",
                        partial(bench.run_visual, cam=TC, cfg=port_cfg(SlamConfig.tiny_test())))
    monkeypatch.setenv("BENCH_FRAMES", "30")
    monkeypatch.setenv("BENCH_FRAMES_VISUAL", "9")
    result = bench.main(["--cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == result
    keys, extra = chip_smoke.bench_line_keys(os.path.join(ROOT, "bench.py"))
    assert sorted(result) == sorted(keys) and sorted(result["extra"]) == sorted(extra)
    assert len(extra) == 12 and result["metric"] == "stereo_inertial_tracking_fps_752x480"
    assert result["extra"]["imu_ready"] is True and result["extra"]["frames"] == 30
    assert np.isfinite(result["extra"]["ate_m_synthetic"]) and np.isfinite(result["extra"]["visual_ate_m"])
    assert result["value"] > 0 and result["vs_baseline"] == round(result["value"] / 20.0, 3)


def test_flagship_config_is_bench_pys():
    """`utils.profile.flagship_config()` (the bench program's and phase 14's)
    is the reference's SlamConfig.euroc_stereo_inertial() with bench.py's
    replacements (bench.py:84-91), loop closing on."""
    ref = SlamConfig.euroc_stereo_inertial()
    ref = dataclasses.replace(ref, imu=dataclasses.replace(ref.imu, init_time_sec=1.5, max_samples_per_frame=16),
                              tracking=dataclasses.replace(ref.tracking, kf_max_new_points=256))
    assert profile.flagship_config() == port_cfg(ref) and profile.flagship_config().loop.enabled


@pytest.mark.parametrize("min_gap", [1, 3, 12])
def test_overlapping_pair_and_loop_candidates(min_gap):
    """Phase 6a's `overlapping_pair` and phase 14a's `loop_candidates` against
    the reference-side copy of test_torch_loop (`_overlapping_pair`), on
    keyframe stamps of the flagship trajectory with a culled keyframe."""
    from test_torch_loop import _overlapping_pair

    traj = tsyn.Trajectory(**profile.FLAGSHIP_TRAJ)
    stamps = np.linspace(0.0, 8.0, 19).astype(np.float32)
    valid = np.ones(19, bool)
    valid[4] = False
    ks = type("KS", (), dict(stamp=torch.as_tensor(stamps), valid=torch.as_tensor(valid)))
    tr = type("Tr", (), dict(n_kf=19, kstore=ks))
    assert profile.overlapping_pair(tr, traj, min_gap) == _overlapping_pair(stamps, valid, traj, min_gap)
    cands = profile.loop_candidates(stamps, valid, traj, 18, min_gap)
    assert [j for j, _ in cands] == sorted((j for j in range(19 - min_gap) if valid[j]),
                                          key=lambda j: dict(cands)[j])
    assert 4 not in dict(cands) and all(a[1] <= b[1] for a, b in zip(cands, cands[1:]))


def test_bench_needs_a_gpu_without_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)
