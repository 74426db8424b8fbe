"""The port's device program (frontend.step) against the reference's
functions in frontend/tracker.py, with the reference's Pallas branch taken.

The port follows the reference's ACCELERATOR branch on every device (the
fused gated-match kernel in tracking and in the keyframe fuse). On the
CPU the reference takes a dense branch with a different fuse, so here
`jax.default_backend` is patched to report an accelerator and
`gated_match_pallas` runs in interpret mode; nothing in the JAX package
changes. Capacities are tiny_test's with max_points = local_map_points =
2048, a multiple of the kernel's 2048-row tile.

Both packages start every comparison from identical state (numpy trees
converted with pli_slam_tpu_torch.utils.convert) and get the same
FrameData (the reference's build_frame output), so only the step itself
is compared. Tolerances: integer bookkeeping, masks, ids and keyframe
decisions exact; poses 1e-4; landmark positions 1e-3 m (GN in float32
through another LAPACK path); BoW histograms 0.05 (LSH word bits at
float rounding of 0, see worldmap.vocab). A frame that runs windowed BA
is held to looser, stated bounds (`_assert_after_ba`).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.frontend.frame import make_build_frame
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu.worldmap import vocab as jvoc
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
N_FRAMES = 6


def _cfg():
    cfg = SlamConfig.tiny_test()
    # a keyframe every second frame, so five steps reach windowed BA (n_kf >= 3)
    return dataclasses.replace(cfg, loop=LoopConfig(enabled=False),
                               tracking=dataclasses.replace(cfg.tracking, kf_max_interval=2),
                               map=dataclasses.replace(cfg.map, max_points=2048, local_map_points=2048))


def port_cfg(cfg):
    """The port's twin of a JAX-package config: the port never sees that package's objects."""
    return convert.config_from_reference(dataclasses.asdict(cfg))


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


@pytest.fixture(scope="module")
def env():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    cfg = _cfg()
    jcam = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    tcam = convert.camera(np_tree(jcam))
    traj = jsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    build = make_build_frame(jcam, cfg)
    frames = [np_tree(build(fr["img_l"], fr["img_r"]))
              for fr in jsyn.make_sequence(jcam, N_FRAMES, fps=cfg.fps, traj=traj, room_half=2.55)]
    m = cfg.map
    empty = (np_tree(jst.PointStore.empty(m.max_points)), np_tree(jst.LineStore.empty(m.max_lines)),
             np_tree(jst.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines)))
    yield cfg, jcam, tcam, frames, empty
    mp.undo()


def assert_state_close(tstate, jstate, label):
    a, b = convert.to_numpy(tstate), convert.to_numpy(np_tree(jstate))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, (label, k, a[k].dtype, b[k].dtype)
        if k in ("x", "seg"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-3, err_msg=f"{label}.{k}")
        elif k in ("R", "t", "obs_l"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=f"{label}.{k}")
        elif k in ("hist_pt", "hist_ln"):
            np.testing.assert_allclose(a[k], b[k], atol=0.05, err_msg=f"{label}.{k}")
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4, err_msg=f"{label}.{k}")
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{label}.{k}")


def _insert_kf0(cfg, jcam, tcam, frame, empty, kf_slot=0):
    n, nl = frame.feats.uv.shape[0], frame.lines.angle.shape[0]
    neg, negl = np.full(n, -1, np.int32), np.full(nl, -1, np.int32)
    fm, lm = np.zeros(n, bool), np.zeros(nl, bool)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jout = jax.jit(partial(jtr.insert_keyframe, jcam, cfg))(frame, eye, zero, 0.0, neg, fm, negl, lm, kf_slot,
                                                            *empty)
    T = torch.as_tensor
    tout = tstep.insert_keyframe(tcam, port_cfg(cfg), convert.frame_data(frame), T(eye), T(zero), 0.0, T(neg), T(fm),
                                 T(negl), T(lm), kf_slot, convert.point_store(empty[0]),
                                 convert.line_store(empty[1]), convert.keyframe_store(empty[2]))
    return jout, tout


@pytest.mark.parametrize("capped", [False, True], ids=["kf0", "creation_cap_ties"])
def test_insert_keyframe_parity(env, capped):
    """KF0 from empty stores; and a later keyframe whose per-KF creation
    budget (kf_max_new_points, closest first) cuts through equal depths:
    depths rounded to 5 cm so that many candidates tie at the cut, which
    `jax.lax.top_k` and the port both resolve by the lower index."""
    cfg, jcam, tcam, frames, empty = env
    frame, kf_slot = frames[0], 0
    if capped:
        cfg = dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, kf_max_new_points=24))
        frame = dataclasses.replace(frame, depth=np.where(frame.depth > 0, np.round(frame.depth * 20) / 20,
                                                          frame.depth).astype(np.float32))
        kf_slot = 1
    jout, tout = _insert_kf0(cfg, jcam, tcam, frame, empty, kf_slot)
    for a, b, name in zip(tout[:3], jout[:3], ("pstore", "lstore", "kstore")):
        assert_state_close(a, b, name)
    assert int(tout[3]) == int(jout[3]) > 20
    if capped:
        # the cut applied: ~100 candidates without it; every candidate tied
        # with the 24th passes (`>= kth`), in both packages alike
        assert 24 < int(jout[3]) < 60


def test_track_step_parity(env):
    """Frame 1 tracked against KF0's map from identical state, wide window."""
    cfg, jcam, tcam, frames, empty = env
    jout, _ = _insert_kf0(cfg, jcam, tcam, frames[0], empty)
    ps, ls, ks = (np_tree(x) for x in jout[:3])
    local = np.asarray(jtr._local_map_ids(cfg, ks, ps, 0))
    local_t = tstep._local_map_ids(port_cfg(cfg), convert.keyframe_store(ks), convert.point_store(ps), 0)
    np.testing.assert_array_equal(local_t.numpy(), local)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jr = jax.jit(partial(jtr.track_step, jcam, cfg))(frames[1], eye, zero, ps, ls, jnp.asarray(True), local)
    T = torch.as_tensor
    tr = tstep.track_step(tcam, port_cfg(cfg), convert.frame_data(frames[1]), T(eye), T(zero), convert.point_store(ps),
                          convert.line_store(ls), torch.tensor(True), local_t)
    np.testing.assert_allclose(tr[0].numpy(), np.asarray(jr[0]), atol=1e-4)
    np.testing.assert_allclose(tr[1].numpy(), np.asarray(jr[1]), atol=1e-4)
    for i in range(2, 7):  # pt_idx, pt_in, ln_idx, ln_in, n_in
        np.testing.assert_array_equal(tr[i].numpy(), np.asarray(jr[i]))
    assert int(tr[6]) > 30
    assert_state_close(tr[7], jr[7], "pstore")
    assert_state_close(tr[8], jr[8], "lstore")


def _torch_state(js):
    """The reference's carried state, converted: every step starts both
    packages from identical state, so each frame is a one-step comparison."""
    T = lambda x: convert.tensor(np.asarray(x))  # noqa: E731
    return dict(R=T(js["R"]), t=T(js["t"]), R_prev=T(js["R_prev"]), t_prev=T(js["t_prev"]), vel=T(js["vel"]),
                has_vel=T(js["has_vel"]), n_kf=int(js["n_kf"]), fs=int(js["fs"]), last=int(js["last"]),
                ps=convert.point_store(np_tree(js["ps"])), ls=convert.line_store(np_tree(js["ls"])),
                ks=convert.keyframe_store(np_tree(js["ks"])), db=convert.bow_database(np_tree(js["db"])),
                view=tuple(T(v) for v in js["view"]), local=T(js["local"]))


def _ba_objective(cfg, cam, jo, solution, kf_slot):
    """The windowed-BA cost of `solution` = (pstore, lstore, kstore) on the
    reference's post-BA window problem: same window, same kept observations."""
    ps = dataclasses.replace(convert.point_store(np_tree(jo[6])), x=solution[0].x)
    ls = dataclasses.replace(convert.line_store(np_tree(jo[7])), seg=solution[1].seg)
    ks = dataclasses.replace(convert.keyframe_store(np_tree(jo[8])), R=solution[2].R, t=solution[2].t)
    cfg = port_cfg(cfg)
    window, fixed = tstep._covis_window(cfg, ks, kf_slot, kf_slot + 1)
    prob, _, _ = tstep.window_problem(ks, ps, ls, window, fixed, pt_cap=cfg.opt.ba_pt_cap, ln_cap=cfg.opt.ba_ln_cap)
    return float(tba.evaluate_cost(cam, prob, prob.R, prob.t, prob.pts, prob.lns, cfg.opt)[0])


def _assert_after_ba(to, jo, label):
    """After windowed BA the float32 reduced camera system is dominated by
    cancellation (S = Hpp - W Hll^-1 W^T with freshly created, singly
    observed landmarks): on this map one iteration's pose step differs
    between the packages by ~2e-3 rad from identical input, and each is
    as far from a float64 solve of the same system. So the BA outputs are
    held to what BA decides, not to bits: window poses within 5e-3,
    points 90% within 3% of their distance (all within 10%), erased
    observations within 1%, and every field BA does not write exactly.
    Line endpoints are not compared here: lines enter BA only through
    mono endpoint-to-line residuals, and over keyframes ~10 cm apart
    their depth is all but unobservable, so the two float32 solves place
    them differently; `_ba_objective` holds both solutions to the BA cost
    instead."""
    np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=5e-3, err_msg=f"{label} R")
    np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=5e-3, err_msg=f"{label} t")
    a = {k: convert.to_numpy(x) for k, x in zip(("p", "l", "k"), to[6:9])}
    b = {k: convert.to_numpy(np_tree(x)) for k, x in zip(("p", "l", "k"), jo[6:9])}
    for fam in ("p", "l"):
        for f in a[fam]:
            if f == "x":
                v = b[fam]["valid"]
                rel = np.abs(a[fam][f] - b[fam][f]).max(-1)[v] / np.linalg.norm(b[fam][f][v], axis=-1)
                assert np.quantile(rel, 0.9) < 0.03 and rel.max() < 0.1, (label, np.quantile(rel, [0.9, 1.0]))
            elif f != "seg":
                np.testing.assert_array_equal(a[fam][f], b[fam][f], err_msg=f"{label} {fam}.{f}")
    for f in a["k"]:
        if f in ("R", "t"):
            np.testing.assert_allclose(a["k"][f], b["k"][f], atol=5e-3, err_msg=f"{label} kstore.{f}")
        elif f in ("obs_pt", "obs_ln"):
            assert (a["k"][f] != b["k"][f]).mean() <= 0.01, (label, f)
        elif a["k"][f].dtype.kind == "f":
            np.testing.assert_allclose(a["k"][f], b["k"][f], rtol=1e-5, atol=1e-4, err_msg=f"{label} kstore.{f}")
        else:
            np.testing.assert_array_equal(a["k"][f], b["k"][f], err_msg=f"{label} kstore.{f}")
    lt, lj = to[11].numpy(), np.asarray(jo[11])
    assert len(np.intersect1d(lt[lt >= 0], lj[lj >= 0])) >= 0.99 * (lj >= 0).sum()


def test_make_step_visual_parity(env):
    """KF0 + five fused steps (keyframes at steps 2 and 4, windowed BA at
    step 4), each from the reference's state; per frame: the stats vector
    (ok, inliers, KF decision, n_kf, new landmarks, store counts), pose,
    velocity, matches, trajectory record, counters and the whole map."""
    cfg, jcam, tcam, frames, empty = env
    jout, _ = _insert_kf0(cfg, jcam, tcam, frames[0], empty)
    voc_j = (jvoc.Vocabulary(seed=17), jvoc.Vocabulary(seed=23))
    voc_t = tuple(convert.vocabulary(v) for v in voc_j)
    jstep = jtr.make_step_visual(jcam, cfg, *voc_j, lambda fd: fd)
    tstep_fn = tstep.make_step_visual(tcam, port_cfg(cfg), *voc_t, lambda fd: fd)
    K, n_words = cfg.map.max_keyframes, voc_j[0].n_words

    n_stereo = int((frames[0].stereo_ok & frames[0].feats.valid).sum())
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    ps, ls, ks = jout[:3]
    js = dict(R=eye, t=zero, R_prev=eye, t_prev=zero, vel=np.zeros(6, np.float32), has_vel=False, n_kf=1, fs=0,
              last=n_stereo, ps=ps, ls=ls, ks=ks, db=jvoc.BowDatabase.empty(K, n_words),
              view=jtr._empty_kf_views(cfg), local=jtr._local_map_ids(cfg, ks, ps, 0))
    kf_steps, ba_steps = [], []
    for k in range(1, N_FRAMES):
        stamp = k / cfg.fps
        ts = _torch_state(js)
        jo = jstep((frames[k],), stamp, js["R"], js["t"], js["R_prev"], js["t_prev"], js["vel"], js["has_vel"],
                   js["n_kf"], js["fs"], js["last"], True, js["ps"], js["ls"], js["ks"], js["db"], js["view"],
                   js["local"])
        to = tstep_fn((convert.frame_data(frames[k]),), stamp, ts["R"], ts["t"], ts["R_prev"], ts["t_prev"],
                      ts["vel"], ts["has_vel"], ts["n_kf"], ts["fs"], ts["last"], True, ts["ps"], ts["ls"],
                      ts["ks"], ts["db"], ts["view"], ts["local"])
        label = f"frame {k}"
        stats = np.asarray(jo[17])
        np.testing.assert_array_equal(to[17].numpy(), stats, err_msg=f"{label} stats")
        for i in (12, 13, 14, 15):  # pt_idx, pt_in, ln_idx, ln_in
            np.testing.assert_array_equal(to[i].numpy(), np.asarray(jo[i]), err_msg=f"{label} out {i}")
        np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]), atol=1e-4, err_msg=f"{label} vel")
        assert bool(to[5]) == bool(jo[5])
        assert (to[16][0], to[16][1], int(to[16][2])) == tuple(int(c) for c in jo[16])
        assert to[18][0] == int(jo[18][0])
        for a, b in zip(to[10], jo[10]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert_state_close(to[9], jo[9], f"{label} bow_db")
        if stats[jtr.ST_KF_CREATED] > 0:
            kf_steps.append(k)
        if stats[jtr.ST_KF_CREATED] > 0 and stats[jtr.ST_NKF] >= 3:
            ba_steps.append(k)
            _assert_after_ba(to, jo, label)
            # both solutions are equally good minima of the same BA objective
            kf_slot = int(stats[jtr.ST_KF_SLOT])
            cost_j = _ba_objective(cfg, tcam, jo, (convert.point_store(np_tree(jo[6])),
                                                   convert.line_store(np_tree(jo[7])),
                                                   convert.keyframe_store(np_tree(jo[8]))), kf_slot)
            cost_t = _ba_objective(cfg, tcam, jo, to[6:9], kf_slot)
            assert cost_t <= 1.1 * cost_j + 1.0, (label, cost_t, cost_j)
        else:
            np.testing.assert_allclose(to[0].numpy(), np.asarray(jo[0]), atol=1e-4, err_msg=f"{label} R")
            np.testing.assert_allclose(to[1].numpy(), np.asarray(jo[1]), atol=1e-4, err_msg=f"{label} t")
            np.testing.assert_allclose(to[18][1].numpy(), np.asarray(jo[18][1]), atol=1e-4)
            np.testing.assert_allclose(to[18][2].numpy(), np.asarray(jo[18][2]), atol=1e-4)
            for a, b, name in zip(to[6:9], jo[6:9], ("pstore", "lstore", "kstore")):
                assert_state_close(a, b, f"{label} {name}")
            np.testing.assert_array_equal(to[11].numpy(), np.asarray(jo[11]))
        js.update(R=jo[0], t=jo[1], R_prev=jo[2], t_prev=jo[3], vel=jo[4], has_vel=jo[5], ps=jo[6], ls=jo[7],
                  ks=jo[8], db=jo[9], view=jo[10], local=jo[11], n_kf=jo[16][0], fs=jo[16][1], last=jo[16][2])
    # the keyframe branch ran: insert + far-point triangulation + BoW, and windowed BA
    assert kf_steps == [2, 4] and ba_steps == [4], (kf_steps, ba_steps)


def test_window_helpers_parity(env):
    """_covis_window / _device_cull_keyframes / _compact_ids on a built map."""
    cfg, _, _, _, empty = env
    rng = np.random.default_rng(0)
    K = cfg.map.max_keyframes
    ks = empty[2]
    covis = rng.integers(0, 40, size=(K, K)).astype(np.int32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    valid = np.arange(K) < 9
    valid[4] = False
    ks = dataclasses.replace(ks, covis=covis, valid=valid,
                             obs_pt=np.where(rng.random(ks.obs_pt.shape) < 0.3,
                                             rng.integers(0, 2048, ks.obs_pt.shape), -1).astype(np.int32))
    ps = dataclasses.replace(empty[0], n_obs=rng.integers(0, 6, 2048).astype(np.int32))
    for kf_slot in (2, 8):
        jw, jf = jtr._covis_window(cfg, ks, kf_slot, kf_slot + 1)
        tw, tf = tstep._covis_window(port_cfg(cfg), convert.keyframe_store(ks), kf_slot, kf_slot + 1)
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jc = jtr._device_cull_keyframes(cfg, ks, ps, 20)
    tc = tstep._device_cull_keyframes(port_cfg(cfg), convert.keyframe_store(ks), convert.point_store(ps), 20)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    obs = ks.obs_pt[:8].reshape(-1)
    mask = obs >= 0
    for cap in (64, 4096):
        jout = jtr._compact_ids(obs, mask, 2048, cap)
        tout = tstep._compact_ids(torch.as_tensor(obs), torch.as_tensor(mask), 2048, cap)
        for a, b in zip(tout, jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
