"""The fused steps cut for CUDA graphs, on the CPU.

frontend.step cuts each fused step at its one device->host read into T
(build, prediction, tracking) and K (the keyframe branch); on a GPU
frontend.graphs captures T and K as CUDA graphs and replays them every
frame. What the CPU can show of that:

- (a) T, the keyframe decision on the device and K, composed eagerly
  (the program frontend.graphs.FusedStep captures), with the keyframe
  counters chained as device tensors from frame to frame, against the
  reference's jitted `make_step_visual` and `make_step_vi` on the same
  FrameData, each frame from the reference's state: keyframes made at n_kf
  0 (KF0 through `insert_keyframe` with device counters), 1 and 2 (no
  windowed BA), 3 and 4 (windowed BA), and frames without one; the
  stereo-inertial step (visual-inertial BA) in test_torch_graph_step_vi.py,
  a file of its own so that the two reference runs go to two workers. The reference runs its
  accelerator branch (Pallas in interpret mode), as in test_torch_step.
  Tolerances are test_torch_step's and test_torch_tracker_vi's (README's
  parity table): stats, matches, counters and bookkeeping exact, poses 1e-4
  (2e-4 inertial) off windowed BA and BA's float32 bounds on it.
- (b) capturability: `make_fx(segment, tracing_mode="fake")` traces T and
  K of both steps, and T with each frame builder the fused step runs
  (stereo, rectified stereo, RGB-D, KB8 fisheye stereo). A `.item()`,
  `.tolist()`, `bool(tensor)`, an index by a 0-d tensor or an op whose
  output size depends on data fails it; so does a constant uploaded from
  the host inside a segment (an `aten.lift_fresh_copy` node, or a tensor
  baked into the trace that is not one of ops.consts' per-device constants:
  on a GPU that copy would wait for the host during capture).
- (c) no frozen values: a segment traced in real mode at one frame and
  replayed on the next frame's inputs (another n_kf, stamp, pose, stores
  and matches) equals the eager segment on those inputs exactly.

What it cannot show: that CUDA accepts the capture (a cuSOLVER call that
reads its status on the host traces fine here), the kernels inside the
graphs, and graph against eager on the card. chip_smoke.py phase 15 does
that on the H100.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx
from test_torch_small_kernels import rot3_method
from test_torch_step import _ba_objective, _cfg, _torch_state, assert_state_close, np_tree, port_cfg

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.frontend.frame import make_build_frame
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu.worldmap import vocab as jvoc
from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.ops import consts, rectify
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.ops.kernels import hamming as tham
from pli_slam_tpu_torch.ops.kernels import rot3
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
N_VIS = 10  # KF0 + 9 visual steps
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def _segments_step(segs, inputs, state):
    """T, the device decision and K, as graphs.FusedStep's one program runs
    them, composed eagerly (`step.run_segments`: the host reads the decision
    to take the branch). Returns (state, out, carry, need_kf)."""
    s, out, carry, need_kf = tstep.run_segments(segs, inputs, state)
    return s, out, carry, bool(need_kf)


@pytest.fixture(scope="module")
def ref():
    """The reference's visual steps over one sequence, each recorded with
    the state it started from: KF0 and N_VIS - 1 steps (a keyframe every
    second frame)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    try:
        cfg = _cfg()
        jcam = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
        tcam = convert.camera(np_tree(jcam))
        raw = list(jsyn.make_sequence(jcam, N_VIS, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55))
        build = make_build_frame(jcam, cfg)
        fds = [np_tree(build(fr["img_l"], fr["img_r"])) for fr in raw]
        m, K = cfg.map, cfg.map.max_keyframes
        empty = (jst.PointStore.empty(m.max_points), jst.LineStore.empty(m.max_lines),
                 jst.KeyFrameStore.empty(K, cfg.orb.n_features, cfg.lines.n_lines))
        n, nl = fds[0].feats.uv.shape[0], fds[0].lines.angle.shape[0]
        eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        kf0_args = (fds[0], eye, zero, 0.0, np.full(n, -1, np.int32), np.zeros(n, bool), np.full(nl, -1, np.int32),
                    np.zeros(nl, bool), 0)
        ps, ls, ks, _ = jax.jit(partial(jtr.insert_keyframe, jcam, cfg))(*kf0_args, *empty)
        voc_j = (jvoc.Vocabulary(seed=17), jvoc.Vocabulary(seed=23))
        js = dict(R=eye, t=zero, R_prev=eye, t_prev=zero, vel=np.zeros(6, np.float32), has_vel=False, n_kf=1, fs=0,
                  last=int((fds[0].stereo_ok & fds[0].feats.valid).sum()), ps=ps, ls=ls, ks=ks,
                  db=jvoc.BowDatabase.empty(K, voc_j[0].n_words), view=jtr._empty_kf_views(cfg),
                  local=jtr._local_map_ids(cfg, ks, ps, 0))
        jvis = jtr.make_step_visual(jcam, cfg, *voc_j, lambda fd: fd)
        visual = []
        for k in range(1, N_VIS):
            jo = jvis((fds[k],), k / cfg.fps, js["R"], js["t"], js["R_prev"], js["t_prev"], js["vel"], js["has_vel"],
                      js["n_kf"], js["fs"], js["last"], True, js["ps"], js["ls"], js["ks"], js["db"], js["view"],
                      js["local"])
            visual.append((k, dict(js), np_tree(jo)))
            js.update(R=jo[0], t=jo[1], R_prev=jo[2], t_prev=jo[3], vel=jo[4], has_vel=jo[5], ps=jo[6], ls=jo[7],
                      ks=jo[8], db=jo[9], view=jo[10], local=jo[11], n_kf=jo[16][0], fs=jo[16][1], last=jo[16][2])

        yield dict(cfg=cfg, jcam=jcam, tcam=tcam, raw=raw, fds=fds, voc=voc_j, kf0=(kf0_args, empty), visual=visual)
    finally:
        mp.undo()


def _voc(r):
    return tuple(convert.vocabulary(v) for v in r["voc"])


def _visual_io(r, k, js):
    """The port's (inputs, state, n_kf, fs) of visual step k from the reference's state `js`."""
    ts = _torch_state(js)
    state = dict(R=ts["R"], t=ts["t"], R_prev=ts["R_prev"], t_prev=ts["t_prev"], vel_xi=ts["vel"],
                 has_vel=ts["has_vel"], n_kf=tstep._dev_int(ts["n_kf"], "cpu"), fs=tstep._dev_int(ts["fs"], "cpu"),
                 last=tstep._dev_int(ts["last"], "cpu"), pstore=ts["ps"], lstore=ts["ls"], kstore=ts["ks"],
                 bow_db=ts["db"], kf_view=ts["view"], local_pt=ts["local"])
    inputs = tstep.scalar_inputs(dict(img=(convert.frame_data(r["fds"][k]),), stamp=k / r["cfg"].fps, allow=True),
                                 "cpu")
    return inputs, state, ts["n_kf"], ts["fs"]


def _visual_segments(r, build=lambda fd: fd):
    return tstep.visual_segments(r["tcam"], port_cfg(r["cfg"]), *_voc(r), build)


# ---------------------------------------------------------------------------
# (a) T + K against the reference's jitted steps
# ---------------------------------------------------------------------------


def test_kf0_with_device_counters(ref):
    """KF0 (n_kf 0) through `insert_keyframe` with the slot and the stamp
    as device scalars, as the fused steps pass them."""
    args, empty = ref["kf0"]
    jout = jax.jit(partial(jtr.insert_keyframe, ref["jcam"], ref["cfg"]))(*args, *empty)
    T = torch.as_tensor
    tout = tstep.insert_keyframe(ref["tcam"], port_cfg(ref["cfg"]), convert.frame_data(args[0]), T(args[1]), T(args[2]),
                                 torch.zeros(()), *(T(a) for a in args[4:8]), torch.zeros((), dtype=torch.int32),
                                 *(conv(np_tree(e)) for conv, e in zip((convert.point_store, convert.line_store,
                                                                        convert.keyframe_store), empty)))
    for a, b, name in zip(tout[:3], jout[:3], ("pstore", "lstore", "kstore")):
        assert_state_close(a, b, f"KF0 {name}")
    assert int(tout[3]) == int(jout[3])


def _assert_ba_frame(to, jo, label, kf_slot):
    """A keyframe frame with windowed BA, held as test_torch_step's
    `_assert_after_ba` holds one (same bounds) except for what follows the
    window's older keyframes: on this map, from the fourth keyframe on,
    BA's float32 solve leaves one of them 1.3e-2 / 2.1e-2 rad from the
    reference's (frames 6 / 8) and moves landmarks by up to 5.6% / 14% of
    their distance. The port before the step was cut into segments gave
    the same numbers to the last digit on these frames, so this is BA's
    float32 conditioning on the tiny map, not the cut. The older keyframes'
    poses are held by the BA objective (`_ba_objective`, at the call site),
    the landmarks by the 90% bound alone; the new keyframe's pose, which
    tracking continues from, keeps the 5e-3 bound."""
    np.testing.assert_allclose(to[0].numpy(), jo[0], atol=5e-3, err_msg=f"{label} R")
    np.testing.assert_allclose(to[1].numpy(), jo[1], atol=5e-3, err_msg=f"{label} t")
    a = {k: convert.to_numpy(x) for k, x in zip(("p", "l", "k"), to[6:9])}
    b = {k: convert.to_numpy(x) for k, x in zip(("p", "l", "k"), jo[6:9])}
    for fam in ("p", "l"):
        for f in a[fam]:
            if f == "x":
                v = b[fam]["valid"]
                rel = np.abs(a[fam][f] - b[fam][f]).max(-1)[v] / np.linalg.norm(b[fam][f][v], axis=-1)
                assert np.quantile(rel, 0.9) < 0.03, (label, np.quantile(rel, [0.9, 1.0]))
            elif f != "seg":
                np.testing.assert_array_equal(a[fam][f], b[fam][f], err_msg=f"{label} {fam}.{f}")
    for f in a["k"]:
        if f in ("R", "t"):
            np.testing.assert_allclose(a["k"][f][kf_slot], b["k"][f][kf_slot], atol=5e-3, err_msg=f"{label} new KF {f}")
        elif f in ("obs_pt", "obs_ln"):
            assert (a["k"][f] != b["k"][f]).mean() <= 0.01, (label, f)
        elif a["k"][f].dtype.kind == "f":
            np.testing.assert_allclose(a["k"][f], b["k"][f], rtol=1e-5, atol=1e-4, err_msg=f"{label} kstore.{f}")
        else:
            np.testing.assert_array_equal(a["k"][f], b["k"][f], err_msg=f"{label} kstore.{f}")
    lt, lj = to[11].numpy(), np.asarray(jo[11])
    assert len(np.intersect1d(lt[lt >= 0], lj[lj >= 0])) >= 0.99 * (lj >= 0).sum()


def test_visual_segments_parity(ref):
    """Every visual step, the program composed eagerly (T, the decision on
    the device, K) from the reference's state but with the keyframe
    counters chained as device tensors from the port's previous frame,
    never passed from the host (as the reference's streaming mode chains
    its `counters`): stats, matches, counters, velocity, view ring, BoW
    database exactly or as test_torch_step holds them; poses and stores
    tightly off windowed BA and by what BA decides on it."""
    segs = _visual_segments(ref)
    made, chained = [], None
    for k, js, jo in ref["visual"]:
        inputs, state, n_kf, fs = _visual_io(ref, k, js)
        if chained is not None:
            state.update(chained)
        s, out, c, need_kf = _segments_step(segs, inputs, state)
        chained = {name: s[name] for name in ("n_kf", "fs", "last")}
        assert all(isinstance(v, torch.Tensor) for v in chained.values())
        label = f"frame {k}"
        stats = jo[17]
        assert need_kf == bool(stats[jtr.ST_KF_CREATED] > 0), label
        np.testing.assert_array_equal(out["stats"].numpy(), stats, err_msg=f"{label} stats")
        for name, i in (("pt_idx", 12), ("pt_in", 13), ("ln_idx", 14), ("ln_in", 15)):
            np.testing.assert_array_equal(c[name].numpy(), jo[i], err_msg=f"{label} {name}")
        assert [int(s[n]) for n in ("n_kf", "fs", "last")] == [int(x) for x in jo[16]], label
        assert int(out["ref"]) == int(jo[18][0])
        np.testing.assert_allclose(s["vel_xi"].numpy(), jo[4], atol=1e-4, err_msg=f"{label} vel")
        for a, b in zip(s["kf_view"], jo[10]):
            np.testing.assert_array_equal(a.numpy(), b)
        assert_state_close(s["bow_db"], jo[9], f"{label} bow_db")
        # the positions test_torch_step's helpers read in make_step_visual's result
        to = (s["R"], s["t"], None, None, None, None, s["pstore"], s["lstore"], s["kstore"], None, None, s["local_pt"])
        if need_kf:
            made.append(n_kf)
        if need_kf and n_kf + 1 >= 3:
            _assert_ba_frame(to, jo, label, n_kf)
            cost_j = _ba_objective(ref["cfg"], ref["tcam"], jo, (convert.point_store(jo[6]), convert.line_store(jo[7]),
                                                                 convert.keyframe_store(jo[8])), n_kf)
            assert _ba_objective(ref["cfg"], ref["tcam"], jo, to[6:9], n_kf) <= 1.1 * cost_j + 1.0, label
        else:
            np.testing.assert_allclose(s["R"].numpy(), jo[0], atol=1e-4, err_msg=f"{label} R")
            np.testing.assert_allclose(s["t"].numpy(), jo[1], atol=1e-4, err_msg=f"{label} t")
            np.testing.assert_allclose(out["rel_R"].numpy(), jo[18][1], atol=1e-4)
            np.testing.assert_allclose(out["rel_t"].numpy(), jo[18][2], atol=1e-4)
            for a, b, name in zip(to[6:9], jo[6:9], ("pstore", "lstore", "kstore")):
                assert_state_close(a, b, f"{label} {name}")
            np.testing.assert_array_equal(s["local_pt"].numpy(), jo[11])
    assert made == [1, 2, 3, 4], made  # K without BA twice, with BA twice, and frames without a keyframe


# ---------------------------------------------------------------------------
# (b) capturability, (c) no frozen values
# ---------------------------------------------------------------------------


def _flat(fn, tree):
    """`fn(*tree)` as a function of the tensor leaves of `tree`, returning
    the tensor leaves of its result, and those leaves."""
    leaves = graphs.tree_leaves(tree)

    def rebuild(t, it):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, dict):
            return {k: rebuild(v, it) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(rebuild(v, it) for v in t)
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{f.name: rebuild(getattr(t, f.name), it) for f in dataclasses.fields(t)})
        return t

    def flat(*vals):
        return graphs.tree_leaves(fn(*rebuild(tree, iter(vals))))

    return flat, leaves


def _fake_trace(fn, tree, outside=()):
    """`fn` traced in fake mode; `outside` are tensors its closure holds
    (a rectifier's grids, a rig's extrinsics), built before it runs."""
    flat, leaves = _flat(fn, tree)
    gm = make_fx(flat, tracing_mode="fake", _allow_non_fake_inputs=True)(*leaves)
    uploads = [n for n in gm.graph.nodes if n.op == "call_function" and "lift_fresh" in str(n.target)]
    assert not uploads, f"host constants uploaded inside the segment: {[u.format_node() for u in uploads]}"
    # every tensor baked into the trace is one of ops.consts' per-device constants or of `outside`, built before it
    cached = {t.data_ptr() for t in list(consts._cache.values()) + list(outside)}
    baked = [(n.target, tuple(getattr(gm, n.target).shape), [u.format_node()[:160] for u in n.users])
             for n in gm.graph.nodes if n.op == "get_attr" and getattr(gm, n.target).data_ptr() not in cached]
    assert not baked, f"tensors created inside the segment from host data: {baked}"
    return gm


def _assert_replay_exact(fn, tree_a, tree_b, label):
    """Trace `fn` in real mode on `tree_a`, run the trace on `tree_b`'s
    leaves, and hold it to `fn(*tree_b)` bit for bit."""
    flat, leaves = _flat(fn, tree_a)
    gm = make_fx(flat, tracing_mode="real")(*leaves)
    flat_b, leaves_b = _flat(fn, tree_b)
    got, want = gm(*leaves_b), flat_b(*leaves_b)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{label} output {i}: {m}")


def _ba_keyframe_frames(r):
    """(segments, [(inputs, state)] of the visual steps that made a keyframe
    with windowed BA, (inputs, state) of the last visual step)."""
    frames = [_visual_io(r, k, js)[:2] for k, js, jo in r["visual"]
              if jo[17][jtr.ST_KF_CREATED] > 0 and jo[17][jtr.ST_NKF] >= 3]
    k, js, _ = r["visual"][-1]
    return _visual_segments(r), frames, _visual_io(r, k, js)[:2]


def _segment_trees(segs, inputs, state):
    """T's arguments, and K's (after T, with T's carry)."""
    new, _, carry = segs.track(inputs, state)
    return (inputs, state), (inputs, {**state, **new}, carry)


def check_segments_trace(segs, frames):
    """T and K trace with make_fx(tracing_mode="fake"): nothing in them reads
    a device value on the host or uploads a host constant."""
    t_tree, k_tree = _segment_trees(segs, *frames[0])
    assert len(_fake_trace(segs.track, t_tree).graph.nodes) > 1000
    keyframe = lambda i, s, c: segs.keyframe(i, s, c, True)  # noqa: E731
    assert len(_fake_trace(keyframe, k_tree).graph.nodes) > 1000


@pytest.mark.parametrize("step", ["visual"])
def test_segments_trace_in_fake_mode(ref, step):
    """(b) for the visual step (the stereo-inertial one: test_torch_graph_step_vi)."""
    segs, frames, _ = _ba_keyframe_frames(ref)
    check_segments_trace(segs, frames)


@pytest.mark.parametrize("builder", ["stereo", "rectified", "rgbd", "fisheye"])
def test_frame_builders_trace_in_fake_mode(ref, builder):
    """Each frame builder a fused step runs (phases 4-6, 14 stereo; rectified
    EuRoC pairs; 7 RGB-D; 10 KB8 fisheye) traces as part of T."""
    pcfg = port_cfg(ref["cfg"])
    tcam = ref["tcam"]
    fr = ref["raw"][1]
    img_l, img_r = torch.as_tensor(np.asarray(fr["img_l"])), torch.as_tensor(np.asarray(fr["img_r"]))
    outside = ()
    if builder == "stereo":
        build, args = partial(tframe.build_frame, tcam, pcfg), (img_l, img_r)
    elif builder == "rectified":
        K = np.array([[tcam.fx, 0, tcam.cx], [0, tcam.fy, tcam.cy], [0, 0, 1]], np.float64)
        D = np.array([-0.28, 0.074, 2e-4, 2e-5, 0.0])
        P = np.concatenate([K, np.zeros((3, 1))], axis=1)
        rect = rectify.StereoRectifier.from_kdrp(K, D, np.eye(3), P, K, D, np.eye(3), P, tcam.width, tcam.height,
                                                 "cpu")
        build, args, outside = lambda a, b: tframe.build_frame(tcam, pcfg, *rect(a, b)), (img_l, img_r), \
            graphs.tree_leaves(rect)
    elif builder == "rgbd":
        build, args = partial(tframe.build_frame_rgbd, tcam, pcfg), (img_l, torch.full_like(img_l, 2.0))
    else:
        kb = TCamera.kannala_brandt8(fx=tcam.fx, fy=tcam.fy, cx=tcam.cx, cy=tcam.cy, k=(0.01, -0.005, 0.001, 0.0),
                                     bf=tcam.bf, width=tcam.width, height=tcam.height)
        T_rl = torch.eye(4)
        T_rl[0, 3] = -0.11
        R_rl, t_rl = T_rl[:3, :3], T_rl[:3, 3]
        build, args, outside = partial(tframe.build_frame_fisheye_stereo, kb, kb, pcfg, R_rl, t_rl), (img_l, img_r), \
            (R_rl, t_rl)
    build(*args)  # the eager run fills the constant cache, as the warm-up before a capture does
    _fake_trace(build, args, outside)
    flat, leaves = _flat(build, args)
    make_fx(flat, tracing_mode="real")(*leaves)  # fails on a host read that the fake trace skips


def check_replay_on_later_frame(segs, first, last, step):
    """(c) T and K traced in real mode at a keyframe with windowed BA and run
    on the last recorded frame's inputs (another n_kf, stamp, pose, stores
    and matches; K runs there as it would on a keyframe) equal the eager
    segments exactly; the real-mode trace also fails on any host read a
    fake trace skips (`one_hot`'s range check did). Before the keyframe counters and the stamp became device inputs
    this failed: `insert_keyframe` wrote `torch.tensor(_f32(stamp))`, which a
    trace (and a CUDA graph) records as a constant, so the replay at the
    later keyframe wrote the first one's stamp into `kstore.stamp`; the host
    int `n_kf` froze the keyframe slot the same way."""
    (t_a, k_a), (t_b, k_b) = _segment_trees(segs, *first), _segment_trees(segs, *last)
    assert int(k_a[1]["n_kf"]) < int(k_b[1]["n_kf"]) and float(k_a[0]["stamp"]) != float(k_b[0]["stamp"])
    _assert_replay_exact(segs.track, t_a, t_b, f"{step} T")
    keyframe = lambda i, s, c: segs.keyframe(i, s, c, True)  # noqa: E731
    _assert_replay_exact(keyframe, k_a, k_b, f"{step} K")


@pytest.mark.parametrize("step", ["visual"])
def test_replay_on_next_frame_equals_eager(ref, step):
    """(c) for the visual step (the stereo-inertial one: test_torch_graph_step_vi)."""
    segs, frames, last = _ba_keyframe_frames(ref)
    check_replay_on_later_frame(segs, frames[0], last, step)


# ---------------------------------------------------------------------------
# The graph runner's bookkeeping, without a card
# ---------------------------------------------------------------------------


class _StandInGraph:
    """What ReplayCounter needs of a torch.cuda.CUDAGraph: `replay()`."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_counter_counts_per_replay():
    """Launches made while capturing are taken back and added once per
    replay; a warm-up's launches never count."""
    tham.reset_launches()
    rot3.reset_launches()
    counter = tham.ReplayCounter(tham, rot3)
    with counter.uncounted():
        tham.launches += 2  # the warm-up run's launches
    assert tham.launches == 0
    with counter.capturing():
        tham.launches += 2  # what the wrappers count while the graph is captured
        rot3.launches += 5
    assert (tham.launches, rot3.launches) == (0, 0)
    graph = _StandInGraph()
    for _ in range(3):
        counter.replay(graph)
    assert graph.replays == 3 and (tham.launches, rot3.launches) == (6, 15)
    tham.reset_launches()
    rot3.reset_launches()


def test_copy_into_reads_every_source_before_writing():
    """A segment's new R_prev is the old R buffer itself: it is read before
    R is overwritten. Unchanged buffers are not copied; scalars fill."""
    static = {"R": torch.ones(3), "R_prev": torch.zeros(3), "n": torch.zeros((), dtype=torch.int32)}
    storages = {t.untyped_storage().data_ptr() for t in static.values()}
    R_buf = static["R"]
    new = {"R": torch.full((3,), 7.0), "R_prev": static["R"], "n": 4}
    graphs.copy_into(graphs.tree_pairs(static, new, []), storages)
    assert static["R"] is R_buf and torch.equal(static["R"], torch.full((3,), 7.0))
    assert torch.equal(static["R_prev"], torch.ones(3)) and int(static["n"]) == 4


def test_graphs_need_a_card():
    with pytest.raises(ValueError):
        graphs.FusedStep(None, "cpu", graphs=True)


# ---------------------------------------------------------------------------
# The closest-rotation kernel's method, in plain Python
# ---------------------------------------------------------------------------


def test_rot3_method_matches_the_svd_twin():
    """Near rotations (what the solvers hand it) and general matrices of
    either determinant sign: the transcribed method equals the twin to
    float32 precision (1e-5 near rotations; 1e-4 in general, where the
    twin's own SVD is conditioned by the gap between singular values) and
    always returns a proper rotation."""
    rng = np.random.default_rng(5)
    base = rot3.closest_rotation_reference(torch.as_tensor(rng.normal(size=(40, 3, 3)), dtype=torch.float32))
    near = base.numpy() + 1e-3 * rng.normal(size=(40, 3, 3)).astype(np.float32)
    general = rng.normal(size=(40, 3, 3)).astype(np.float32)
    for mats, tol in ((near, 1e-5), (general, 1e-4)):
        want = rot3.closest_rotation(torch.as_tensor(mats)).numpy()  # the CPU runs the twin
        got = rot3_method(mats)[0]
        np.testing.assert_allclose(got, want, atol=tol)
        np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)


@pytest.mark.cuda
def test_rot3_kernel_equals_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (chip_smoke.py phase 3 runs this on the H100)")
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(64, 3, 3)), dtype=torch.float32).cuda()
    near = rot3.closest_rotation_reference(x) + 1e-3 * torch.randn_like(x)
    torch.testing.assert_close(rot3.closest_rotation_cuda(near), rot3.closest_rotation_reference(near), rtol=0,
                               atol=1e-5)
