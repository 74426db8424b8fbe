"""The host-orchestrated frames' stage programs, on the CPU.

`Tracker` runs every stage of a host-orchestrated frame -- preintegration
and its composition, the frame build, visual or inertial tracking,
keyframe insertion, windowed BA, the BoW add and candidate query, culling,
the local map -- through `frontend.graphs.StageProgram`, which on a GPU
captures each stage once per input signature and replays it. The stages'
values are held against the reference by the trackers' own parity tests
(`test_torch_tracker_vi.py::test_host_path_lockstep` replays every
host-path frame of a reference run through them, on the CPU eagerly);
here, on a small stereo-inertial run before its IMU initialization (the
small configuration of test_torch_step, every frame on the host path):

- (a) each stage traced with `make_fx(tracing_mode="fake")`, and every
  frame builder of the host path (stereo, RGB-D, fisheye and rectified in
  test_torch_graph_step; mono on a KB8 camera here): a host read, an index
  by a 0-d tensor, a data-dependent size or a constant uploaded inside the
  stage fails it (`test_torch_graph_step._fake_trace`);
- (b) each stage traced in real mode at the keyframe that fills slot 3 and
  run on the inputs of the keyframe that fills slot 7 (another slot, stamp,
  pose and stores) equals the eager stage there bit for bit: nothing of
  the first call is frozen into the trace;
- (c) the masked keyframe culling over every slot equals the culling over
  the slice of candidate slots (the reference's form) at every n_kf from 0
  to K, on a store with redundancy fractions exactly at the ratio;
- (d) `StageProgram`'s buffer discipline, with a stand-in for the CUDA graph
  that runs the captured body again on the static buffers and writes the
  captured outputs in place (what a replay does): a later call leaves an
  earlier call's results as they were, an input passed through comes back
  as the caller's tensor, a source that already is its buffer is not
  copied, a stage that writes into its inputs or captures a host value in
  its signature raises; and a whole tracker whose stages replay stand-in
  graphs is bit-identical to the eager tracker over the run;
- (e) `StageProgram(graphs=True)` on the CPU raises;
- (f) the closest-rotation kernel's method (ROADMAP queue 3 A4): its error
  against a float64 SVD on the matrices this run hands `normalize_rotation`
  (preintegration's products of 16 small rotations, their composition, the
  Gauss-Newton and BA pose updates) and on general matrices is no larger
  than the `torch.linalg.svd` twin's.

What the CPU cannot show: that CUDA accepts the captures, and graphs
against eager on the card. chip_smoke.py phase 15 does that on the H100
over phase 5's host-path frames.
"""

import dataclasses
from collections import defaultdict
from functools import partial

import numpy as np
import pytest
import torch
from test_torch_graph_step import _assert_replay_exact, _fake_trace
from test_torch_small_kernels import rot3_method
from test_torch_step import _cfg, port_cfg

from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.ops.kernels import hamming, rot3
from pli_slam_tpu_torch.utils import synthetic
from pli_slam_tpu_torch.utils.profile import imu_batch

torch.set_num_threads(1)
N_FRAMES = 16
KF_A, KF_B = 3, 7  # the keyframe slots whose frames (b) traces at and replays on
CAM = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
STAGES = ("preintegrate", "compose", "build_frame", "track", "track_inertial", "insert", "local_ba", "bow", "cull",
          "local_map")


def _vi_cfg():
    """test_torch_step's small configuration as a stereo-inertial one whose
    IMU never initializes in the run: every frame is host-orchestrated."""
    cfg = port_cfg(_cfg())
    return dataclasses.replace(cfg, sensor="stereo_imu",
                               imu=dataclasses.replace(cfg.imu, init_time_sec=1e6, max_samples_per_frame=16))


def _frames():
    return list(synthetic.make_sequence(CAM, N_FRAMES, "cpu", fps=_vi_cfg().fps, traj=synthetic.Trajectory(**TRAJ),
                                        room_half=2.55))


def _drive(tracker, frames):
    """(info, R, t) of every frame."""
    out = []
    for fr in frames:
        info = tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=imu_batch(fr))
        out.append((info, tracker.R.clone(), tracker.t.clone()))
    return out


@pytest.fixture(scope="module")
def run():
    """The eager run, with every stage call's arguments (by stage, with the
    frame it belongs to) and every matrix handed to the closest rotation."""
    calls, mats, frame_no = defaultdict(list), [], [0]
    mp = pytest.MonkeyPatch()
    orig_call, orig_rot = graphs.StageProgram.__call__, rot3.closest_rotation

    def record_call(self, *args):
        calls[self.name].append((frame_no[0], args))
        return orig_call(self, *args)

    def record_rot(R):
        mats.append(R.detach().reshape(-1, 3, 3).clone())
        return orig_rot(R)

    mp.setattr(graphs.StageProgram, "__call__", record_call)
    mp.setattr(rot3, "closest_rotation", record_rot)
    try:
        frames = _frames()
        tracker = Tracker(CAM, _vi_cfg(), "cpu")
        out = []
        for k, fr in enumerate(frames):
            frame_no[0] = k
            out.extend(_drive(tracker, [fr]))
    finally:
        mp.undo()
    # the frame that made each keyframe slot
    kf_frame = {int(args[5]): k for k, args in calls["insert"]}
    assert KF_B in kf_frame, f"the run made keyframes {sorted(kf_frame)}"
    return dict(tracker=tracker, frames=frames, out=out, calls=calls, mats=torch.cat(mats), kf_frame=kf_frame)


def _stage_fn(name):
    """The stage as a tracker of the run's configuration makes it, with one
    Gauss-Newton iteration in one outlier round and none in the refinement
    (the same iteration body), and one BA iteration: the traces repeat the
    same body fewer times, which keeps (a) and (b) inside their time, and
    the arguments' shapes are the run's."""
    cfg = _vi_cfg()
    cfg = dataclasses.replace(cfg, opt=dataclasses.replace(cfg.opt, pose_rounds=2, pose_gn_iters=1,
                                                           pose_gn_iters_refine=0, local_ba_iters=1))
    tracker = Tracker(CAM, cfg, "cpu")
    return tracker.build_frame if name == "build_frame" else tracker._stages[name].fn


def _inertial_args(run, k):
    """track_inertial's arguments at frame k: that frame's tracking inputs with
    its preintegration, a gravity vector and a velocity (the run's IMU is
    not initialized, so the stage is not called in it)."""
    tr = run["tracker"]
    (_, pre_args), = [c for c in run["calls"]["preintegrate"] if c[0] == k]
    (_, (frame, R, t, _, _, pstore, lstore)), = [c for c in run["calls"]["track"] if c[0] == k]
    preint = tr._stages["preintegrate"].fn(*pre_args)
    v_w = torch.tensor([0.3, -0.1, 0.05]) * (1 + k / 10)
    g = torch.tensor([0.0, 0.0, -9.81])
    return (frame, preint, R, t, v_w, pre_args[1], pre_args[2], g, tr.ext, pstore, lstore)


def _args_at(run, name, slot):
    """The stage's arguments on the frame that made keyframe `slot` (its
    call after the insertion where a stage runs twice on that frame)."""
    k = run["kf_frame"][slot]
    if name == "track_inertial":
        return _inertial_args(run, k)
    found = [args for f, args in run["calls"][name] if f == k]
    assert found, (name, k)
    return found[-1]


# ---------------------------------------------------------------------------
# (a) fake-mode traces, (b) a real-mode trace replayed at a later keyframe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n in STAGES if n != "build_frame"])
def test_stage_traces_in_fake_mode(run, name):
    """(a) for every stage but the frame build, whose builders (the stereo
    one this run uses among them) test_torch_graph_step traces in fake mode."""
    args = _args_at(run, name, KF_A)
    fn = _stage_fn(name)
    fn(*args)  # the eager run fills the constant cache, as the warm-up before a capture does
    assert len(_fake_trace(fn, args, graphs.tree_leaves(run["tracker"].ext)).graph.nodes) > 10


@pytest.mark.parametrize("name", STAGES)
def test_stage_replays_on_a_later_keyframe(run, name):
    a, b = _args_at(run, name, KF_A), _args_at(run, name, KF_B)
    leaves_a, leaves_b = graphs.tree_leaves(a), graphs.tree_leaves(b)
    assert graphs.signature(a) == graphs.signature(b), "one capture serves both calls"
    assert any(not torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))
    _assert_replay_exact(_stage_fn(name), a, b, name)


def test_mono_builder_traces_in_fake_mode(run):
    """The mono path's builder on a KB8 camera (ORB and lines on the raw
    image, then the undistortion: the pinhole builder without it is a part)."""
    cam = Camera.kannala_brandt8(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, k=(0.01, -0.005, 0.001, 0.0),
                                 width=CAM.width, height=CAM.height)
    build = partial(tframe.build_frame_mono, cam, _vi_cfg())
    img = (run["frames"][1]["img_l"],)
    build(*img)
    _fake_trace(build, img)


def test_keyframe_read_decodes_the_bow_stage(run):
    """The keyframe's one read, decoded on the host, is what the BoW stage
    computed: new landmarks, the stores' counts, and the loop candidates'
    slots and scores bit for bit (min_kf_gap 1, so that the run's keyframes
    have candidates)."""
    cfg = _vi_cfg()
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, min_kf_gap=1))
    tr = run["tracker"]
    bow = partial(tstep.host_bow, cfg, tr.voc_pt, tr.voc_ln)
    n_scored = 0
    for _, args in run["calls"]["bow"]:
        _, slots, scores, read = bow(*args)
        n_new, n_points, n_lines, cands = tstep.keyframe_read(read.numpy())
        assert (n_new, n_points, n_lines) == (int(args[8]), int(args[9].sum()), int(args[10].sum()))
        assert cands == list(zip(slots.tolist(), scores.tolist()))
        n_scored += sum(sc > 0 for _, sc in cands)
    assert n_scored >= 3


# ---------------------------------------------------------------------------
# (c) the masked culling against the sliced one
# ---------------------------------------------------------------------------


def _sliced_cull(cfg, kstore, pstore, n_kf: int):
    """The culling as the tracker did it on host ints (and the reference
    does, tracker.py:2436-2454): the candidate slots sliced out."""
    W = cfg.opt.local_ba_window
    lo, hi = 1, n_kf - W
    if n_kf < W + 2 or hi <= lo:
        return kstore
    obs = kstore.obs_pt[lo:hi]
    has = obs >= 0
    n_obs = pstore.n_obs[torch.clamp(obs, min=0).long()]
    redundant = torch.sum((n_obs >= cfg.map.cull_min_obs + 1) & has, dim=1) / torch.clamp(torch.sum(has, dim=1), min=1)
    cull = (redundant >= cfg.map.kf_cull_redundancy) & kstore.valid[lo:hi]
    valid = kstore.valid.clone()
    valid[lo:hi] &= ~cull
    return dataclasses.replace(kstore, valid=valid)


def test_masked_cull_equals_sliced_cull():
    cfg = _vi_cfg()
    K, S = cfg.map.max_keyframes, 20
    rng = np.random.default_rng(3)
    ks = tstep.st.KeyFrameStore.empty(K, S, 4)
    ps = tstep.st.PointStore.empty(K * S)
    obs = np.full((K, S), -1, np.int32)
    n_obs = rng.integers(0, 4, K * S).astype(np.int32)  # below cull_min_obs + 1 = 4
    for k in range(K):
        # rows of their own landmarks; 9 / 10 and 18 / 20 sit exactly at the 0.9 ratio
        has = [0, 10, 20, 10, 20, 7][k % 6]
        redundant = {10: 9, 20: 18 if k % 4 < 2 else 17, 7: 7}.get(has, 0)
        ids = k * S + rng.permutation(has)
        obs[k, rng.choice(S, has, replace=False)] = ids
        n_obs[ids[:redundant]] = 4 + k % 3
    ks = dataclasses.replace(ks, obs_pt=torch.as_tensor(obs), valid=torch.as_tensor(rng.random(K) < 0.9))
    ps = dataclasses.replace(ps, n_obs=torch.as_tensor(n_obs))
    n_culled = 0
    for n_kf in range(K + 1):
        want = _sliced_cull(cfg, ks, ps, n_kf).valid
        got = tstep.cull_keyframes(cfg, ks, ps, torch.tensor(n_kf, dtype=torch.int32)).valid
        assert torch.equal(got, want), n_kf
        n_culled = max(n_culled, int((ks.valid & ~got).sum()))
    assert n_culled >= 3  # ties at the ratio and clear cases were culled


# ---------------------------------------------------------------------------
# (d) the buffer discipline with a stand-in graph, (e) no graphs on the CPU
# ---------------------------------------------------------------------------


class _StandInGraph:
    """Replays by running the captured body on the static buffers and writing
    the results into the captured outputs in place, as a CUDA graph rewrites
    its output buffers."""

    def __init__(self, body, outs):
        self.body, self.outs = body, outs

    def replay(self):
        for dst, src in graphs.tree_pairs(self.outs, self.body(True), []):
            dst.copy_(src)


def stand_in_capture(device, pool, what, body, stream=None):
    warm = body(False)
    outs = body(True)
    captured = graphs.Captured(_StandInGraph(body, outs), hamming.ReplayCounter(hamming, rot3), outs, 0.0, 0)
    passed = {t.data_ptr() for t in graphs.tree_leaves(warm)}  # inputs passed through come back in both runs
    for t in graphs.tree_leaves(outs):  # a capture computes nothing: its outputs hold garbage until a replay
        if t.data_ptr() not in passed:
            t.fill_(float("nan") if t.is_floating_point() else (t.dtype != torch.bool) * 77)
    return captured


def test_stage_program_buffer_discipline():
    def fn(x, y, k):
        return {"sum": x + y * k, "same": y, "k": k * 2}

    prog = graphs.StageProgram(fn, "cpu", True, "toy", capture=stand_in_capture)
    x1, y1, k1 = torch.ones(3), torch.arange(3.0), torch.tensor(2)
    out1 = prog(x1, y1, k1)
    want1 = fn(x1, y1, k1)
    assert out1["same"] is y1  # passed through: the caller's own tensor
    out2 = prog(torch.full((3,), 5.0), torch.ones(3), torch.tensor(3))
    for key in ("sum", "k"):
        assert torch.equal(out1[key], want1[key]), key  # the second replay did not reach the first results
    assert torch.equal(out2["sum"], torch.full((3,), 8.0)) and int(out2["k"]) == 6
    assert prog.captures == 1 and prog.replays == 2
    static = prog._entries[graphs.signature((x1, y1, k1))][0]
    versions = [t._version for t in graphs.tree_leaves(static)]
    prog(static[0], torch.zeros(3), torch.tensor(1))
    after = [t._version for t in graphs.tree_leaves(static)]
    assert after[0] == versions[0] and after[1] > versions[1]  # the buffer as its own source is not copied
    prog(torch.ones(4), torch.ones(4), torch.tensor(1))  # another shape: a capture of its own
    assert prog.captures == 2

    hosted = graphs.StageProgram(lambda x, s: x * s, "cpu", True, "host value", capture=stand_in_capture)
    with pytest.raises(RuntimeError, match="device tensor"):
        for s in range(graphs.StageProgram.max_signatures + 1):
            hosted(torch.ones(2), float(s))  # a per-call host float in the signature
    writes = graphs.StageProgram(lambda x: x.add_(1), "cpu", True, "writes", capture=stand_in_capture)
    with pytest.raises(RuntimeError, match="writes into its inputs"):
        writes(torch.ones(2))


def test_stage_program_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        graphs.StageProgram(lambda x: x, "cpu", True, "toy")
    assert graphs.StageProgram(lambda x: x + 1, "cpu", False, "toy")(torch.ones(1)).item() == 2.0


def test_tracker_on_stand_in_graphs_equals_eager(run):
    """The run again, every stage replaying a stand-in graph: every frame's
    record and pose, the stores and the local map bit-identical to eager."""
    mp = pytest.MonkeyPatch()
    mp.setattr(Tracker, "_program", lambda self, fn, name: graphs.StageProgram(
        fn, self.device, True, name, capture=stand_in_capture))
    try:
        tracker = Tracker(CAM, _vi_cfg(), "cpu")
        out = _drive(tracker, run["frames"])
    finally:
        mp.undo()
    for k, ((info_g, R_g, t_g), (info_e, R_e, t_e)) in enumerate(zip(out, run["out"])):
        assert info_g == info_e, (k, info_g, info_e)
        assert torch.equal(R_g, R_e) and torch.equal(t_g, t_e), k
    ref = run["tracker"]
    for name in ("pstore", "lstore", "kstore", "bow_db", "_local_pt", "_preint_since_kf"):
        for a, b in zip(graphs.tree_leaves(getattr(tracker, name)), graphs.tree_leaves(getattr(ref, name))):
            assert torch.equal(a, b), name
    assert np.array_equal(tracker.positions(), ref.positions())
    replays = {p.name: p.replays for p in tracker.stage_programs()}
    assert all(replays[n] > 0 for n in STAGES if n != "track_inertial"), replays
    assert all(p.captures == 1 for p in tracker.stage_programs() if p.replays), \
        {p.name: p.captures for p in tracker.stage_programs()}


# ---------------------------------------------------------------------------
# (f) A4: the closest rotation against float64
# ---------------------------------------------------------------------------


def _closest_rotation_f64(mats: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(mats.astype(np.float64))
    u[..., :, 2] *= np.sign(np.linalg.det(u @ vt))[..., None]
    return u @ vt


def test_closest_rotation_kernel_no_farther_from_float64_than_the_twin(run, capsys):
    """The kernel's method (csrc/rot3.cu, transcribed) and the twin
    (torch.linalg.svd + det, what the CPU runs) against the float64 closest
    rotation of the same float32 input: the kernel's largest error is no
    larger than the twin's on the run's matrices and on general ones."""
    general = np.random.default_rng(11).normal(size=(400, 3, 3)).astype(np.float32)
    main_path = run["mats"].numpy()
    assert len(main_path) >= 200
    for label, mats in (("main path", main_path), ("general", general)):
        exact = _closest_rotation_f64(mats)
        twin = rot3.closest_rotation_reference(torch.as_tensor(mats)).numpy().astype(np.float64)
        kern = rot3_method(mats)[0].astype(np.float64)
        e_twin, e_kern = np.abs(twin - exact).max(), np.abs(kern - exact).max()
        with capsys.disabled():
            print(f"\nA4 {label} ({len(mats)} matrices): max |R - R_float64| kernel's method {e_kern:.3e}, "
                  f"twin {e_twin:.3e}")
        assert e_kern <= e_twin, (label, e_kern, e_twin)
