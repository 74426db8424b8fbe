"""The fused steps cut for CUDA graphs, on the CPU.

frontend.step cuts each fused step at its one device->host read into T
(build, prediction, tracking) and K (the keyframe branch); on a GPU
frontend.graphs captures T and K as CUDA graphs and replays them every
frame. What the CPU can show of that, for each step:

- (a) T, the keyframe decision on the device and K, composed eagerly
  (the program frontend.graphs.FusedStep captures), with the keyframe
  counters chained as device tensors from frame to frame, against the
  reference's jitted step on the same FrameData, each frame from the
  reference's state. The reference runs its accelerator branch (Pallas in
  interpret mode), as in test_torch_step. Tolerances are test_torch_step's
  and test_torch_tracker_vi's (README's parity table): stats, matches,
  counters and bookkeeping exact, poses 1e-4 (2e-4 inertial) off windowed
  BA and BA's float32 bounds on it.
- (b) capturability: `make_fx(segment, tracing_mode="fake")` traces T and
  K, and T with each frame builder the fused step runs (stereo, rectified
  stereo, RGB-D, KB8 fisheye stereo). A `.item()`, `.tolist()`,
  `bool(tensor)`, an index by a 0-d tensor or an op whose output size
  depends on data fails it; so does a constant uploaded from the host
  inside a segment (an `aten.lift_fresh_copy` node, or a tensor baked into
  the trace that is not one of ops.consts' per-device constants: on a GPU
  that copy would wait for the host during capture).
- (c) no frozen values: a segment traced in real mode at one frame and
  replayed on the next frame's inputs (another n_kf, stamp, pose, stores
  and matches) equals the eager segment on those inputs exactly.

(b) and (c) check the port alone: their frames are snapshots of the port's
own CPU tracker (`own_fused_frames`), no reference's. Where each lies:
the visual step's (a) in test_torch_step.py (`test_visual_segments_parity`,
`test_kf0_with_device_counters`), its (b) in test_torch_one_program.py
(the program's trace, K with and without windowed BA), its (c) and the
frame builders in test_torch_graph_visual.py; the stereo-inertial step's (a) in
test_torch_tracker_vi.py (`test_vi_segments_parity`, on that file's one
reference run), its (b) here, its (c) in test_torch_graph_step_vi.py. Each
trace of the stereo-inertial step takes one to three minutes under the
whole suite, so the two lie in two files. pytest-xdist 3.8's `--dist
loadfile` starts the files with the most tests first, so each shares its
file with short tests where it can (the verify skill's budget rule): this
one also holds the graph runner's bookkeeping and the closest-rotation
method.

What it cannot show: that CUDA accepts the capture (a cuSOLVER call that
reads its status on the host traces fine here), the kernels inside the
graphs, and graph against eager on the card. chip_smoke.py phase 15 does
that on the H100.
"""

import contextlib
import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.fx.experimental import proxy_tensor
from torch.fx.experimental.proxy_tensor import make_fx
from test_torch_small_kernels import rot3_method

from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops import consts
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.ops.kernels import hamming as tham
from pli_slam_tpu_torch.ops.kernels import rot3
from pli_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)
N_VIS = 10  # KF0 + 9 visual steps
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def _segments_step(segs, inputs, state):
    """T, the device decision and K, as graphs.FusedStep's one program runs
    them, composed eagerly (`step.run_segments`: the host reads the decision
    to take the branch). Returns (state, out, carry, need_kf)."""
    s, out, carry, need_kf = tstep.run_segments(segs, inputs, state)
    return s, out, carry, bool(need_kf)


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


@contextlib.contextmanager
def _one_fake_mode():
    """make_fx in real mode gives every op's output a new FakeTensorMode for
    the node's metadata (`proxy_tensor.extract_val`, which looks the class up
    in its module: torch 2.13), and each one walks the Python stack when it is
    built: about half of a segment's trace time. One mode for the whole trace
    records the same graph. Fails if the trace never asked for a mode, so a
    torch that builds it elsewhere shows here rather than as a slow trace."""
    shared = proxy_tensor.FakeTensorMode(allow_fallback_kernels=True)
    asked = []

    def one(**kw):
        asked.append(kw)
        return shared

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(proxy_tensor, "FakeTensorMode", one)
        yield
    assert asked, f"torch {torch.__version__}: make_fx built its metadata without proxy_tensor.FakeTensorMode"


def _assert_replay_exact(fn, tree_a, tree_b, label):
    """Trace `fn` in real mode on `tree_a`, run the trace on `tree_b`'s
    leaves, and hold it to `fn(*tree_b)` bit for bit."""
    flat, leaves = _flat(fn, tree_a)
    with _one_fake_mode():
        gm = make_fx(flat, tracing_mode="real")(*leaves)
    flat_b, leaves_b = _flat(fn, tree_b)
    got, want = gm(*leaves_b), flat_b(*leaves_b)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{label} output {i}: {m}")


def own_fused_frames(tracker, frames, built=True):
    """The port's own CPU tracker run over `frames` (make_sequence's dicts)
    until one of its fused frames has made a keyframe with windowed BA and
    another fused frame has followed it. Returns the (inputs, state) that
    each of the two started from, as the tracker's fused step handed them to
    its segments (the images in `img`, for `tracker._fused_step().segs`),
    or with the frame built (FrameData in `img`, for segments built with
    `lambda fd: fd`) if `built`. The one way the tests snapshot the port's
    own tracker for a trace."""
    fused, seen = tracker._fused_step(), []
    run = tstep.run_segments

    def recording(segs, inputs, state):
        result = run(segs, inputs, state)
        if segs is fused.segs:
            with_ba = bool(result[3]) and int(state["n_kf"]) + 1 >= 3
            seen.append((copy.deepcopy((inputs, state)), with_ba))
        return result

    def picked():
        ba = [i for i, (_, with_ba) in enumerate(seen) if with_ba]
        return [seen[ba[0]][0], seen[ba[0] + 1][0]] if ba and len(seen) > ba[0] + 1 else None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "run_segments", recording)
        for fr in frames:
            imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]} if tracker.use_imu \
                else None
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=imu)
            if picked():
                break
    assert picked(), f"{len(seen)} fused frames, none a keyframe with windowed BA followed by another"
    return [({**inputs, "img": (tracker.build_frame(*inputs["img"]),)} if built else inputs, state)
            for inputs, state in picked()]


def _segment_trees(segs, inputs, state):
    """T's arguments, and K's (after T, with T's carry)."""
    new, _, carry = segs.track(inputs, state)
    return (inputs, state), (inputs, {**state, **new}, carry)


def check_segments_trace(segs, frame, without_ba=False):
    """T and K trace with make_fx(tracing_mode="fake") on `frame`'s (inputs,
    state): nothing in them reads a device value on the host or uploads a
    host constant. K with windowed BA, and also without it if `without_ba`
    (the two bodies of the fused program's IF nodes), each traced on T's
    outputs as the program hands them over. Returns the nodes traced."""
    t_tree, k_tree = _segment_trees(segs, *frame)
    nodes = [len(_fake_trace(segs.track, t_tree).graph.nodes)]
    for ba in (True, False)[:1 + without_ba]:
        nodes.append(len(_fake_trace(lambda i, s, c: segs.keyframe(i, s, c, ba), k_tree).graph.nodes))
    assert nodes[0] > 1000 and nodes[1] > 1000, nodes
    return sum(nodes)


@pytest.fixture(scope="module")
def own_vi():
    """(segments without the frame build, the (inputs, state) of the port's
    own CPU stereo-inertial tracker at its first fused keyframe with
    visual-inertial BA, those of the fused frame after it: another n_kf and
    stamp), over test_torch_tracker_vi's scene and settings (the IMU
    initialized at frame 20). No reference runs."""
    import test_torch_tracker_vi as tvi  # it imports this module

    cfg = tvi.port_cfg(tvi._cfg(init_min_kfs=5))
    cam = TCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)  # tvi._cams()'s
    tracker = Tracker(cam, cfg, "cpu")
    frames = synthetic.make_sequence(cam, tvi.N_FRAMES, "cpu", fps=cfg.fps, traj=synthetic.Trajectory(**tvi.TRAJ),
                                     room_half=2.55)
    first, later = own_fused_frames(tracker, frames)
    assert tracker.imu_ready and bool(first[0]["wide"])  # after the initialization, in the widened window
    return tstep.vi_segments(cam, cfg, tracker.voc_pt, tracker.voc_ln, lambda fd: fd), first, later


@pytest.mark.parametrize("step", ["vi"])
def test_segments_trace_in_fake_mode(own_vi, step):
    """(b) for the stereo-inertial step (the visual one: test_torch_one_program.py's program trace)."""
    segs, first, _ = own_vi
    check_segments_trace(segs, first)


def check_replay_on_later_frame(segs, first, last, step):
    """(c) T and K traced in real mode at a keyframe with windowed BA and run
    on a later fused frame's inputs (another n_kf, stamp, pose, stores
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
