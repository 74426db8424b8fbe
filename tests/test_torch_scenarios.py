"""The reference's tracker scenarios run on the port's `Tracker` at 128x96
(`SlamConfig.tiny_test()`): test_streaming.py, test_far_triangulation.py
and test_covisibility.py (4), with the port's modules in place of the
reference's, the same scenes and the same assertions. The line-only
covisibility case takes the reference test's own frame (its jitted frame
builder finds two stereo lines where the port finds one); on the port's
frame that one line's landmark is lost to ROADMAP queue 3 B8, in both
packages, which the last test shows."""

import dataclasses

import numpy as np
import pytest
import torch

from pli_slam_tpu_torch.frontend import step as trk
from pli_slam_tpu_torch.frontend.frame import build_frame
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.utils import synthetic
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.worldmap import stores as st

torch.set_num_threads(1)
CPU = torch.device("cpu")
TINY_CAM = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, width=128, height=96)


def _run_streaming(streaming: bool):
    cfg = SlamConfig.tiny_test()
    cam = Camera.pinhole(bf=13.2, **TINY_CAM)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    tracker = Tracker(cam, cfg, CPU)
    tracker.streaming = streaming
    for fr in synthetic.make_sequence(cam, 18, CPU, fps=cfg.fps, traj=traj, room_half=2.55):
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    return tracker


def test_streaming_matches_sync():
    """Lag-1 stats readout (streaming) must not change the device chain:
    poses, keyframes and stores are those of the synchronous readout."""
    tr_s = _run_streaming(True)
    tr_y = _run_streaming(False)
    assert int(tr_s.n_kf) == int(tr_y.n_kf)
    np.testing.assert_allclose(tr_s.positions(), tr_y.positions(), atol=1e-5)
    np.testing.assert_array_equal(tr_s.kstore.valid.numpy(), tr_y.kstore.valid.numpy())


def _run_far(disable_tri: bool, monkeypatch):
    cfg = SlamConfig.tiny_test()
    # a tiny baseline: the stereo range cap 120*bf/fx = 6 m, and most of the room lies beyond it
    cam = Camera.pinhole(bf=6.0, **TINY_CAM)
    traj = synthetic.Trajectory(amp=(1.2, 0.8, 0.5), freq=(0.15, 0.19, 0.11), yaw_amp=0.3)
    if disable_tri:
        monkeypatch.setattr(trk, "far_point_depths",
                            lambda cam_, cfg_, frame, R, t, kf_view, kstore: torch.full_like(frame.depth, -1.0))
    tracker = Tracker(cam, cfg, CPU)
    gt = []
    for fr in synthetic.make_sequence(cam, 30, CPU, fps=cfg.fps, traj=traj):
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        gt.append(fr["p_w"])
    monkeypatch.undo()
    ate = synthetic.ate_rmse(tracker.positions(), np.stack(gt))
    x, valid = tracker.pstore.x.numpy(), tracker.pstore.valid.numpy()
    far = valid & (np.linalg.norm(x, axis=-1) > 120.0 * cam.bf / cam.fx)  # beyond close-stereo creation
    return ate, int(far.sum()), int(valid.sum())


def test_far_landmarks_created_and_accuracy_bounded(monkeypatch):
    """The epipolar triangulation channel creates far landmarks that plain
    stereo cannot, and the run stays within the scene's ATE noise band of the
    run without it (the reference's bound)."""
    ate_tri, far_tri, _ = _run_far(False, monkeypatch)
    ate_no, far_no, _ = _run_far(True, monkeypatch)
    assert far_tri > 0, "no far landmarks were created"
    assert far_tri > far_no, (far_tri, far_no)
    assert ate_tri <= ate_no + 0.12, (ate_tri, ate_no)


@pytest.fixture(scope="module")
def out_and_back():
    """Walk +x and return: the first and last keyframes see the same wall
    (covisible) while temporally far apart."""
    cfg = SlamConfig.tiny_test()
    cam = Camera.pinhole(bf=13.2, **TINY_CAM)
    traj = synthetic.Trajectory(amp=(0.9, 0.05, 0.03), freq=(0.4, 0.19, 0.11), yaw_amp=0.03)
    tracker = Tracker(cam, cfg, CPU)
    for fr in synthetic.make_sequence(cam, 26, CPU, fps=cfg.fps, traj=traj, room_half=2.55):
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    return tracker


def test_covis_counts_symmetric_and_adjacent(out_and_back):
    n = out_and_back.n_kf
    assert n >= 4
    covis = out_and_back.kstore.covis.numpy()[:n, :n]
    np.testing.assert_array_equal(covis, covis.T)
    assert np.all(np.diag(covis) == 0)
    adj = np.array([covis[k, k + 1] for k in range(n - 1)])
    assert (adj > 0).all(), adj  # temporal neighbours share landmarks


def test_covis_detects_revisit(out_and_back):
    """The last keyframe is covisible with an early one (the same viewpoint)."""
    n = out_and_back.n_kf
    covis = out_and_back.kstore.covis.numpy()[:n, :n]
    assert covis[n - 1, :max(n // 3, 1)].max() > 0, covis[n - 1]


def test_covis_window_prefers_covisible(out_and_back):
    """`_covis_window` pulls a covisible but temporally distant keyframe
    into the BA window, which a temporal window would miss."""
    tracker = out_and_back
    n = tracker.n_kf
    cfg = tracker.cfg
    W = cfg.opt.local_ba_window
    if n <= W:  # too short to tell the two apart: a synthetic graph
        K = tracker.kstore.covis.shape[0]
        covis = np.zeros((K, K), np.int32)
        n = W + 4
        for k in range(n - 1):  # a weak chain
            covis[k, k + 1] = covis[k + 1, k] = 2
        covis[n - 1, 0] = covis[0, n - 1] = 50  # a strong revisit edge
        valid = tracker.kstore.valid.clone()
        valid[:n] = True
        kstore = dataclasses.replace(tracker.kstore, covis=torch.as_tensor(covis), valid=valid)
    else:
        covis = tracker.kstore.covis.numpy()
        covis_n = covis[:n, :n].copy()
        covis_n[n - 1, 0] = covis_n[0, n - 1] = max(50, covis_n.max() + 1)
        covis = np.zeros_like(covis)
        covis[:n, :n] = covis_n
        kstore = dataclasses.replace(tracker.kstore, covis=torch.as_tensor(covis))
    window, fixed = trk._covis_window(cfg, kstore, n - 1, n)
    window = np.asarray(window.numpy() if isinstance(window, torch.Tensor) else window)
    assert 0 in window.tolist(), window  # the revisited keyframe is in
    assert int(np.asarray(fixed.numpy() if isinstance(fixed, torch.Tensor) else fixed).sum()) >= 1
    assert window[0] == n - 1


def _insert_two(frame, shared_lines):
    """KF0 from `frame`; every point landmark killed; KF1 from the same frame
    re-observing KF0's line landmarks (`shared_lines`) or none. Returns (KF0's
    line slots, line store after KF0, covisibility after KF1)."""
    cfg = SlamConfig.tiny_test()
    cam = Camera.pinhole(bf=13.2, **TINY_CAM)
    m = cfg.map
    pstore = st.PointStore.empty(m.max_points, device=CPU)
    lstore = st.LineStore.empty(m.max_lines, device=CPU)
    kstore = st.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, CPU)
    R, t = torch.eye(3), torch.zeros(3)
    nf, nl = cfg.orb.n_features, cfg.lines.n_lines
    no_pt = (torch.full((nf,), -1, dtype=torch.int32), torch.zeros(nf, dtype=torch.bool))
    no_ln = (torch.full((nl,), -1, dtype=torch.int32), torch.zeros(nl, dtype=torch.bool))
    pstore, lstore, kstore, _ = trk.insert_keyframe(cam, cfg, frame, R, t, 0.0, *no_pt, *no_ln, 0, pstore, lstore,
                                                    kstore)
    ln0 = kstore.obs_ln[0].clone()
    lstore0 = lstore
    pstore = dataclasses.replace(pstore, valid=torch.zeros_like(pstore.valid))
    ln = (ln0.to(torch.int32), ln0 >= 0) if shared_lines else no_ln
    _, _, kstore, _ = trk.insert_keyframe(cam, cfg, frame, R, t, 0.5, *no_pt, *ln, 1, pstore, lstore, kstore)
    return ln0, lstore0, kstore.covis.numpy()


def _reference_frame():
    """test_covisibility.py's first frame as the reference test builds it
    (`make_build_frame`, jitted), converted to the port's FrameData."""
    import jax
    import jax.numpy as jnp

    from pli_slam_tpu.frontend.frame import make_build_frame
    from pli_slam_tpu.ops.camera import Camera as JCamera
    from pli_slam_tpu.utils import synthetic as jsyn
    from pli_slam_tpu.utils.config import SlamConfig as JSlamConfig
    from pli_slam_tpu_torch.utils import convert

    cfg = JSlamConfig.tiny_test()
    cam = JCamera.pinhole(bf=13.2, **TINY_CAM)
    fr = next(iter(jsyn.make_sequence(cam, 1, fps=cfg.fps)))
    frame = make_build_frame(cam, cfg)(jnp.asarray(fr["img_l"]), jnp.asarray(fr["img_r"]))
    return convert.frame_data(jax.tree_util.tree_map(np.asarray, frame))


def test_line_only_covisibility_weight():
    """Line observations count in covisibility weights (the reference's line
    increment is commented out, src/KeyFrame.cc:573-590): a keyframe that
    shares ONLY line landmarks with an earlier one still gets an edge. On the
    reference test's own input, the frame its jitted `make_build_frame` builds
    (two stereo lines; the port's own frame of the scene has one, see the
    next test)."""
    frame = _reference_frame()
    ln0, _, covis = _insert_two(frame, shared_lines=True)
    n_shared = int((ln0 >= 0).sum())
    assert n_shared > 0
    assert covis[1, 0] > 0, covis[:2, :2]
    assert covis[1, 0] <= n_shared
    assert covis[0, 1] == covis[1, 0]
    _, _, covis_none = _insert_two(frame, shared_lines=False)
    assert covis_none[1, 0] == 0  # the edge comes from the shared lines alone


def test_new_landmark_in_slot_zero_is_lost_in_both():
    """ROADMAP queue 3 B8, shared with the reference: `insert_keyframe` loses
    a new landmark allocated to slot 0 (unallocated features clamp to slot 0
    and write its old row back last). The port's frame of the scene above has
    one stereo line; its landmark goes to slot 0 and is lost, in the
    reference's `insert_keyframe` on the same frame as in the port's, so KF1
    has no line to share and no edge."""
    import jax
    import jax.numpy as jnp

    from pli_slam_tpu.frontend import frame as jframe
    from pli_slam_tpu.frontend import tracker as jtrk
    from pli_slam_tpu.ops.camera import Camera as JCamera
    from pli_slam_tpu.ops.lines import LineFeatures as JLines
    from pli_slam_tpu.ops.orb import Features as JFeatures
    from pli_slam_tpu.utils.config import SlamConfig as JSlamConfig
    from pli_slam_tpu.worldmap import stores as jst

    cfg, cam = SlamConfig.tiny_test(), Camera.pinhole(bf=13.2, **TINY_CAM)
    fr = next(iter(synthetic.make_sequence(cam, 1, CPU, fps=cfg.fps)))
    frame = build_frame(cam, cfg, fr["img_l"], fr["img_r"])
    assert int(frame.line_ok.sum()) == 1
    ln0, lstore, covis = _insert_two(frame, shared_lines=True)
    assert ln0[ln0 >= 0].tolist() == [0] and not bool(lstore.valid[0])
    assert covis[1, 0] == 0

    def to_jax(obj, cls):
        nested = {"feats": JFeatures, "lines": JLines}
        return cls(**{f.name: to_jax(getattr(obj, f.name), nested[f.name]) if f.name in nested
                      else jnp.asarray(getattr(obj, f.name).numpy()) for f in dataclasses.fields(obj)})

    jcfg, jcam = JSlamConfig.tiny_test(), JCamera.pinhole(bf=13.2, **TINY_CAM)
    m, nf, nl = jcfg.map, jcfg.orb.n_features, jcfg.lines.n_lines
    out = jax.jit(lambda *a: jtrk.insert_keyframe(jcam, jcfg, *a))(
        to_jax(frame, jframe.FrameData), jnp.eye(3), jnp.zeros(3), 0.0, jnp.full(nf, -1, jnp.int32),
        jnp.zeros(nf, bool), jnp.full(nl, -1, jnp.int32), jnp.zeros(nl, bool), 0, jst.PointStore.empty(m.max_points),
        jst.LineStore.empty(m.max_lines), jst.KeyFrameStore.empty(m.max_keyframes, nf, nl))
    jln0 = np.asarray(out[2].obs_ln[0])
    assert jln0[jln0 >= 0].tolist() == [0] and not bool(out[1].valid[0])
