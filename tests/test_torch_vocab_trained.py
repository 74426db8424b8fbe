"""The port's trained vocabulary against the reference's (mirrors
tests/test_vocab_trained.py).

Descriptors are harvested with the port's ORB and line detector from
rendered 128x96 frames (numpy inputs to both packages). Held:
`train_vocabulary` gives exactly the reference's centroids and IDF from
the same seed (also with fewer descriptors than words, and with an empty
image); `words` exactly the reference's; `bow` / `bow_rows` within 1e-6;
a vocabulary saved by either package loads in the other. Then both
trackers (the reference on its accelerator branch, as in
test_torch_tracker.py) run 8 frames with one trained vocabulary for
points and lines: the same keyframes, BoW rows and loop-query slots, and
from identical stores every rebuilt BoW row within 1e-6 (details in the
test's docstring).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig
from pli_slam_tpu.worldmap import vocab as jvoc
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops import lines as tlines
from pli_slam_tpu_torch.ops import orb as torb
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn
from pli_slam_tpu_torch.worldmap import vocab as tvoc

torch.set_num_threads(1)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
JCAM = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
N_WORDS = 96


@pytest.fixture(scope="module")
def harvest():
    """Per-image (ORB, line) descriptor sets of 6 rendered frames."""
    cfg = convert.config_from_reference(dataclasses.asdict(SlamConfig.tiny_test()))
    cam = convert.camera(jax.tree_util.tree_map(np.asarray, JCAM))
    pts, lns = [], []
    for fr in tsyn.make_sequence(cam, 6, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ), room_half=2.55):
        f, ln = torb.extract(fr["img_l"], cfg.orb), tlines.detect(fr["img_l"], cfg.lines)
        pts.append(f.desc[f.valid].numpy())
        lns.append(ln.desc[ln.valid].numpy())
    return pts, lns


@pytest.fixture(scope="module")
def vocabs(harvest):
    pts, _ = harvest
    return (tvoc.train_vocabulary(pts, n_words=N_WORDS, iters=6, seed=5),
            jvoc.train_vocabulary(pts, n_words=N_WORDS, iters=6, seed=5))


def test_training_is_exact(harvest, vocabs):
    pts, lns = harvest
    t, j = vocabs
    assert t.centroids.dtype == j.centroids.dtype == np.int8
    np.testing.assert_array_equal(t.centroids, j.centroids)
    np.testing.assert_array_equal(t.idf, j.idf)
    # fewer descriptors than words (the resampling branch) and an empty image
    sets = [lns[0][:20], np.zeros((0, 256), np.int8), lns[1][:15]]
    t2, j2 = tvoc.train_vocabulary(sets, n_words=64, iters=3, seed=1), jvoc.train_vocabulary(sets, 64, 3, 1)
    np.testing.assert_array_equal(t2.centroids, j2.centroids)
    np.testing.assert_array_equal(t2.idf, j2.idf)


def test_words_and_bow(harvest, vocabs):
    pts, _ = harvest
    t, j = vocabs
    desc = np.concatenate(pts[:3])
    valid = np.arange(len(desc)) % 7 != 3
    w_t = t.words(torch.as_tensor(desc), torch.as_tensor(valid)).numpy()
    w_j = np.asarray(j.words(jnp.asarray(desc), jnp.asarray(valid)))
    np.testing.assert_array_equal(w_t, w_j)
    rows, jrows = [], []
    for d in pts[:4]:
        d = d[:120]
        v = np.ones(len(d), bool)
        rows.append(t.bow(torch.as_tensor(d), torch.as_tensor(v)).numpy())
        jrows.append(np.asarray(j.bow(jnp.asarray(d), jnp.asarray(v))))
    np.testing.assert_allclose(np.stack(rows), np.stack(jrows), atol=1e-6)
    batch = torch.as_tensor(np.stack([d[:120] for d in pts[:4]]))
    np.testing.assert_allclose(t.bow_rows(batch, torch.ones(batch.shape[:2], dtype=torch.bool)).numpy(),
                               np.stack(jrows), atol=1e-6)


def test_save_and_load_across_packages(tmp_path, vocabs):
    t, j = vocabs
    t.save(str(tmp_path / "port.npz"))
    j.save(str(tmp_path / "ref.npz"))
    for a, b in ((jvoc.TrainedVocabulary.load(str(tmp_path / "port.npz")), t),
                 (tvoc.TrainedVocabulary.load(str(tmp_path / "ref.npz")), j),
                 (convert.vocab_from_reference(j), t)):
        np.testing.assert_array_equal(a.centroids, b.centroids)
        np.testing.assert_array_equal(a.idf, b.idf)
        assert a.n_words == b.n_words == N_WORDS


def test_trackers_with_trained_vocabulary(vocabs):
    """Free runs: the same keyframes and BoW rows; each point row within
    1e-6 or, where the two trackers' landmark associations differ (they
    agree in count within test_torch_tracker's 10%), of cosine >= 0.95.
    Line rows are not compared there: at 128x96 a keyframe has a handful of
    segments, and the packages' detectors may pick a different one
    (test_torch_frame's 90%). From identical state (the reference's stores
    installed in the port's tracker) both packages' `rebuild_bow` give every
    point and line row within 1e-6 and the same slots for every keyframe's
    loop query."""
    t_voc, j_voc = vocabs
    cfg = dataclasses.replace(SlamConfig.tiny_test(), loop=LoopConfig(enabled=False),
                              map=dataclasses.replace(SlamConfig.tiny_test().map, max_points=2048,
                                                      local_map_points=2048))
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    try:
        tcam = convert.camera(jax.tree_util.tree_map(np.asarray, JCAM))
        jt = jtr.Tracker(JCAM, cfg, vocab_pt=j_voc, vocab_ln=j_voc)
        tt = Tracker(tcam, convert.config_from_reference(dataclasses.asdict(cfg)), "cpu", vocab_pt=t_voc,
                     vocab_ln=t_voc)
        for fr in jsyn.make_sequence(JCAM, 8, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55):
            il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
            jt.process(il, ir, fr["t"])
            tt.process(il, ir, fr["t"])
        K = cfg.map.max_keyframes
        assert tt.n_kf == jt.n_kf >= 3
        assert tt.bow_db.hist_pt.shape == tt.bow_db.hist_ln.shape == (K, N_WORDS)
        np.testing.assert_array_equal(tt.bow_db.valid.numpy(), np.asarray(jt.bow_db.valid))
        assert int(tt.bow_db.valid.sum()) == tt.n_kf - 1  # keyframe 0 gets no BoW row, in both

        # free run: the point rows (each keyframe's matched features)
        a, b = tt.bow_db.hist_pt.numpy(), np.asarray(jt.bow_db.hist_pt)
        same = np.abs(a - b).max(axis=1) <= 1e-6
        cos = np.sum(a * b, axis=1) / np.maximum(np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)
        assert np.all(same | (cos >= 0.95)), (np.nonzero(~same), cos)

        def check():
            for name in ("hist_pt", "hist_ln"):
                np.testing.assert_allclose(getattr(tt.bow_db, name).numpy(), np.asarray(getattr(jt.bow_db, name)),
                                           atol=1e-6)
            for k in range(1, tt.n_kf):
                st, _ = tvoc.query(tt.bow_db, tt.bow_db.hist_pt[k], tt.bow_db.hist_ln[k],
                                   torch.zeros(K, dtype=torch.bool), n_best=3)
                sj, _ = jvoc.query(jt.bow_db, jt.bow_db.hist_pt[k], jt.bow_db.hist_ln[k], jnp.zeros(K, bool), n_best=3)
                np.testing.assert_array_equal(st.numpy(), np.asarray(sj))

        j_np = lambda x: jax.tree_util.tree_map(np.asarray, x)  # noqa: E731
        tt.kstore, tt.pstore, tt.lstore = (convert.keyframe_store(j_np(jt.kstore)), convert.point_store(j_np(jt.pstore)),
                                           convert.line_store(j_np(jt.lstore)))
        tt.rebuild_bow()
        jt.rebuild_bow()
        check()
    finally:
        mp.undo()


def test_line_vocabulary_sizes_its_own_rows(vocabs):
    """A line vocabulary of another size than the point one: the port sizes
    each half of the BoW database by its own vocabulary (the reference sizes
    both by the point vocabulary's and cannot take such a pair)."""
    t_voc, _ = vocabs
    small = tvoc.TrainedVocabulary(centroids=t_voc.centroids[:40].copy(), idf=t_voc.idf[:40].copy())
    cfg = convert.config_from_reference(dataclasses.asdict(dataclasses.replace(
        SlamConfig.tiny_test(), loop=LoopConfig(enabled=False))))
    tr = Tracker(convert.camera(jax.tree_util.tree_map(np.asarray, JCAM)), cfg, "cpu", vocab_pt=t_voc,
                 vocab_ln=small)
    for fr in tsyn.make_sequence(tr.cam, 6, "cpu", fps=cfg.fps, traj=tsyn.Trajectory(**TRAJ), room_half=2.55):
        tr.process(fr["img_l"], fr["img_r"], fr["t"])
    assert tr.bow_db.hist_pt.shape[1] == N_WORDS and tr.bow_db.hist_ln.shape[1] == 40
    assert tr.n_kf >= 2 and int(tr.bow_db.valid.sum()) == tr.n_kf - 1
    tr.rebuild_bow()
    assert tr.bow_db.hist_ln.shape[1] == 40
