"""Parity of the port's solve/ and worldmap/ modules with the JAX package.

Same numpy inputs through both packages. Tolerances:
- residuals / Jacobians: 1e-4 relative (float32 geometry, transcendentals);
- pose GN and bundle adjustment: poses 1e-4, landmarks 3e-3, cost 1e-2
  relative -- every iteration's 6x6 / [6W,6W] solve runs through another
  LAPACK path, and the differences stay at float32 rounding level;
- inlier masks and integer bookkeeping: exact;
- LSH words: at most 1% of words may differ (a projection within float
  rounding of 0 flips its bit, see worldmap.vocab).
"""


import jax
import jax.numpy as jnp
import numpy as np
import torch

from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.solve import ba as jba
from pli_slam_tpu.solve import gn as jgn
from pli_slam_tpu.solve import residuals as jres
from pli_slam_tpu.solve import triangulate as jtri
from pli_slam_tpu.utils.config import OptimizerConfig, SlamConfig
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu.worldmap import vocab as jvoc
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.solve import gn as tgn
from pli_slam_tpu_torch.solve import residuals as tres
from pli_slam_tpu_torch.solve import triangulate as ttri
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.worldmap import stores as tst
from pli_slam_tpu_torch.worldmap import vocab as tvoc

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2)
JC, TC = jcam.Camera.pinhole(**CAM_ARGS), tcam.Camera.pinhole(**CAM_ARGS)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol)


def _scene(rng, P=96, L=16):
    pts = np.stack([rng.uniform(-3, 4, P), rng.uniform(-2, 2, P), rng.uniform(4, 12, P)], -1).astype(np.float32)
    xs = np.stack([rng.uniform(-3, 4, L), rng.uniform(-2, 2, L), rng.uniform(4, 12, L)], -1).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    xe = xs + d / np.linalg.norm(d, axis=-1, keepdims=True) * 1.2
    return pts, xs, xe


def _line_obs(R, t, xs, xe):
    uv_s = np.asarray(jcam.project(JC, xs @ R.T + t))
    uv_e = np.asarray(jcam.project(JC, xe @ R.T + t))
    l = np.cross(np.concatenate([uv_s, np.ones((len(xs), 1))], -1), np.concatenate([uv_e, np.ones((len(xs), 1))], -1))
    return (l / np.linalg.norm(l[:, :2], axis=-1, keepdims=True)).astype(np.float32)


def test_residuals_parity():
    rng = np.random.default_rng(0)
    pts, xs, xe = _scene(rng)
    R, t = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.1, jnp.float32)))
    uvr = np.asarray(jcam.stereo_project(JC, pts @ R.T + t)) + rng.normal(size=(len(pts), 3)).astype(np.float32)
    l_obs = _line_obs(R, t, xs, xe) + rng.normal(size=(len(xs), 3)).astype(np.float32) * 1e-3
    for a, b in zip(tres.point_residuals_stereo(TC, T(R), T(t), T(pts), T(uvr)),
                    jres.point_residuals_stereo(JC, R, t, pts, uvr)):
        close(a, b, atol=1e-3)
    rt = tres.line_residuals(TC, T(R), T(t), T(xs), T(xe), T(l_obs))
    rj = jres.line_residuals(JC, R, t, xs, xe, l_obs)
    close(rt[0], rj[0], atol=1e-3)
    close(rt[1], rj[1], atol=1e-2)


def test_solve_pose_parity():
    """Perturbed pose, noisy stereo points with 15% gross outliers, lines."""
    rng = np.random.default_rng(1)
    pts, xs, xe = _scene(rng, P=160, L=24)
    R_true, t_true = np.eye(3, dtype=np.float32), np.array([0.1, -0.05, 0.2], np.float32)
    uvr = np.asarray(jcam.stereo_project(JC, pts @ R_true.T + t_true))
    uvr = (uvr + rng.normal(size=uvr.shape) * 0.5).astype(np.float32)
    bad = rng.random(len(pts)) < 0.15
    uvr[bad] += rng.uniform(-40, 40, size=(bad.sum(), 3)).astype(np.float32)
    stereo = rng.random(len(pts)) > 0.2
    l_obs = _line_obs(R_true, t_true, xs, xe)
    obs = dict(x_w=pts, uvr=uvr, stereo_mask=stereo, point_mask=rng.random(len(pts)) > 0.05,
               sigma2_pt=np.float32(1.2) ** rng.integers(0, 3, len(pts)).astype(np.float32) ** 2,
               xs_w=xs, xe_w=xe, l_obs=l_obs, line_mask=np.ones(len(xs), bool),
               sigma2_ln=np.full(len(xs), 4.0, np.float32))
    dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray([0.02, -0.01, 0.03, 0.01, -0.02, 0.005], jnp.float32)))
    R0, t0 = dR @ R_true, dR @ t_true + dt
    cfg = OptimizerConfig()
    rj = jax.jit(lambda o, R, t: jgn.solve_pose(JC, o, R, t, cfg))(jgn.PoseObservations(**obs), R0, t0)
    rt = tgn.solve_pose(TC, tgn.PoseObservations(**{k: T(v) for k, v in obs.items()}), T(R0), T(t0), cfg)
    close(rt.R_cw, rj.R_cw, atol=1e-5)
    close(rt.t_cw, rj.t_cw, atol=1e-4)
    np.testing.assert_array_equal(rt.inlier_pt.numpy(), np.asarray(rj.inlier_pt))
    np.testing.assert_array_equal(rt.inlier_ln.numpy(), np.asarray(rj.inlier_ln))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    close(rt.cost, rj.cost, rtol=1e-3)
    assert np.abs(np.asarray(rj.t_cw) - t_true).max() < 0.02  # and both really converge


def test_triangulation_parity():
    rng = np.random.default_rng(2)
    pts, _, _ = _scene(rng, P=64)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2, t2 = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray([-0.3, 0.02, 0.01, 0.0, 0.03, 0.0], jnp.float32)))
    uv1 = np.asarray(jcam.project(JC, pts @ R1.T + t1)) + rng.normal(size=(64, 2)).astype(np.float32) * 0.3
    uv2 = np.asarray(jcam.project(JC, pts @ R2.T + t2)) + rng.normal(size=(64, 2)).astype(np.float32) * 0.3
    ray1, ray2 = np.asarray(jcam.unproject(JC, uv1)), np.asarray(jcam.unproject(JC, uv2))
    Xj = jtri.triangulate_dlt(R1, t1, R2, t2, ray1, ray2)
    Xt = ttri.triangulate_dlt(T(R1), T(t1), T(R2), T(t2), T(ray1), T(ray2))
    close(Xt, Xj, rtol=1e-3, atol=1e-3)
    s2 = np.ones(64, np.float32)
    np.testing.assert_array_equal(
        ttri.triangulation_checks(TC, T(R1), T(t1), T(R2), T(t2), T(np.asarray(Xj)), T(uv1), T(uv2), T(s2), T(s2)).numpy(),
        np.asarray(jtri.triangulation_checks(JC, R1, t1, R2, t2, Xj, uv1, uv2, s2, s2)))


def test_stores_parity():
    cfg = SlamConfig.tiny_test().map
    for jstore, tstore in ((jst.PointStore.empty(cfg.max_points), tst.PointStore.empty(cfg.max_points)),
                           (jst.LineStore.empty(cfg.max_lines), tst.LineStore.empty(cfg.max_lines)),
                           (jst.KeyFrameStore.empty(cfg.max_keyframes, 256, 32), tst.KeyFrameStore.empty(cfg.max_keyframes, 256, 32))):
        a, b = convert.to_numpy(jstore), convert.to_numpy(tstore)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    rng = np.random.default_rng(3)
    for n_free in (0, 5, 40, 100):
        free = np.zeros(100, bool)
        free[rng.permutation(100)[:n_free]] = True
        want = rng.random(60) > 0.4
        for a, b in zip(tst.alloc_slots(T(free), T(want)), jst.alloc_slots(free, want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _ba_problem(rng, W=4, P=48, L=12):
    pts, xs, xe = _scene(rng, P=P, L=L)
    R_true = np.stack([np.eye(3, dtype=np.float32)] * W)
    t_true = np.array([[-0.3 * w, 0.0, 0.0] for w in range(W)], np.float32)
    po_uvr, lo_l = [], []
    for w in range(W):
        uvr = np.asarray(jcam.stereo_project(JC, pts @ R_true[w].T + t_true[w]))
        po_uvr.append(uvr + rng.normal(size=uvr.shape).astype(np.float32) * 0.3)
        lo_l.append(_line_obs(R_true[w], t_true[w], xs, xe))
    R0, t0 = R_true.copy(), t_true.copy()
    for w in range(1, W):
        dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.02, jnp.float32)))
        R0[w], t0[w] = dR @ R0[w], dR @ t0[w] + dt
    po_pt = np.tile(np.arange(P, dtype=np.int32), W)
    po_pt[rng.random(W * P) < 0.1] = -1  # empty observation slots
    po_uvr = np.concatenate(po_uvr).astype(np.float32)
    po_uvr[rng.random(W * P) < 0.05] += 25.0  # outliers for the second stage
    return dict(
        R=R0, t=t0, pose_mask=np.ones(W, bool), fixed_mask=np.arange(W) < 1,
        pts=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05, pt_mask=np.ones(P, bool),
        lns=np.concatenate([xs, xe], -1) + rng.normal(size=(L, 6)).astype(np.float32) * 0.05,
        ln_mask=np.ones(L, bool),
        po_pose=np.repeat(np.arange(W, dtype=np.int32), P), po_pt=po_pt, po_uvr=po_uvr,
        po_stereo=rng.random(W * P) > 0.2, po_sigma2=np.ones(W * P, np.float32), po_mask=np.ones(W * P, bool),
        lo_pose=np.repeat(np.arange(W, dtype=np.int32), L), lo_ln=np.tile(np.arange(L, dtype=np.int32), W),
        lo_l=np.concatenate(lo_l), lo_sigma2=np.full(W * L, 4.0, np.float32), lo_mask=np.ones(W * L, bool),
    )


def test_ba_parity():
    rng = np.random.default_rng(4)
    prob = _ba_problem(rng)
    cfg = OptimizerConfig()
    jp = jba.BAProblem(**prob)
    tp = tba.BAProblem(**{k: T(v) for k, v in prob.items()})
    ji = jba.prepare_indices(jp)
    ti = tba.prepare_indices(tp)
    for a, b in zip(ti, ji):
        for f in ("perm", "gat", "gmask", "pose_of"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)
    m = rng.normal(size=(32, 6, 6)).astype(np.float32)
    spd = m @ m.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
    close(tba._inv6x6_spd(T(spd)), jba._inv6x6_spd(spd), rtol=1e-4, atol=1e-5)
    close(tba._inv3x3(T(spd[:, :3, :3])), jba._inv3x3(spd[:, :3, :3]), rtol=1e-4, atol=1e-5)

    rj = jax.jit(lambda p: jba.solve_ba(JC, p, cfg))(jp)
    rt = tba.solve_ba(TC, tp, cfg)
    close(rt.R, rj.R, atol=1e-4)
    close(rt.t, rj.t, atol=1e-4)
    # landmark depth along the viewing ray is the weakly observed direction
    # (a few px of disparity at 8-12 m): float32 rounding in the Schur
    # solve moves it by up to ~2e-3 relative
    close(rt.pts, rj.pts, rtol=3e-3, atol=1e-3)
    # line endpoints: the residual never constrains motion ALONG the line
    # (ba.py stiffens that null direction with a regularizer), so compare
    # the offset across the line tightly and along it loosely
    lt, lj = rt.lns.numpy().reshape(-1, 2, 3), np.asarray(rj.lns).reshape(-1, 2, 3)
    u = lj[:, 1] - lj[:, 0]
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    diff = lt - lj
    along = np.sum(diff * u[:, None], axis=-1)
    across = diff - along[..., None] * u[:, None]
    assert np.abs(across).max() < 2e-3, np.abs(across).max()
    assert np.abs(along).max() < 2e-2, np.abs(along).max()
    # the stage-2 cost sums over the observations stage 1 kept: one chi2
    # within rounding of the prune gate changes the sum by one term
    close(rt.cost, rj.cost, rtol=1e-2)
    keep_j = np.asarray(rj.po_chi2) < cfg.prune_chi2_pt
    agree = (rt.po_chi2.numpy() < cfg.prune_chi2_pt) == keep_j
    assert agree.mean() > 0.995  # the outlier verdicts agree (chi2 within rounding of the gate may flip)
    ec_t = tba.evaluate_cost(TC, tp, *(T(np.asarray(x)) for x in (rj.R, rj.t, rj.pts, rj.lns)), cfg)
    ec_j = jba.evaluate_cost(JC, jp, rj.R, rj.t, rj.pts, rj.lns, cfg)
    close(ec_t[0], ec_j[0], rtol=1e-4)


def test_vocab_parity():
    rng = np.random.default_rng(5)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(300, 256))
    valid = rng.random(300) > 0.2
    jv, tv = jvoc.Vocabulary(seed=17), convert.vocabulary(jvoc.Vocabulary(seed=17))
    np.testing.assert_array_equal(tv.planes().numpy(), np.asarray(jv.planes()))
    wj, wt = np.asarray(jv.words(desc, valid)), tv.words(T(desc), T(valid)).numpy()
    assert (wj != wt).mean() <= 0.01
    close(tv.bow(T(desc), T(valid)), jv.bow(desc, valid), rtol=0, atol=0.05)

    K, W = 24, jv.n_words
    db = jvoc.BowDatabase.empty(K, W)
    tdb = tvoc.BowDatabase.empty(K, W)
    for k in range(12):
        d = rng.choice(np.array([-1, 1], np.int8), size=(80, 256))
        bp, bl = jv.bow(d, np.ones(80, bool)), jv.bow(d[:20], np.ones(20, bool))
        db = db.add(k, bp, bl)
        tdb = tdb.add(k, T(np.asarray(bp)), T(np.asarray(bl)))
    for a, b in zip(convert.to_numpy(tdb).values(), convert.to_numpy(jax.tree_util.tree_map(np.asarray, db)).values()):
        np.testing.assert_array_equal(a, b)
    covis = rng.integers(0, 30, size=(K, K)).astype(np.int32)
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    q = db.hist_pt[3] * 0.8 + db.hist_pt[7] * 0.2
    excl = np.arange(K) >= 10
    for cv in (None, covis):
        sj, scj = jvoc.query(db, q, db.hist_ln[3], excl, n_best=3, covis=cv)
        st_, sct = tvoc.query(tdb, T(np.asarray(q)), T(np.asarray(db.hist_ln[3])), T(excl), n_best=3,
                              covis=None if cv is None else T(cv))
        np.testing.assert_array_equal(st_.numpy(), np.asarray(sj))
        close(sct, scj, rtol=1e-5, atol=1e-6)
