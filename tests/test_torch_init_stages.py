"""The map initializations' and the Atlas merge's stage programs, on the CPU.

`Tracker` runs the reference's last jitted programs through
`frontend.graphs.StageProgram` (captured on a GPU, eager here):
`mono_init_match` / `mono_init` (the two-view initialization, the draw on
the host between them) and `track_init`, `mono_depths` (a mono keyframe's
triangulated depths), `imu_init` (the inertial-only MAP problem and its
seeds, padded to 8 / 16 / 32 / ... keyframes; VIBA1 / VIBA2's scale
refinement in its `fix_bias` mode), and the merge's `merge_query`,
`merge_match`, `merge_verify` and `rebuild_bow`. Each is held against the
reference's function on the same seeded numpy inputs, at small sizes:

- `mono_depths` against `_mono_triangulated_depths`: depths within 1e-4
  relative, the same features triangulated;
- `mono_init_match` + `mono_init` (every decomposition through svd_small's
  plain versions: `torch.linalg.svd`, and `eigh` for A^T A's smallest
  eigenvector, `svd_small.smallest_eigvec`) against the reference's
  `_mono_reconstruct`, the reference's own draw in both: the same success and
  inlier set, the chosen rotation within 1e-4 and the translation within
  1e-4 of the reference's unit-median-depth scale, the depths within 1e-3
  relative. The scene's inliers are
  exact (the reference's minimal solvers are float32 eigen-solves of
  8-point samples: under pixel noise the winning F, and with it the
  inliers at the threshold, differ between the packages by float32
  rounding; test_torch_twoview holds that case at its looser bounds);
- `imu_init` padded to 16 slots (the scale refinement's form) and at
  exactly K slots (the initialization's) against the reference's unpadded chain of
  `estimate_gyro_bias`, `gravity_dir_seed`, `velocity_seed` and the jitted
  `inertial_optimization` at K = 10 and 11 (stereo, mono, and the scale
  refinement): gravity direction, scale, biases and velocities within 1e-4
  (the last iteration's cost within 1e-3 relative), the padded velocities
  zero;
- the merge's query, match and SE3 RANSAC against the reference's jitted
  programs (`_bow_of_kf_j` + `_query_db_j`, `_match_cross_j`,
  `_ransac_merge_j`) on two synthetic maps of the same landmarks, the
  reference's `jax.random.choice` draw in both: slots exact, scores within
  1e-6, matches exact, the pose within 1e-5 and the inliers exact;
  `rebuild_bow` against the reference's rebuild within 1e-6.

Every new stage is traced with `make_fx(tracing_mode="fake")` on the
arguments it gets (a host read, an index by a 0-d tensor or a constant
uploaded inside fails it), and replayed on stand-in graphs
(test_torch_stages.stand_in_capture) on a second set of arguments, equal to
eager bit for bit. What the CPU cannot show (that CUDA accepts the captures,
and the graphs against eager on the card) chip_smoke.py shows.
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from test_torch_graph_step import _fake_trace
from test_torch_inertial import _init_case
from test_torch_reloc_atlas import reference_draw as pnp_draw
from test_torch_stages import stand_in_capture
from test_torch_twoview import reference_draw as twoview_draw

from pli_slam_tpu.frontend import frame as jframe
from pli_slam_tpu.frontend import loop_closing as jlc
from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import lines as jlines
from pli_slam_tpu.ops import orb as jorb
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.solve import imu_init as jii
from pli_slam_tpu.solve import inertial as jinr
from pli_slam_tpu.solve import sim3 as jsim3
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu.worldmap import vocab as jvocab
from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import loop_closing as tlc
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.ops import imu as timu
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.solve import inertial as tinr
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = JCamera.pinhole(**CAM_ARGS), TCamera.pinhole(**CAM_ARGS)
CFG = SlamConfig.tiny_test().replace(sensor="mono")
TCFG = convert.config_from_reference(dataclasses.asdict(CFG))


def close(t, j, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# Synthetic mono frames: the same landmarks seen from two poses
# ---------------------------------------------------------------------------


def _frame(uv, desc, valid, depth=None):
    """A port FrameData of `CFG`'s shapes with these features (sigma2 1)."""
    f = tframe.empty_frame(TCFG)
    n = f.feats.uv.shape[0]
    feats = dataclasses.replace(f.feats, uv=T(uv, dtype=torch.float32), desc=T(desc, dtype=torch.int8),
                                valid=T(valid))
    d = torch.full((n,), -1.0) if depth is None else T(depth, dtype=torch.float32)
    return dataclasses.replace(f, feats=feats, depth=d)


def _reference_frame(f):
    """The reference's FrameData with the port frame's arrays."""
    def fields(cls, obj):
        return cls(**{k.name: jnp.asarray(getattr(obj, k.name).numpy()) for k in dataclasses.fields(cls)})

    rest = {k.name: jnp.asarray(getattr(f, k.name).numpy()) for k in dataclasses.fields(jframe.FrameData)
            if k.name not in ("feats", "lines")}
    return jframe.FrameData(feats=fields(jorb.Features, f.feats), lines=fields(jlines.LineFeatures, f.lines), **rest)


def _two_views(seed, R2, t2, n_pts=200, noise=0.0, n_outliers=20):
    """Two port frames of `n_pts` landmarks 2-6 m in front of view 1 (the
    identity) and view 2 (T_c2c1 = (R2, t2)), each landmark with its own
    descriptor (8 bits flipped in view 2), `n_outliers` features with
    descriptors of their own, in shuffled order. Returns (frame 1, frame 2,
    the landmarks in view 1)."""
    rng = np.random.default_rng(seed)
    n = TCFG.orb.n_features
    X = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts), rng.uniform(2, 6, n_pts)], -1)

    def project(Xc):
        return np.stack([CAM_ARGS["fx"] * Xc[:, 0] / Xc[:, 2] + CAM_ARGS["cx"],
                         CAM_ARGS["fy"] * Xc[:, 1] / Xc[:, 2] + CAM_ARGS["cy"]], -1)

    desc = rng.choice(np.int8([-1, 1]), size=(n_pts, 256))
    frames = []
    for k, Xc in enumerate((X, X @ R2.T + t2)):
        uv = np.zeros((n, 2), np.float32)
        d = np.zeros((n, 256), np.int8)
        valid = np.zeros(n, bool)
        order = rng.permutation(n_pts + n_outliers)
        d_k = desc.copy()
        if k:
            flip = rng.integers(0, 256, size=(n_pts, 8))
            np.put_along_axis(d_k, flip, -np.take_along_axis(d_k, flip, 1), 1)
        uv_k = project(Xc) + rng.normal(size=(n_pts, 2)) * noise
        uv_all = np.concatenate([uv_k, rng.uniform([0, 0], [128, 96], (n_outliers, 2))])
        d_all = np.concatenate([d_k, rng.choice(np.int8([-1, 1]), size=(n_outliers, 256))])
        uv[:len(order)] = uv_all[order]
        d[:len(order)] = d_all[order]
        valid[:len(order)] = True
        frames.append(_frame(uv, d, valid))
    return frames[0], frames[1], X


MOTION = (Rotation.from_rotvec([0.02, -0.06, 0.01]).as_matrix().astype(np.float32),
          np.float32([0.4, 0.05, 0.1]))


def test_mono_depths_against_reference():
    """Frame 2 triangulated against frame 1's view (keyframe slot 3 of a
    store holding its pose) through the stage: depths within 1e-4 relative,
    the same features triangulated."""
    f1, f2, _ = _two_views(1, *MOTION)
    R, t = MOTION
    eye, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    kR = np.tile(eye, (6, 1, 1)) * 0.5
    kt = np.ones((6, 3), np.float32)
    kR[3], kt[3] = eye, z3
    got = tstep.mono_depths(TC, TCFG, f2, T(R), T(t), f1.feats.uv, f1.feats.desc, f1.feats.valid,
                            torch.tensor(3, dtype=torch.int32), T(kR), T(kt))
    j1, j2 = _reference_frame(f1), _reference_frame(f2)
    want = np.asarray(jtr._mono_triangulated_depths(JC, CFG, j2, jnp.asarray(R), jnp.asarray(t), j1.feats.uv,
                                                    j1.feats.desc, j1.feats.valid, jnp.asarray(eye),
                                                    jnp.asarray(z3)))
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert (want > 0).sum() > 100
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


def _rotation_angle(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)) - 1) / 2,
                                   -1, 1)))


@pytest.mark.parametrize("seed", [2, 3])
def test_mono_init_against_reference(seed):
    """The two-view stages with the reference's draw against its
    `_mono_reconstruct`: success, the inlier count and the depths' valid
    set exact, R within 1e-4, t (scaled to a unit median depth) within 1e-4;
    the normalized depths, triangulated from those (R, t), within 1e-3
    relative (measured 2.7e-4); and R near the truth."""
    f1, f2, _ = _two_views(seed, *MOTION)
    draw_seed = 5 + seed
    idx, ok, probs = tstep.mono_init_match(TCFG, f1, f2)
    hyp = [twoview_draw(draw_seed, probs, (256, k)) for k in (8, 4)]
    R, t, depth1, read = tstep.mono_init(TC, f1, f2, idx, ok, *hyp)
    okj, Rj, tj, dj, nj = jtr._mono_reconstruct(JC, CFG, _reference_frame(f1), _reference_frame(f2),
                                                jax.random.PRNGKey(draw_seed))
    assert read.dtype == torch.int32 and read.tolist() == [int(bool(okj)), int(nj)]
    assert bool(okj) and int(nj) > 150
    close(R, Rj, 1e-4, msg="R")
    close(t, tj, 1e-4, msg="t")
    dj = np.asarray(dj)
    np.testing.assert_array_equal(depth1.numpy() > 0, dj > 0)
    np.testing.assert_allclose(depth1.numpy(), dj, rtol=1e-3, atol=1e-6)
    assert _rotation_angle(R.numpy(), MOTION[0]) < 1e-3
    # the eager composition the tests of solve.twoview use gives the same
    out = tstep._mono_reconstruct(TC, TCFG, f1, f2, twoview_draw, draw_seed)
    assert bool(out[0]) and torch.equal(out[1], R) and torch.equal(out[3], depth1) and int(out[4]) == int(nj)


# ---------------------------------------------------------------------------
# The inertial-only MAP problem, padded
# ---------------------------------------------------------------------------


def _imu_case(K: int, width: int, seed: int = 6):
    """test_torch_inertial's initialization case with K keyframes in the
    first K slots of port stores of `width` + 4 slots (the rest hold other
    values), Tbc the identity. Returns (kstore, pints, ext, numpy
    (chain, mask, R_wb, p_wb, stamps), the reference's chain)."""
    rng = np.random.default_rng(seed)
    chain, mask, R_wb, p_wb, stamps, _ = _init_case(rng, K)
    cap = width + 4
    R_k = np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1))
    R_k[:K] = np.transpose(R_wb, (0, 2, 1))
    t_k = rng.normal(size=(cap, 3)).astype(np.float32)
    t_k[:K] = -np.einsum("kij,kj->ki", R_k[:K], p_wb)
    st = np.arange(cap, dtype=np.float32) * 0.3 + 9.0
    st[:K] = stamps
    v = rng.normal(size=(cap, 3)).astype(np.float32)
    ks = dataclasses.replace(tstep.st.KeyFrameStore.empty(cap, 8, 4), R=T(R_k), t=T(t_k), stamp=T(st), v_w=T(v),
                             valid=T(np.arange(cap) < K))
    tchain = convert.preintegrated(chain)
    pints = timu.PreintStore.empty(cap)
    for i in range(K - 1):
        pints = pints.set(i + 1, timu._map(lambda a: a[i], tchain), bool(mask[i]))
    # a stale factor past the map (a slot the store held before): the chain's mask must drop it
    pints = pints.set(K, timu._map(lambda a: a[0], tchain), True)
    ext = tinr.Extrinsics.from_Tbc(np.eye(4, dtype=np.float32))
    # the reference's inputs from the same store (what its `_try_imu_init` computes)
    R_wb_j = np.einsum("kji,jm->kim", R_k[:K], np.eye(3, dtype=np.float32))
    p_wb_j = np.einsum("kji,kj->ki", R_k[:K], -t_k[:K])
    return ks, pints, ext, (mask, R_wb_j.astype(np.float32), p_wb_j.astype(np.float32), stamps, v[:K]), chain


@functools.cache
def _reference_map(imu, **kw):
    """The reference's jitted `inertial_optimization` for these static
    arguments (one compile for the padded and the exact case)."""
    return jax.jit(partial(jii.inertial_optimization, imu_cfg=imu, **kw))


@pytest.mark.parametrize("K,mode,padded", [(10, "stereo", True), (11, "mono", True), (11, "mono", False),
                                           (11, "refine", True)])
def test_imu_init_padded_against_reference(K, mode, padded):
    """The stage padded to 16 slots, and at exactly K (what the tracker runs
    for the initialization), against the reference's unpadded problem."""
    width = tstep.imu_init_width(K, 512) if padded else K
    assert width == (16 if padded else K)
    ks, pints, ext, (mask, R_wb, p_wb, stamps, v_k), chain = _imu_case(K, width)
    imu, cfg = CFG.imu, TCFG
    refine = mode == "refine"
    g_tilt = np.float32([0.3, -0.2, -9.8])
    bg_in, ba_in = np.float32([0.002, -0.001, 0.0005]), np.float32([0.01, 0.02, -0.01])
    gw = T(g_tilt) if refine else None
    fix_scale = mode == "stereo"
    g_w, bg, ba, v, read = tstep.imu_init(cfg, mode != "stereo", ks, pints, ext, torch.tensor(K, dtype=torch.int32),
                                          gw, T(bg_in), T(ba_in), width, fix_scale, refine)
    # the reference, unpadded, as its tracker calls it
    live = np.nonzero(mask)[0]
    if refine:
        g0 = jnp.asarray([0.0, 0.0, -imu.gravity])
        gwn, gz = jnp.asarray(g_tilt) / jnp.linalg.norm(g_tilt), g0 / jnp.linalg.norm(g0)
        axis = jnp.cross(gz, gwn)
        s_ang = jnp.linalg.norm(axis)
        Rwg0 = jnp.asarray(jax.jit(lambda a, s: jnp.where(s > 1e-6, jtr.lie.so3_exp(
            a / jnp.maximum(s, 1e-9) * jnp.arcsin(jnp.clip(s, -1, 1))), jnp.eye(3)))(axis, s_ang))
        v0, bg0, ba0, kw = v_k, bg_in, ba_in, dict(fix_scale=False, fix_bias=True)
    else:
        preints = [jax.tree_util.tree_map(lambda a: a[i], chain) for i in live]
        dRs = [R_wb[i].T @ R_wb[i + 1] for i in live]
        bg0 = np.asarray(jinr.estimate_gyro_bias(preints, [jnp.asarray(d) for d in dRs], prior_info=1.0))
        Rwg0 = jii.gravity_dir_seed(chain, mask, R_wb, imu.gravity)
        v0 = np.asarray(jii.velocity_seed(p_wb, stamps))
        ba0 = np.zeros(3, np.float32)
        kw = dict(prior_g=1e2, prior_a=1e5 if fix_scale else 1e6, fix_scale=fix_scale)
    oj = _reference_map(imu, **kw)(chain, jnp.asarray(mask), jnp.asarray(R_wb), jnp.asarray(p_wb), jnp.asarray(v0),
                                   Rwg0, jnp.asarray(bg0), jnp.asarray(ba0))
    gj = np.asarray(oj[0]) @ np.float32([0.0, 0.0, -imu.gravity])
    n_live, scale, finite, cost0, cost1 = read.tolist()
    assert read.dtype == torch.float32 and n_live == len(live) and finite == 1.0
    cos = float(g_w.numpy() @ gj / np.linalg.norm(g_w.numpy()) / np.linalg.norm(gj))
    assert np.degrees(np.arccos(min(cos, 1.0))) < 1e-4 * np.degrees(1.0), cos
    close(scale, oj[1], 1e-4, msg="scale")
    close(bg, oj[2], 1e-4, msg="bg")
    close(ba, oj[3], 1e-4, msg="ba")
    close(v[:K], oj[4], 1e-4, msg="v")
    assert torch.equal(v[K:], torch.zeros_like(v[K:])), "a padded velocity moved"
    close(cost1, oj[5][-1], 0, rtol=1e-3, msg="last cost")
    if refine:
        close(bg, bg_in, 0)
        close(ba, ba_in, 0)


def test_gyro_bias_chain_equals_the_list_form():
    """`estimate_gyro_bias_chain` (over the masked chain on the device)
    against the port's list form on the live factors bit for bit, and the
    reference's within 1e-6 rad/s."""
    rng = np.random.default_rng(7)
    chain, mask, R_wb, _, _, _ = _init_case(rng, 9)
    tchain = convert.preintegrated(chain)
    got = tinr.estimate_gyro_bias_chain(tchain, T(mask), T(R_wb), prior_info=1.0)
    live = np.nonzero(mask)[0]
    R = T(R_wb)
    listed = tinr.estimate_gyro_bias([timu._map(lambda a: a[i], tchain) for i in live],
                                     [R[i].T @ R[i + 1] for i in live], prior_info=1.0)
    assert torch.equal(got, listed)
    want = jinr.estimate_gyro_bias([jax.tree_util.tree_map(lambda a: a[i], chain) for i in live],
                                   [jnp.asarray(R_wb[i].T @ R_wb[i + 1]) for i in live], prior_info=1.0)
    close(got, want, 1e-6)


# ---------------------------------------------------------------------------
# The Atlas merge
# ---------------------------------------------------------------------------

MERGE_R = Rotation.from_rotvec([0.05, -0.3, 0.1]).as_matrix().astype(np.float32)
MERGE_T = np.float32([0.7, -0.2, 0.4])


def _merge_maps(seed=9):
    """Two reference maps of 120 shared landmarks (map b = map a under
    (MERGE_R, MERGE_T), 6 descriptor bits flipped, 10 landmarks moved by a
    metre) plus landmarks of their own, keyframe 2 of map a and keyframe 4
    of map b observing them. Returns the reference's (ps, ls, ks) of both."""
    rng = np.random.default_rng(seed)
    cfg = CFG
    P, L, K, N, NL = cfg.map.max_points, cfg.map.max_lines, cfg.map.max_keyframes, 64 * 4, cfg.lines.n_lines
    shared = 120
    maps = []
    xa = rng.uniform(-3, 3, (shared, 3)).astype(np.float32)
    da = rng.choice(np.int8([-1, 1]), size=(shared, 256))
    for k, (x_s, kf) in enumerate(((xa, 2), (xa @ MERGE_R.T + MERGE_T, 4))):
        d_s = da.copy()
        if k:
            flip = rng.integers(0, 256, size=(shared, 6))
            np.put_along_axis(d_s, flip, -np.take_along_axis(d_s, flip, 1), 1)
            x_s = x_s.copy()
            x_s[:10] += 1.0
        own = 200
        x = np.zeros((P, 3), np.float32)
        d = np.zeros((P, 256), np.int8)
        slots = rng.permutation(400)[:shared + own]
        x[slots] = np.concatenate([x_s, rng.uniform(-3, 3, (own, 3))]).astype(np.float32)
        d[slots] = np.concatenate([d_s, rng.choice(np.int8([-1, 1]), size=(own, 256))])
        valid = np.zeros(P, bool)
        valid[slots] = True
        ps = dataclasses.replace(jst.PointStore.empty(P), x=jnp.asarray(x), desc=jnp.asarray(d),
                                 valid=jnp.asarray(valid))
        ls = jst.LineStore.empty(L)
        ks = jst.KeyFrameStore.empty(K, N, NL)
        obs = np.full((K, N), -1, np.int32)
        for j in range(6):
            pick = rng.permutation(shared + own)[:150]
            obs[j, :150] = slots[pick]
        obs[kf, :shared + 20] = np.concatenate([slots[:shared], slots[shared:shared + 20]])
        kvalid = np.arange(K) < 6
        ks = dataclasses.replace(ks, obs_pt=jnp.asarray(obs), valid=jnp.asarray(kvalid))
        maps.append((ps, ls, ks))
    return maps


def _port(ps, ls, ks):
    return convert.point_store(jax.tree_util.tree_map(np.asarray, ps)), \
        convert.line_store(jax.tree_util.tree_map(np.asarray, ls)), \
        convert.keyframe_store(jax.tree_util.tree_map(np.asarray, ks))


def test_merge_stages_against_reference():
    (jpa, jla, jka), (jpb, jlb, jkb) = _merge_maps()
    (pa, la, ka), (pb, lb, kb) = _port(jpa, jla, jka), _port(jpb, jlb, jkb)
    jvoc_pt, jvoc_ln = jvocab.Vocabulary(seed=17), jvocab.Vocabulary(seed=23)
    voc_pt, voc_ln = convert.vocabulary(jvoc_pt), convert.vocabulary(jvoc_ln)
    i32 = torch.int32
    # rebuild_bow: map b's database, the reference's jitted rebuild (its tracker's `rebuild_bow` body)
    db_b = tstep.rebuild_bow(voc_pt, voc_ln, kb, pb, lb)
    jt = jtr.Tracker.__new__(jtr.Tracker)
    jt.kstore, jt.pstore, jt.lstore, jt.voc_pt, jt.voc_ln, jt.n_kf = jkb, jpb, jlb, jvoc_pt, jvoc_ln, 0
    jtr.Tracker.rebuild_bow(jt)
    for name in ("hist_pt", "hist_ln", "valid"):
        close(getattr(db_b, name), getattr(jt.bow_db, name), 1e-6, msg=name)
    # merge_query: map a's keyframe 2 against the parked databases (b's, and an empty one)
    empty = tstep.vocab_mod.BowDatabase.empty(CFG.map.max_keyframes, voc_pt.n_words, n_words_ln=voc_ln.n_words)
    found = tstep.merge_query(voc_pt, voc_ln, ka, pa, la, torch.tensor(2, dtype=i32), (db_b, empty))
    ids = jka.obs_pt[2]
    m = (ids >= 0) & jpa.valid[jnp.maximum(ids, 0)]
    jbp = jvoc_pt.bow(jpa.desc[jnp.maximum(ids, 0)], m)
    lids = jka.obs_ln[2]
    jbl = jvoc_ln.bow(jla.desc[jnp.maximum(lids, 0)], (lids >= 0) & jla.valid[jnp.maximum(lids, 0)])
    slots, scores = jax.jit(lambda db, bp, bl: jvocab.query(db, bp, bl, jnp.zeros(db.valid.shape[0], bool),
                                                            n_best=1))(jt.bow_db, jbp, jbl)
    assert found.shape == (2, 2) and int(found[0, 0]) == int(slots[0]) == 4
    close(found[0, 1], scores[0], 1e-6)
    assert float(found[1, 1]) == -1.0  # nothing valid in the empty database
    # merge_match + the reference's draw + merge_verify
    xa, xb, idx_b, mm, probs = tlc.merge_match(ka, pa, torch.tensor(2, dtype=i32), kb, pb,
                                               torch.tensor(4, dtype=i32))
    jx, jy, jidx, jm = jax.jit(jlc.match_cross_map)(jka, jpa, 2, jkb, jpb, 4)
    np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(idx_b.numpy(), np.asarray(jidx))
    close(xa, jx, 0)
    close(xb, jy, 0)
    assert int(mm.sum()) >= 100
    H, seed = CFG.loop.sim3_hypotheses, 1000 + 2
    hyp = pnp_draw(seed, probs, (H, 3))
    R, t, fuse_src, fuse_dst, read = tlc.merge_verify(ka, torch.tensor(2, dtype=i32), xa, xb, idx_b, mm, hyp)
    Rj, tj, _, inlj, nj = jax.jit(lambda x, y, m, key: jsim3.ransac_sim3(
        x, y, m, key, n_hypotheses=H, inlier_thresh=jlc.scene_scaled_thresh(x, m), with_scale=False))(
        jx, jy, jm, jax.random.PRNGKey(seed))
    assert read.dtype == i32 and read.tolist() == [int(nj)] and int(nj) >= 100
    close(R, Rj, 1e-5)
    close(t, tj, 1e-5)
    close(R, MERGE_R, 1e-4)
    inl = np.asarray(inlj)
    np.testing.assert_array_equal(fuse_src.numpy(), np.where(inl, np.asarray(jka.obs_pt[2]), -1))
    np.testing.assert_array_equal(fuse_dst.numpy(), np.where(inl, np.asarray(jidx), -1))


# ---------------------------------------------------------------------------
# Every new stage: traced in fake mode, and replayed on stand-in graphs
# ---------------------------------------------------------------------------


def _stage_args(seed: int) -> dict:
    """(stage function, arguments) of every new stage, from seeded inputs."""
    f1, f2, _ = _two_views(seed, *MOTION)
    i32 = torch.int32
    idx, ok, probs = tstep.mono_init_match(TCFG, f1, f2)
    hyp_f, hyp_h = (twoview_draw(seed, probs, (256, k)) for k in (8, 4))
    R, t, _, _ = tstep.mono_init(TC, f1, f2, idx, ok, hyp_f, hyp_h)
    ks, pints, ext, _, _ = _imu_case(10 + seed % 2, 16, seed)
    ps = tstep.st.PointStore.empty(TCFG.map.max_points)
    ls = tstep.st.LineStore.empty(TCFG.map.max_lines)
    (jpa, jla, jka), (jpb, jlb, jkb) = _merge_maps(seed)
    (pa, la, ka), (pb, lb, kb) = _port(jpa, jla, jka), _port(jpb, jlb, jkb)
    voc_pt, voc_ln = convert.vocabulary(jvocab.Vocabulary(seed=17)), convert.vocabulary(jvocab.Vocabulary(seed=23))
    db_b = tstep.rebuild_bow(voc_pt, voc_ln, kb, pb, lb)
    two, four = torch.tensor(2, dtype=i32), torch.tensor(4, dtype=i32)
    xa, xb, idx_b, mm, mprobs = tlc.merge_match(ka, pa, two, kb, pb, four)
    n = torch.tensor(10 + seed % 2, dtype=i32)
    g, b = torch.tensor([0.2, 0.1, -9.8]), torch.zeros(3)
    kR = torch.eye(3).expand(6, 3, 3).contiguous()
    return {
        "mono_init_match": (partial(tstep.mono_init_match, TCFG), (f1, f2)),
        "mono_init": (partial(tstep.mono_init, TC), (f1, f2, idx, ok, hyp_f, hyp_h)),
        "track_init": (partial(tstep.track_step, TC, TCFG), (f2, R, t, ps, ls, torch.tensor(False))),
        "mono_depths": (partial(tstep.mono_depths, TC, TCFG),
                        (f2, R, t, f1.feats.uv, f1.feats.desc, f1.feats.valid, torch.tensor(seed % 6, dtype=i32), kR,
                         torch.zeros(6, 3))),
        "imu_init": (partial(tstep.imu_init, TCFG, True), (ks, pints, ext, n, None, b, b, 16, False, False)),
        "imu_init refine": (partial(tstep.imu_init, TCFG, True), (ks, pints, ext, n, g, b, b, 16, False, True)),
        "merge_query": (partial(tstep.merge_query, voc_pt, voc_ln), (ka, pa, la, two, (db_b,))),
        "merge_match": (tlc.merge_match, (ka, pa, two, kb, pb, four)),
        "merge_verify": (tlc.merge_verify, (ka, two, xa, xb, idx_b, mm, pnp_draw(seed, mprobs, (64, 3)))),
        "rebuild_bow": (partial(tstep.rebuild_bow, voc_pt, voc_ln), (kb, pb, lb)),
    }


@pytest.fixture(scope="module")
def stage_args():
    return _stage_args(2), _stage_args(3)


STAGES = ("mono_init_match", "mono_init", "track_init", "mono_depths", "imu_init", "imu_init refine", "merge_query",
          "merge_match", "merge_verify", "rebuild_bow")


@pytest.mark.parametrize("name", STAGES)
def test_stage_traces_in_fake_mode(stage_args, name, monkeypatch):
    """The MAP problem's 15 iterations and tracking's Gauss-Newton rounds
    repeat one body: traced with two and one of them, to keep the time."""
    fn, args = stage_args[0][name]
    if name.startswith("imu_init"):
        monkeypatch.setattr(tstep.imu_init_mod, "inertial_optimization",
                            partial(tstep.imu_init_mod.inertial_optimization, iters=2))
    if name == "track_init":
        cfg = dataclasses.replace(TCFG, opt=dataclasses.replace(TCFG.opt, pose_rounds=2, pose_gn_iters=1,
                                                                pose_gn_iters_refine=0))
        fn = partial(tstep.track_step, TC, cfg)
    _fake_trace(fn, args)


@pytest.mark.parametrize("name", STAGES)
def test_stage_replays_on_stand_in_graphs(stage_args, name):
    """Captured (stand-in) on the first arguments, replayed on the second:
    bit for bit the eager stage on the second."""
    (fn, args_a), (_, args_b) = stage_args[0][name], stage_args[1][name]
    prog = graphs.StageProgram(fn, "cpu", True, name, capture=stand_in_capture)
    prog(*args_a)
    got = prog(*args_b)
    want = fn(*args_b)
    assert prog.captures == 1 and prog.replays == 2
    for i, (a, b) in enumerate(zip(graphs.tree_leaves(got), graphs.tree_leaves(want), strict=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{name} output {i}: {m}")
