"""Monocular two-view reconstruction of the port against the reference:
solve.twoview, `triangulate_midpoint`, the masked `nanmedian`, and the
tracker's `_mono_reconstruct` / `_mono_triangulated_depths` on rendered
128x96 frames.

The RANSAC gets the reference's own draw: its key split in two, the first
half drawing the 8-point F hypotheses and the second the 4-point H ones
(`reference_draw`). Tolerances, repeated in each test:
- Hartley normalization 1e-6; minimal solvers compared up to the sign
  of the eigenvector (`eigh` leaves it free) on well-conditioned samples,
  within 1e-3 of their largest entry (a 9x9 eigen-solve of A^T A in
  float32, LAPACK against XLA; see the test for the ill-conditioned
  ones); transfer errors 1e-3 relative (5e-3 through H^-1);
- reconstruction: the success flag exact; the winning hypothesis's F is
  a float32 eigen-solve of an 8-point sample in both packages, so matches
  at the inlier threshold flip: inlier masks and counts within 2% of the
  matches, the chosen rotation within 2e-3 and the unit translation
  within 1e-2, triangulated and normalized depths within 2% at the
  median and 8% at the 90th percentile, the H/F ratio within 1e-2;
- `nanmedian` exact to float32 rounding (an even count averages the two
  middle values, as `jnp.nanmedian` does);
- triangulated depths within 1e-4 relative, verdicts exact.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pli_slam_tpu.frontend import frame as jframe
from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.solve import triangulate as jtri
from pli_slam_tpu.solve import twoview as jtv
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.ops.indexing import nanmedian
from pli_slam_tpu_torch.solve import sim3 as tsim3
from pli_slam_tpu_torch.solve import triangulate as ttri
from pli_slam_tpu_torch.solve import twoview as ttv
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = JCamera.pinhole(**CAM_ARGS), TCamera.pinhole(**CAM_ARGS)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def reference_draw(seed, probs, shape):
    """The reference's own draw for `seed`: `jax.random.choice` under the
    first half of the split key for the F hypotheses ([H, 8]), the second
    half for the H ones ([H, 4]), the unsplit key otherwise (PnP)."""
    key = jax.random.PRNGKey(seed)
    kf, kh = jax.random.split(key)
    key = {8: kf, 4: kh}.get(shape[1], key)
    p = jnp.asarray(probs.detach().cpu().numpy())
    idx = jax.random.choice(key, p.shape[0], shape=shape, replace=True, p=p)
    return torch.tensor(np.asarray(idx), device=probs.device)


def close(t, j, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               atol=atol, rtol=rtol, err_msg=err_msg)


def _unit_sign(m):
    """m / its largest-magnitude entry: removes the free sign and scale."""
    m = np.asarray(m, np.float64).reshape(m.shape[0], -1)
    pick = m[np.arange(m.shape[0]), np.abs(m).argmax(1)]
    return m / pick[:, None]


def _two_view_scene(rng, n=200, outliers=0.2, noise=0.5):
    """Points 2-6 m in front of camera 1, camera 2 moved 0.3 m and turned;
    pixel noise and a share of outlier matches."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 6, n)], -1)
    R = Rotation.from_rotvec([0.02, -0.08, 0.03]).as_matrix()
    t = np.array([0.3, 0.02, -0.05])
    x2 = X @ R.T + t

    def proj(x):
        return np.stack([120.0 * x[:, 0] / x[:, 2] + 64.0, 120.0 * x[:, 1] / x[:, 2] + 48.0], -1)

    uv1 = proj(X) + rng.normal(size=(n, 2)) * noise
    uv2 = proj(x2) + rng.normal(size=(n, 2)) * noise
    bad = rng.random(n) < outliers
    uv2[bad] += rng.uniform(-20, 20, size=(int(bad.sum()), 2))
    mask = rng.random(n) > 0.05
    return uv1.astype(np.float32), uv2.astype(np.float32), mask, R.astype(np.float32), t / np.linalg.norm(t)


def _gap(A):
    """Second-smallest over largest eigenvalue of A^T A in float64: the
    smallest eigenvector of the float32 A^T A is determined to about
    float32 eps over this ratio."""
    w = np.linalg.eigvalsh(np.einsum("hni,hnj->hij", A, A))
    return w[:, 1] / w[:, -1]


def test_normalize_and_minimal_solvers():
    """Hartley normalization within 1e-6. The minimal solvers take the
    smallest eigenvector of A^T A in float32, in both packages; for a sample
    whose second-smallest eigenvalue is within ~1e-5 of the largest that
    vector is float32 noise in both (an O(1) difference, and a finding about
    the reference), so F and H are compared, up to their free sign, on the
    samples with a gap above 1e-4: within 1e-3 of the largest entry. The
    transfer errors of the same models within 1e-3 relative."""
    rng = np.random.default_rng(3)
    uv1, uv2, mask, _, _ = _two_view_scene(rng)
    n1t, T1t = ttv._normalize(T(uv1), T(mask))
    n1j, T1j = jtv._normalize(jnp.asarray(uv1), jnp.asarray(mask))
    close(n1t, n1j, atol=1e-6)
    close(T1t, T1j, atol=1e-6)
    n2j, _ = jtv._normalize(jnp.asarray(uv2), jnp.asarray(mask))
    n1, n2 = np.asarray(n1j), np.asarray(n2j)
    idx8 = rng.integers(0, len(uv1), size=(64, 8))
    idx4 = rng.integers(0, len(uv1), size=(64, 4))
    x1, x2 = n1[idx8].astype(np.float64), n2[idx8].astype(np.float64)
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    gap_f = _gap(np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, np.ones_like(u1)], -1)) > 1e-4
    F_t = ttv._eight_point_F(T(n1[idx8]), T(n2[idx8])).numpy()
    F_j = np.asarray(jax.vmap(jtv._eight_point_F)(jnp.asarray(n1[idx8]), jnp.asarray(n2[idx8])))
    assert gap_f.sum() >= 8, gap_f.sum()
    np.testing.assert_allclose(_unit_sign(F_t)[gap_f], _unit_sign(F_j)[gap_f], atol=1e-3)
    y1, y2 = n1[idx4].astype(np.float64), n2[idx4].astype(np.float64)
    u, v, x, y = y1[..., 0], y1[..., 1], y2[..., 0], y2[..., 1]
    one, zero = np.ones_like(u), np.zeros_like(u)
    A_h = np.stack([np.stack([-u, -v, -one, zero, zero, zero, x * u, x * v, x], -1),
                    np.stack([zero, zero, zero, -u, -v, -one, y * u, y * v, y], -1)], 2).reshape(64, 8, 9)
    gap_h = _gap(A_h) > 1e-4
    H_t = ttv._four_point_H(T(n1[idx4]), T(n2[idx4])).numpy()
    H_j = np.asarray(jax.vmap(jtv._four_point_H)(jnp.asarray(n1[idx4]), jnp.asarray(n2[idx4])))
    assert gap_h.sum() >= 8, gap_h.sum()
    np.testing.assert_allclose(_unit_sign(H_t)[gap_h], _unit_sign(H_j)[gap_h], atol=1e-3)
    # transfer errors of the same models (the reference's)
    eF_t = ttv._sym_transfer_err_F(T(F_j), T(uv1), T(uv2)).numpy()
    eF_j = np.asarray(jax.vmap(lambda F: jtv._sym_transfer_err_F(F, jnp.asarray(uv1), jnp.asarray(uv2)))(F_j))
    np.testing.assert_allclose(eF_t, eF_j, rtol=1e-3, atol=1e-3)
    eH_t = ttv._sym_transfer_err_H(T(H_j), T(uv1), T(uv2)).numpy()
    eH_j = np.asarray(jax.vmap(lambda H: jtv._sym_transfer_err_H(H, jnp.asarray(uv1), jnp.asarray(uv2)))(H_j))
    # H^-1 of a near-singular homography amplifies float32 rounding: 5e-3
    np.testing.assert_allclose(eH_t, eH_j, rtol=5e-3, atol=1e-3)


def _assert_same_reconstruction(out_t, out_j, mask, label=""):
    """The winner's F is itself a float32 eigen-solve of its 8-point sample
    (see test_normalize_and_minimal_solvers), so its epipolar errors differ
    between the packages by up to ~2 px^2 and matches within that of the
    3.84 px^2 threshold flip: the inlier masks may differ in 2% of the
    matches, and the chosen (R, t) by what that moves (R 2e-3, the unit t
    1e-2; measured 5.6e-4 and 2.6e-3 on the general scene)."""
    inl_t, inl_j = out_t["inliers"].numpy(), np.asarray(out_j["inliers"])
    assert (inl_t != inl_j).sum() <= max(2, 0.02 * mask.sum()), label
    assert abs(int(out_t["n_inliers"]) - int(out_j["n_inliers"])) <= max(2, 0.02 * mask.sum()), label
    close(out_t["R"], out_j["R"], atol=2e-3, err_msg=label)
    close(out_t["t"], out_j["t"], atol=1e-2, err_msg=label)


def _assert_depths_close(z_t, z_j):
    """Depths triangulated from slightly different (R, t): a ray pair with
    little parallax moves far, so the bound is on the distribution: median
    relative difference under 2%, 90th percentile under 8% (measured 1.1%
    and 3.2% on the general scene)."""
    rel = np.abs(z_t - z_j) / np.abs(z_j)
    assert np.median(rel) < 2e-2 and np.percentile(rel, 90) < 8e-2, (np.median(rel), np.percentile(rel, 90))


@pytest.mark.parametrize("case", ["general", "few_matches", "no_parallax"])
def test_reconstruct_two_views_parity(case):
    """With the reference's draw: the success flag exact, the H/F ratio
    within 1e-2 (H's own float32 eigen-solves); on the general scene the
    inliers and (R, t) as `_assert_same_reconstruction` allows, the depths
    of the common inliers as `_assert_depths_close` allows, and the
    translation within 30 degrees of the truth. `few_matches` has 25 correspondences (below the
    30-inlier floor: the counts are exact); `no_parallax` turns the camera
    in place, where F, and so the inliers, are undetermined: only the
    verdict is compared."""
    rng = np.random.default_rng(5)
    uv1, uv2, mask, R_true, t_true = _two_view_scene(rng)
    if case == "few_matches":
        mask = mask & (np.arange(len(mask)) < 25)
    elif case == "no_parallax":
        X = np.stack([rng.uniform(-2, 2, 200), rng.uniform(-1.5, 1.5, 200), rng.uniform(2, 6, 200)], -1)
        x2 = X @ Rotation.from_rotvec([0.0, 0.05, 0.0]).as_matrix().T
        uv1, uv2 = ((np.stack([120 * x[:, 0] / x[:, 2] + 64, 120 * x[:, 1] / x[:, 2] + 48], -1)
                     + rng.normal(size=(200, 2)) * 0.5).astype(np.float32) for x in (X, x2))
    seed = 11
    idx_f, idx_h = ttv.draw_hypotheses(reference_draw, seed, T(mask))
    out_t = ttv.reconstruct_two_views(TC, T(uv1), T(uv2), T(mask), idx_f, idx_h)
    out_j = jtv.reconstruct_two_views(JC, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(mask),
                                      jax.random.PRNGKey(seed))
    assert bool(out_t["success"]) == bool(out_j["success"]) == (case == "general")
    close(out_t["h_ratio"], out_j["h_ratio"], atol=1e-2)
    if case == "few_matches":
        assert int(out_t["n_inliers"]) == int(out_j["n_inliers"]) <= 25
    if case != "general":
        return
    _assert_same_reconstruction(out_t, out_j, mask, case)
    both = out_t["inliers"].numpy() & np.asarray(out_j["inliers"])
    _assert_depths_close(out_t["points"].numpy()[both, 2], np.asarray(out_j["points"])[both, 2])
    # neither package lands near the truth here (rotation ~0.04, translation direction ~0.27 off): the
    # motion comes from one unrefined 8-point sample under 0.5 px of noise at fx = 120, in both
    assert np.degrees(np.arccos(np.clip(out_t["t"].numpy() @ t_true, -1, 1))) < 30.0


def test_port_draw_is_seeded_and_masked():
    """The port's own draw: the same seed gives the same hypotheses, drawn
    only from masked correspondences; F and H come from the same seed."""
    mask = T(np.random.default_rng(2).random(300) > 0.6)
    a = ttv.draw_hypotheses(tsim3.sample_indices, 4, mask)
    b = ttv.draw_hypotheses(tsim3.sample_indices, 4, mask)
    assert a[0].shape == (256, 8) and a[1].shape == (256, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert bool(mask[a[0]].all()) and bool(mask[a[1]].all())


def test_triangulate_midpoint_parity():
    rng = np.random.default_rng(8)
    R1 = Rotation.from_rotvec([0.05, -0.1, 0.02]).as_matrix().astype(np.float32)
    t1 = np.array([0.1, -0.2, 0.05], np.float32)
    R2 = Rotation.from_rotvec([-0.03, 0.12, 0.0]).as_matrix().astype(np.float32)
    t2 = np.array([-0.3, 0.1, 0.2], np.float32)
    ray1 = np.concatenate([rng.uniform(-0.5, 0.5, (64, 2)), np.ones((64, 1))], 1).astype(np.float32)
    ray2 = np.concatenate([rng.uniform(-0.5, 0.5, (64, 2)), np.ones((64, 1))], 1).astype(np.float32)
    ray2[0] = ray1[0]  # a parallel pair
    out_t = ttri.triangulate_midpoint(T(R1), T(t1), T(R1), T(t1), T(ray1), T(ray1))
    out_j = jtri.triangulate_midpoint(*(jnp.asarray(a) for a in (R1, t1, R1, t1, ray1, ray1)))
    close(out_t[0], out_j[0], atol=1e-5)
    out_t = ttri.triangulate_midpoint(T(R1), T(t1), T(R2), T(t2), T(ray1), T(ray2))
    out_j = jtri.triangulate_midpoint(*(jnp.asarray(a) for a in (R1, t1, R2, t2, ray1, ray2)))
    close(out_t[0], out_j[0], atol=1e-4, rtol=1e-4)
    close(out_t[1], out_j[1], atol=1e-6)


@pytest.mark.parametrize("n_on", [40, 17, 16, 2, 1, 0])
def test_nanmedian_even_count(n_on):
    """`jnp.nanmedian` averages the two middle values of an even count;
    `torch.nanmedian` would return the lower one."""
    rng = np.random.default_rng(n_on)
    z = rng.uniform(0.5, 6.0, 40).astype(np.float32)
    mask = np.zeros(40, bool)
    mask[rng.permutation(40)[:n_on]] = True
    got = nanmedian(T(z), T(mask))
    want = jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(z), jnp.nan))
    if n_on == 0:
        assert bool(torch.isnan(got)) and bool(jnp.isnan(want))
    else:
        close(got, want, atol=0.0, rtol=1e-7)
    if n_on == 16:
        assert float(got) != float(torch.nanmedian(T(z)[T(mask)]))  # the lower middle value differs


@pytest.fixture(scope="module")
def mono_frames():
    """The reference's mono frames 0, 3, 6 and 9 of the tiny scene (every
    3rd frame, as in tests/test_mono_rgbd.py), and the port's copies."""
    cfg = SlamConfig.tiny_test().replace(sensor="mono")
    seq = list(jsyn.make_sequence(JC, 10, fps=cfg.fps, traj=jsyn.Trajectory(**TRAJ), room_half=2.55))
    build = jax.jit(partial(jframe.build_frame_mono, JC, cfg))
    jf = [build(np.array(seq[k]["img_l"])) for k in (0, 3, 6, 9)]
    tf = [convert.frame_data(jax.tree_util.tree_map(np.asarray, f)) for f in jf]
    return cfg, jf, tf


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (1, 3)])
def test_mono_reconstruct_parity(mono_frames, pair):
    """`_mono_reconstruct` on the reference's frames with its draw: success
    exact, inliers and (R, t) as `_assert_same_reconstruction` allows (t
    divided by the median depth, which moves with the depths: 3e-2 of its
    norm), the normalized depths of
    the features both packages triangulate as `_assert_depths_close`
    allows, and their median 1 (the mean of the two middle ones for an
    even count)."""
    cfg, jf, tf = mono_frames
    a, b = pair
    seed = 2 + a + b
    tcfg = convert.config_from_reference(dataclasses.asdict(cfg))
    out_t = tstep._mono_reconstruct(TC, tcfg, tf[a], tf[b], reference_draw, seed)
    out_j = jtr._mono_reconstruct(JC, cfg, jf[a], jf[b], jax.random.PRNGKey(seed))
    assert bool(out_t[0]) == bool(out_j[0])
    d_t, d_j = out_t[3].numpy(), np.asarray(out_j[3])
    n = int((np.asarray(jf[a].feats.valid)).sum())
    assert abs(int(out_t[4]) - int(out_j[4])) <= max(2, 0.02 * n) and int(out_j[4]) > 30
    close(out_t[1], out_j[1], atol=2e-3)
    close(out_t[2], out_j[2], atol=3e-2 * float(np.linalg.norm(np.asarray(out_j[2]))))
    both = (d_t > 0) & (d_j > 0)
    assert ((d_t > 0) != (d_j > 0)).sum() <= max(2, 0.02 * n)
    _assert_depths_close(d_t[both], d_j[both])
    for d in (d_t, d_j):
        assert abs(float(np.median(d[d > 0])) - 1.0) < 1e-5


def test_mono_triangulated_depths_parity(mono_frames):
    """Frame 6 triangulated against frame 0's view with the poses the
    reference's own reconstruction gives them: depths within 1e-4 relative,
    the same features triangulated."""
    cfg, jf, tf = mono_frames
    tcfg = convert.config_from_reference(dataclasses.asdict(cfg))
    ok, R, t, _, _ = jtr._mono_reconstruct(JC, cfg, jf[0], jf[2], jax.random.PRNGKey(4))
    assert bool(ok)
    eye, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    kv = jf[0].feats
    out_j = jtr._mono_triangulated_depths(JC, cfg, jf[2], R, t, kv.uv, kv.desc, kv.valid, jnp.asarray(eye),
                                          jnp.asarray(z3))
    out_t = tstep._mono_triangulated_depths(TC, tcfg, tf[2], T(np.asarray(R)), T(np.asarray(t)), tf[0].feats.uv,
                                            tf[0].feats.desc, tf[0].feats.valid, T(eye), T(z3))
    d_t, d_j = out_t.numpy(), np.asarray(out_j)
    np.testing.assert_array_equal(d_t > 0, d_j > 0)
    assert (d_j > 0).sum() > 30
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-6)
