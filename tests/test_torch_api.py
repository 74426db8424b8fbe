"""The rest of the reference's API in the port, and the reference's
behavioural tests of the front end run on the port.

Part 1 holds each function and member against the JAX package on seeded
numpy inputs: integers, masks and index outputs exact; 1e-5 relative where
transcendentals or divisions enter (as test_torch_ops.py); Jacobians 1e-4
(as test_torch_solve.py).
Part 2 is test_frontend_points.py (17 cases) and test_stereo_lines.py (8)
with the port's modules in place of the reference's, same inputs, same
assertions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import image as jimage
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.ops import lines as jlines
from pli_slam_tpu.ops import matching as jmatching
from pli_slam_tpu.ops import orb as jorb
from pli_slam_tpu.ops import robust as jrobust
from pli_slam_tpu.solve import residuals as jres
from pli_slam_tpu.utils.config import LineConfig as JLineConfig
from pli_slam_tpu.utils.config import OrbConfig as JOrbConfig
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.ops import fast as fast_ops
from pli_slam_tpu_torch.ops import image as image_ops
from pli_slam_tpu_torch.ops import lines as line_ops
from pli_slam_tpu_torch.ops import matching, orb, stereo
from pli_slam_tpu_torch.ops import robust as trobust
from pli_slam_tpu_torch.solve import residuals as tres
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils.config import LineConfig, OrbConfig

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=47.9)
JC, TC = jcam.Camera.pinhole(**CAM_ARGS), tcam.Camera.pinhole(**CAM_ARGS)


def close(t, j, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=rtol, atol=atol)


def exact(t, j):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(a, np.asarray(j))


def _descs(rng, n, flips=8):
    base = rng.choice([-1, 1], size=(n, 256)).astype(np.int8)
    noisy = base.copy()
    for i in range(n):
        noisy[i, rng.choice(256, size=rng.integers(0, flips + 1), replace=False)] *= -1
    return base, noisy[rng.permutation(n)]


# ---------------------------------------------------------------------------
# Part 1: parity with the reference
# ---------------------------------------------------------------------------


def test_row_band_gate_parity():
    rng = np.random.default_rng(0)
    v1, v2 = (rng.uniform(0, 96, n).astype(np.float32) for n in (40, 50))
    exact(matching.row_band_gate(T(v1), T(v2), 2.0), jmatching.row_band_gate(v1, v2, 2.0))


def test_rotation_consistency_parity():
    rng = np.random.default_rng(1)
    n = 200
    a1 = rng.uniform(-np.pi, 3 * np.pi, n).astype(np.float32)  # differences of either sign, past 2 pi
    a2 = (a1 - 0.3 + rng.normal(0, 0.05, n)).astype(np.float32)
    a2[:40] = rng.uniform(0, 2 * np.pi, 40)
    idx2 = rng.permutation(n).astype(np.int32)
    idx2[::17] = -1
    ok = rng.random(n) > 0.2
    for bins, top in ((30, 3), (12, 1)):
        exact(matching.rotation_consistency(T(a1), T(a2), T(idx2), T(ok), bins, top),
              jmatching.rotation_consistency(a1, a2, idx2, ok, bins, top))


@pytest.mark.parametrize("mutual", [True, False])
def test_match_descriptors_parity(mutual):
    rng = np.random.default_rng(2)
    d1, d2 = _descs(rng, 64, flips=40)
    v1, v2 = rng.random(64) > 0.1, rng.random(64) > 0.1
    gate = rng.random((64, 64)) > 0.3
    for g in (None, gate):
        got = matching.match_descriptors(T(d1), T(d2), T(v1), T(v2), None if g is None else T(g), 30.0, 0.9, mutual)
        ref = jmatching.match_descriptors(d1, d2, v1, v2, g, max_dist=30.0, ratio=0.9, mutual=mutual)
        for a, b in zip(got, ref):
            exact(a, b)


def test_match_stereo_lines_parity():
    """The descriptor-based stereo association on the reference's own detections."""
    h, w, disparity = 128, 160, 6
    imgL = np.full((h, w), 40.0, np.float32)
    imgL[20:110, 90:96] = 220.0
    imgL[30:36, 20:140] = 200.0
    imgR = np.roll(imgL, -disparity, axis=1)
    cfg = JLineConfig(n_lines=32, n_candidates=128, n_samples=256, grad_threshold=40.0)
    fl, fr = jlines.detect(jnp.asarray(imgL), cfg), jlines.detect(jnp.asarray(imgR), cfg)
    tl, tr = (convert.line_features(jax.tree_util.tree_map(np.asarray, f)) for f in (fl, fr))
    assert tl.capacity == fl.capacity == 32 and int(tl.count()) == int(fl.count()) > 0
    d0, d1, idx, ok = line_ops.match_stereo_lines(tl, tr, max_disparity=48.0)
    j0, j1, jidx, jok = jlines.match_stereo_lines(fl, fr, max_disparity=48.0)
    exact(idx, jidx)
    exact(ok, jok)
    assert int(ok.sum()) >= 1
    m = ok.numpy()
    close(d0.numpy()[m], np.asarray(j0)[m])
    close(d1.numpy()[m], np.asarray(j1)[m])


def test_feature_counts_parity():
    rng = np.random.default_rng(3)
    img = _textured(rng)
    jf = jorb.extract(jnp.asarray(img), JOrbConfig(n_features=128, n_levels=2))
    tf = convert.features(jax.tree_util.tree_map(np.asarray, jf))
    assert tf.capacity == jf.capacity == 128
    assert int(tf.count()) == int(jf.count()) and tf.count().dtype == torch.int32


def test_pack_unpack_and_brief_pattern_parity():
    rng = np.random.default_rng(4)
    d = rng.choice([-1, 1], size=(16, 256)).astype(np.int8)
    packed = orb.pack_descriptors(T(d))
    ref = np.asarray(jorb.pack_descriptors(d))
    exact(packed.numpy().view(np.uint32), ref)
    exact(orb.unpack_descriptors(packed), jorb.unpack_descriptors(ref))
    exact(orb.unpack_descriptors(T(ref.astype(np.int64))), d)
    for seed in (1234, 7):
        exact(orb.brief_pattern(seed), jorb.brief_pattern(seed))


def test_samplers_parity():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    uv = np.stack([rng.uniform(-5, 70, 300), rng.uniform(-5, 55, 300)], -1).astype(np.float32)
    uv[:20] = np.round(uv[:20]) + 0.5  # halves: round to even in both
    close(image_ops.bilinear_sample(T(img), T(uv)), jimage.bilinear_sample(img, uv), atol=1e-4)
    exact(image_ops.nearest_sample(T(img), T(uv)), jimage.nearest_sample(img, uv))


def test_camera_and_tukey_parity():
    rng = np.random.default_rng(6)
    disp = np.concatenate([rng.uniform(0, 60, 100), [0.0, -1.0, 1e-7]]).astype(np.float32)
    close(tcam.depth_from_disparity(TC, T(disp)), jcam.depth_from_disparity(JC, disp), rtol=1e-6)
    exact(TC.K(), JC.K())
    r2 = rng.uniform(0, 40, 200).astype(np.float32)
    for c in (4.685, 2.0):
        close(trobust.tukey_weight(T(r2), c), jrobust.tukey_weight(r2, c))


def test_residual_blocks_parity():
    rng = np.random.default_rng(7)
    x_w = np.stack([rng.uniform(-3, 3, 50), rng.uniform(-2, 2, 50), rng.uniform(4, 12, 50)], -1).astype(np.float32)
    xe_w = (x_w + rng.normal(size=x_w.shape)).astype(np.float32)
    R, t = (np.array(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.1, jnp.float32)))
    uv = (np.asarray(jcam.project(JC, x_w @ R.T + t)) + rng.normal(size=(50, 2))).astype(np.float32)
    for a, b in zip(tres.point_residuals_mono(TC, T(R), T(t), T(x_w), T(uv)),
                    jres.point_residuals_mono(JC, R, t, x_w, uv)):
        close(a, b, rtol=1e-4, atol=1e-3)
    x_c = (x_w @ R.T + t).astype(np.float32)
    for stereo_ in (True, False):
        close(tres.point_residuals_landmark_jac(TC, T(R), T(x_c), stereo_),
              jres.point_residuals_landmark_jac(JC, R, x_c, stereo_), rtol=1e-4, atol=1e-4)
    l_obs = rng.normal(size=(50, 3)).astype(np.float32)
    l_obs /= np.linalg.norm(l_obs[:, :2], axis=-1, keepdims=True)
    _, _, (_, _, js, je) = jres.line_residuals(JC, R, t, x_w, xe_w, l_obs)
    _, _, (_, _, ts, te) = tres.line_residuals(TC, T(R), T(t), T(x_w), T(xe_w), T(l_obs))
    close(tres.line_residuals_landmark_jac(T(R), ts, te), jres.line_residuals_landmark_jac(R, js, je),
          rtol=1e-4, atol=1e-4)
    R0, t0 = (np.array(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.2, jnp.float32)))
    close(tres.make_pose_prior(T(R0), T(t0), 3.0)(T(R), T(t)), jres.make_pose_prior(R0, t0, 3.0)(R, t),
          rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# Part 2: test_frontend_points.py and test_stereo_lines.py on the port
# ---------------------------------------------------------------------------


def _textured(rng, h=96, w=128, n_blobs=40):
    """Random bright squares on a dark background: corner-rich."""
    img = np.full((h, w), 30.0, np.float32)
    for _ in range(n_blobs):
        y = rng.integers(8, h - 16)
        x = rng.integers(8, w - 16)
        s = rng.integers(4, 12)
        img[y:y + s, x:x + s] = rng.uniform(120, 250)
    return img


def textured_image(rng, h=96, w=128, n_blobs=40):
    return T(_textured(rng, h, w, n_blobs))


class TestImageOps:
    def test_blur_preserves_mean(self, rng):
        img = T(rng.uniform(0, 255, size=(64, 64)).astype(np.float32))
        out = image_ops.gaussian_blur(img)
        np.testing.assert_allclose(float(out.mean()), float(img.mean()), rtol=0.02)
        assert float(out.std()) < float(img.std())

    def test_resize_constant(self):
        out = image_ops.bilinear_resize(torch.full((64, 64), 7.0), 40, 52)
        np.testing.assert_allclose(out.numpy(), 7.0, atol=1e-4)
        assert tuple(out.shape) == (40, 52)

    def test_pyramid_shapes(self):
        shapes = image_ops.pyramid_shapes(480, 752, 8, 1.2)
        assert shapes[0] == (480, 752)
        assert len(shapes) == 8
        assert shapes[1][0] == 400  # 480/1.2

    def test_bilinear_sample_exact_at_pixels(self, rng):
        img = T(rng.uniform(0, 255, size=(32, 32)).astype(np.float32))
        vals = image_ops.bilinear_sample(img, T([[3.0, 5.0], [10.0, 20.0]]))
        np.testing.assert_allclose(vals.numpy(), [float(img[5, 3]), float(img[20, 10])], atol=1e-4)


class TestFast:
    def test_detects_square_corners(self):
        img = np.full((64, 64), 50.0, np.float32)
        img[20:40, 20:40] = 220.0
        score, keep = fast_ops.detect(T(img), 20.0)
        ys, xs = np.nonzero(keep.numpy())
        assert len(ys) >= 4
        corners = np.array([[20, 20], [20, 39], [39, 20], [39, 39]])
        for y, x in zip(ys, xs):
            assert np.abs(corners - [y, x]).sum(axis=1).min() <= 4, (y, x)

    def test_flat_image_no_corners(self):
        _, keep = fast_ops.detect(torch.full((64, 64), 100.0), 20.0)
        assert int(keep.sum()) == 0

    def test_threshold_monotone(self, rng):
        img = textured_image(rng)
        _, k1 = fast_ops.detect(img, 10.0)
        _, k2 = fast_ops.detect(img, 60.0)
        assert int(k2.sum()) <= int(k1.sum())


class TestOrb:
    def test_extract_budget_and_masks(self, rng):
        feats = orb.extract(textured_image(rng, 96, 128), OrbConfig(n_features=256, n_levels=3))
        assert feats.capacity == 256
        assert 30 < int(feats.count()) <= 256
        v = feats.valid.numpy()
        uv = feats.uv.numpy()[v]
        assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 128).all()
        assert (uv[:, 1] >= 0).all() and (uv[:, 1] < 96).all()
        assert (feats.desc.numpy()[~v] == 0).all()

    def test_level_counts_sum(self):
        counts = orb.level_feature_counts(1200, 8, 1.2)
        assert sum(counts) == 1200
        assert counts[0] > counts[-1] > 0

    def test_descriptor_rotation_invariance(self, rng):
        """Rotating the image by 90 deg keeps descriptors similar."""
        cfg = OrbConfig(n_features=64, n_levels=1)
        img = textured_image(rng, 96, 96)
        f1 = orb.extract(img, cfg)
        f2 = orb.extract(torch.rot90(img), cfg)
        idx2, best, ok = matching.match_nn(matching.hamming_matrix(f1.desc, f2.desc), f1.valid, f2.valid,
                                           max_dist=60.0)
        uv1, uv2, okn, idx = f1.uv.numpy(), f2.uv.numpy(), ok.numpy(), idx2.numpy()
        good = 0
        for i in np.nonzero(okn)[0]:
            x, y = uv1[i]
            if np.abs(uv2[idx[i]] - np.array([y, 96 - 1 - x])).max() < 3.0:  # rot90 ccw: (x, y) -> (y, W-1-x)
                good += 1
        assert good >= 0.5 * max(okn.sum(), 1), (good, okn.sum())

    def test_pack_unpack_roundtrip(self, rng):
        d = T(rng.choice([-1, 1], size=(16, 256)).astype(np.int8))
        packed = orb.pack_descriptors(d)
        assert tuple(packed.shape) == (16, 8)
        assert torch.equal(orb.unpack_descriptors(packed), d)


class TestMatching:
    def test_hamming_identity(self, rng):
        d = T(rng.choice([-1, 1], size=(32, 256)).astype(np.int8))
        np.testing.assert_allclose(np.diag(matching.hamming_matrix(d, d).numpy()), 0.0)

    def test_hamming_known_distance(self):
        d1 = torch.ones((1, 256), dtype=torch.int8)
        d2 = torch.ones((1, 256), dtype=torch.int8)
        d2[0, :10] = -1
        np.testing.assert_allclose(matching.hamming_matrix(d1, d2).numpy(), [[10.0]])

    def test_nn_with_noise(self, rng):
        base = rng.choice([-1, 1], size=(64, 256)).astype(np.int8)
        noisy = base.copy()
        for i in range(64):
            noisy[i, rng.choice(256, size=8, replace=False)] *= -1
        perm = rng.permutation(64)
        v = torch.ones(64, dtype=torch.bool)
        idx2, best, ok = matching.match_descriptors(T(base), T(noisy[perm]), v, v, max_dist=20.0)
        inv = np.empty(64, int)
        inv[perm] = np.arange(64)
        np.testing.assert_array_equal(idx2.numpy(), inv)
        assert bool(ok.all())

    def test_gate_blocks_matches(self, rng):
        d = T(rng.choice([-1, 1], size=(8, 256)).astype(np.int8))
        v = torch.ones(8, dtype=torch.bool)
        _, _, ok = matching.match_descriptors(d, d, v, v, gate=torch.zeros((8, 8), dtype=torch.bool))
        assert not bool(ok.any())

    def test_window_gate(self):
        g = matching.window_gate(T([[0.0, 0.0], [100.0, 100.0]]), T([[3.0, 4.0], [100.0, 108.0]]), radius=6.0)
        np.testing.assert_array_equal(g.numpy(), [[True, False], [False, False]])

    def test_rotation_consistency(self, rng):
        n = 100
        a1 = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
        a2 = a1 - np.float32(0.3)  # a consistent rotation for most, random for 10 outliers
        a2[:10] = rng.uniform(0, 2 * np.pi, size=10)
        kept = matching.rotation_consistency(T(a1), T(a2), torch.arange(n, dtype=torch.int32),
                                             torch.ones(n, dtype=torch.bool))
        assert int(kept[10:].sum()) == 90


def stereo_pair(rng, h=96, w=160, disparity=7, n_blobs=30):
    """Right image = left shifted right-to-left by `disparity` px."""
    imgL = np.full((h, w + disparity), 30.0, np.float32)
    for _ in range(n_blobs):
        y = rng.integers(8, h - 16)
        x = rng.integers(8, w + disparity - 16)
        s = rng.integers(4, 12)
        imgL[y:y + s, x:x + s] = rng.uniform(120, 250)
    return T(imgL[:, :-disparity].copy()), T(imgL[:, disparity:].copy())


class TestStereoPoints:
    def test_constant_disparity_recovered(self, rng):
        disparity = 7
        left_img, right_img = stereo_pair(rng, disparity=disparity)
        cfg = OrbConfig(n_features=128, n_levels=2)
        fl, fr = orb.extract(left_img, cfg), orb.extract(right_img, cfg)
        u_r, ok = stereo.match_stereo(fl, fr, left_img, right_img, max_disparity=48.0)
        assert int(ok.sum()) >= 10, int(ok.sum())
        d = (fl.uv[:, 0] - u_r).numpy()[ok.numpy()]
        close_ = (np.abs(d - disparity) < 1.0).mean()  # 80% of accepted disparities within 1 px
        assert close_ >= 0.8, (close_, d[:20])

    def test_depths_sign(self, rng):
        left_img, right_img = stereo_pair(rng)
        cfg = OrbConfig(n_features=64, n_levels=1)
        fl, fr = orb.extract(left_img, cfg), orb.extract(right_img, cfg)
        u_r, ok = stereo.match_stereo(fl, fr, left_img, right_img, max_disparity=48.0)
        d = stereo.depths_from_stereo(fl, u_r, ok, bf=40.0).numpy()
        okn = ok.numpy()
        assert (d[okn] > 0).all()
        assert (d[~okn] == -1.0).all()


def line_image(h=128, w=160):
    """A dark image with two bright bars: strong straight edges."""
    img = np.full((h, w), 40.0, np.float32)
    img[30:36, 20:140] = 220.0
    img[60:120, 80:86] = 220.0
    return T(img)


CFG_L = LineConfig(n_lines=32, n_candidates=128, n_samples=256, grad_threshold=40.0)


class TestLineDetect:
    def test_detects_bar_edges(self):
        feats = line_ops.detect(line_image(), CFG_L)
        assert int(feats.count()) >= 2
        v = feats.valid.numpy()
        ang, length = feats.angle.numpy()[v], feats.length.numpy()[v]
        assert ((np.abs(np.sin(ang)) < 0.1) & (length > 60)).any(), (ang, length)  # a long horizontal
        assert ((np.abs(np.cos(ang)) < 0.1) & (length > 30)).any(), (ang, length)  # and a vertical

    def test_flat_image_no_lines(self):
        assert int(line_ops.detect(torch.full((128, 160), 90.0), CFG_L).count()) == 0

    def test_endpoints_on_edges(self):
        feats = line_ops.detect(line_image(), CFG_L)
        v = feats.valid.numpy()
        k = np.argmax(feats.length.numpy()[v])  # the longest is the horizontal top edge
        xs = sorted([feats.p0.numpy()[v][k][0], feats.p1.numpy()[v][k][0]])
        assert xs[0] < 35 and xs[1] > 125, xs  # it covers the bar [20, 140]

    def test_descriptor_stability_under_shift(self):
        """The same structure 2 px on: nearly identical descriptors."""
        imgA = line_image()
        fA = line_ops.detect(imgA, CFG_L)
        fB = line_ops.detect(torch.roll(imgA, 2, dims=1), CFG_L)
        idx, best, ok = matching.match_nn(matching.hamming_matrix(fA.desc, fB.desc), fA.valid, fB.valid,
                                          max_dist=80.0)
        assert int(ok.sum()) >= 2
        assert float(best[ok].mean()) < 60.0


class TestStereoLines:
    def test_endpoint_disparity(self):
        """A vertical bar shifted horizontally between the stereo images."""
        disparity, h, w = 6, 128, 160
        imgL = np.full((h, w), 40.0, np.float32)
        imgL[20:110, 90:96] = 220.0
        imgR = np.full((h, w), 40.0, np.float32)
        imgR[20:110, 90 - disparity:96 - disparity] = 220.0
        fL, fR = line_ops.detect(T(imgL), CFG_L), line_ops.detect(T(imgR), CFG_L)
        d0, d1, idx_r, ok = line_ops.match_stereo_lines(fL, fR, max_disparity=48.0)
        okn = ok.numpy()
        assert okn.sum() >= 1
        np.testing.assert_allclose(d0.numpy()[okn], disparity, atol=1.5)
        np.testing.assert_allclose(d1.numpy()[okn], disparity, atol=1.5)

    def test_vertical_overlap(self):
        f = line_ops.detect(line_image(), CFG_L)
        diag = np.diag(line_ops.vertical_overlap(f, f).numpy())[f.valid.numpy()]
        np.testing.assert_allclose(diag, 1.0, atol=1e-5)


def test_configs_are_the_references():
    """The behavioural cases above build the port's configs directly; they equal the reference's."""
    assert dataclasses.asdict(CFG_L) == dataclasses.asdict(
        JLineConfig(n_lines=32, n_candidates=128, n_samples=256, grad_threshold=40.0))
    assert dataclasses.asdict(OrbConfig(n_features=64, n_levels=1)) == dataclasses.asdict(
        JOrbConfig(n_features=64, n_levels=1))
