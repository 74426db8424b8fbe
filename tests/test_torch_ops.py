"""Parity of the port's ops/ modules with the JAX package on the CPU.

Inputs come from numpy (seeded) or from the JAX renderer, and the same
arrays go through both packages. Tolerances, where not exact:
- 1e-5 relative for geometry with transcendentals (sin/cos/atan2/exp,
  sqrt): XLA's and torch's float32 implementations differ in the last
  one or two ulps;
- exact for integer outputs, masks, keypoints and ORB descriptors.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import fast as jfast
from pli_slam_tpu.ops import image as jimage
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.ops import lines as jlines
from pli_slam_tpu.ops import matching as jmatching
from pli_slam_tpu.ops import orb as jorb
from pli_slam_tpu.ops import robust as jrobust
from pli_slam_tpu.ops import stereo as jstereo
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.ops import fast as tfast
from pli_slam_tpu_torch.ops import image as timage
from pli_slam_tpu_torch.ops import indexing
from pli_slam_tpu_torch.ops import lie as tlie
from pli_slam_tpu_torch.ops import lines as tlines
from pli_slam_tpu_torch.ops import matching as tmatching
from pli_slam_tpu_torch.ops import orb as torb
from pli_slam_tpu_torch.ops import robust as trobust
from pli_slam_tpu_torch.ops import stereo as tstereo
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
T = torch.as_tensor
RTOL = 1e-5


def close(t, j, rtol=RTOL, atol=1e-5):
    np.testing.assert_allclose(t.numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def stereo_pair():
    cfg = SlamConfig.tiny_test()
    cam = jcam.Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    traj = jsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    fr = next(jsyn.make_sequence(cam, 1, traj=traj, room_half=2.55))
    return (cfg, convert.config_from_reference(dataclasses.asdict(cfg))), np.array(fr["img_l"]), np.array(fr["img_r"])


# ---------------------------------------------------------------------------
# lie / camera / robust
# ---------------------------------------------------------------------------


def test_lie_parity():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:8] *= 1e-4  # Taylor branch
    w[8:16] = w[8:16] / np.linalg.norm(w[8:16], axis=1, keepdims=True) * np.float32(np.pi - 1e-4)  # near pi
    xi = rng.normal(size=(64, 6)).astype(np.float32) * 0.5
    close(tlie.so3_exp(T(w)), jlie.so3_exp(w))
    Rj = np.asarray(jlie.so3_exp(w))
    close(tlie.so3_log(T(Rj)), jlie.so3_log(Rj), rtol=1e-4, atol=1e-4)
    Rt, tt = tlie.se3_exp(T(xi))
    Rjj, tjj = jlie.se3_exp(xi)
    close(Rt, Rjj)
    close(tt, tjj)
    close(tlie.se3_log(T(np.asarray(Rjj)), T(np.asarray(tjj))), jlie.se3_log(Rjj, tjj), rtol=1e-4, atol=1e-4)
    noisy = np.asarray(Rjj) + rng.normal(size=(64, 3, 3)).astype(np.float32) * 1e-3
    close(tlie.normalize_rotation(T(noisy)), jlie.normalize_rotation(noisy), atol=1e-5)


@pytest.mark.parametrize("model", ["pinhole", "kb8"])
def test_camera_parity(model):
    rng = np.random.default_rng(1)
    args = dict(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2)
    if model == "pinhole":
        jc = jcam.Camera.pinhole(**args)
        tc = tcam.Camera.pinhole(**args)
    else:
        k = (0.01, -0.005, 0.001, -0.0002)
        jc = jcam.Camera.kannala_brandt8(k=k, **args)
        tc = tcam.Camera.kannala_brandt8(k=k, **args)
    assert convert.camera(jax.tree_util.tree_map(np.asarray, jc)) == tc
    xyz = np.concatenate([rng.normal(size=(128, 2)), rng.uniform(0.5, 8.0, size=(128, 1))], 1).astype(np.float32)
    uv = np.asarray(jcam.project(jc, xyz))
    close(tcam.project(tc, T(xyz)), uv, atol=1e-3)
    close(tcam.unproject(tc, T(uv)), jcam.unproject(jc, uv), atol=1e-5)
    close(tcam.project_jacobian(tc, T(xyz)), jcam.project_jacobian(jc, xyz), rtol=1e-4, atol=1e-3)
    close(tcam.stereo_project(tc, T(xyz)), jcam.stereo_project(jc, xyz), atol=1e-3)
    np.testing.assert_array_equal(tcam.in_image(tc, T(uv), margin=-15.0).numpy(),
                                  np.asarray(jcam.in_image(jc, uv, margin=-15.0)))
    disp = rng.uniform(0.5, 40.0, size=128).astype(np.float32)
    close(tcam.back_project_stereo(tc, T(uv), T(disp)), jcam.back_project_stereo(jc, uv, disp), atol=1e-4)


def test_robust_parity():
    rng = np.random.default_rng(2)
    x = rng.normal(size=301).astype(np.float32)
    m = rng.random(301) > 0.3
    r2 = np.abs(x) * 10
    close(trobust.cauchy_weight(T(r2), 5.991), jrobust.cauchy_weight(r2, 5.991), rtol=0, atol=0)
    close(trobust.huber_weight(T(r2), 7.8), jrobust.huber_weight(r2, 7.8))
    close(trobust.masked_median(T(x), T(m)), jrobust.masked_median(x, m), rtol=0, atol=0)
    close(trobust.masked_median(T(x), T(np.zeros_like(m))), jrobust.masked_median(x, np.zeros_like(m)), rtol=0, atol=0)
    np.testing.assert_array_equal(trobust.mad_inlier_mask(T(x), T(m), 2.0).numpy(),
                                  np.asarray(jrobust.mad_inlier_mask(x, m, 2.0)))


# ---------------------------------------------------------------------------
# image / fast / orb
# ---------------------------------------------------------------------------


def test_image_parity(stereo_pair):
    _, img, _ = stereo_pair
    close(timage.gaussian_blur(T(img)), jimage.gaussian_blur(img), rtol=1e-6, atol=1e-4)
    for a, b in zip(timage.build_pyramid(T(img), 3, 1.2), jimage.build_pyramid(img, 3, 1.2)):
        close(a, b, rtol=1e-6, atol=1e-4)
    for a, b in zip(timage.sobel_gradients(T(img)), jimage.sobel_gradients(img)):
        close(a, b, rtol=0, atol=0)


def test_fast_parity(stereo_pair):
    _, img, _ = stereo_pair
    img = np.round(img)  # integer pixels: every score is an exact float sum
    s_t, k_t = tfast.detect(T(img), 20, 7)
    s_j, k_j = jfast.detect(img, 20, 7)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_orb_parity(stereo_pair):
    """Keypoints and descriptors exactly equal to the jitted reference.
    Equal FAST scores at the per-level top-K cut are counted: the port
    breaks them by the lower candidate index like jax.lax.top_k, so
    keypoints agree even when ties sit at the cut."""
    (cfg, tcfg), img, _ = stereo_pair
    jf = jax.tree_util.tree_map(np.asarray, jax.jit(partial(jorb.extract, cfg=cfg.orb))(img))
    tf = convert.to_numpy(torb.extract(T(img), tcfg.orb))
    for k in ("uv", "octave", "scale", "desc", "valid"):
        np.testing.assert_array_equal(tf[k], getattr(jf, k), err_msg=k)
    close(tf["response"], jf.response, rtol=1e-4, atol=1e-3)  # fused pyramid arithmetic
    close(tf["angle"], jf.angle, rtol=1e-4, atol=1e-4)
    # ties are counted, not hidden: slots whose score equals another slot's
    # (mostly zero-score candidates filling levels with few corners), every
    # one of which the port placed at the same pixel by the lower-index rule
    _, counts = np.unique(jf.response, return_counts=True)
    n_tied = int(counts[counts > 1].sum())
    assert n_tied > 0, "the case no longer exercises ties"
    print(f"ORB: {jf.valid.sum()} keypoints, {n_tied} slots with an equal score elsewhere")


# ---------------------------------------------------------------------------
# matching / stereo
# ---------------------------------------------------------------------------


def test_matching_parity():
    rng = np.random.default_rng(3)
    d1 = rng.choice(np.array([-1, 1], np.int8), size=(50, 256))
    d2 = np.concatenate([d1[:30] * np.where(rng.random((30, 256)) < 0.05, -1, 1).astype(np.int8),
                         rng.choice(np.array([-1, 1], np.int8), size=(40, 256))])
    v1, v2 = rng.random(50) > 0.1, rng.random(70) > 0.1
    uv1 = rng.uniform(0, 100, (50, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 100, (70, 2)).astype(np.float32)
    dist_t = tmatching.hamming_matrix(T(d1), T(d2))
    dist_j = jmatching.hamming_matrix(d1, d2)
    close(dist_t, dist_j, rtol=0, atol=0)
    gate_t = tmatching.window_gate(T(uv1), T(uv2), 30.0)
    gate_j = jmatching.window_gate(uv1, uv2, 30.0)
    np.testing.assert_array_equal(gate_t.numpy(), np.asarray(gate_j))
    for ratio in (1.0, 0.8):
        it, bt, ot = tmatching.match_nn(dist_t, T(v1), T(v2), gate_t, max_dist=80.0, ratio=ratio)
        ij, bj, oj = jmatching.match_nn(dist_j, v1, v2, gate_j, max_dist=80.0, ratio=ratio)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(
            tmatching.mutual_consistency(it, ot, dist_t, T(v1), T(v2), gate_t).numpy(),
            np.asarray(jmatching.mutual_consistency(ij, oj, dist_j, v1, v2, gate_j)))
        # -1 indices (as the kernel returns) reach dedup like in the tracker
        idx_neg = np.where(np.asarray(oj), np.asarray(ij), -1).astype(np.int32)
        np.testing.assert_array_equal(
            tmatching.dedup_matches(T(idx_neg), bt, ot, 70).numpy(),
            np.asarray(jmatching.dedup_matches(idx_neg, bj, oj, 70)))


def test_stereo_parity(stereo_pair):
    (cfg, _), il, ir = stereo_pair
    ext = jax.jit(partial(jorb.extract, cfg=cfg.orb))
    fl = jax.tree_util.tree_map(np.asarray, ext(il))
    fr = jax.tree_util.tree_map(np.asarray, ext(ir))
    ur_j, ok_j = jax.jit(partial(jstereo.match_stereo, max_disparity=192.0))(fl, fr, il, ir)
    ur_t, ok_t = tstereo.match_stereo(convert.features(fl), convert.features(fr), T(il), T(ir), 192.0)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    m = np.asarray(ok_j)
    assert m.sum() > 20
    close(ur_t.numpy()[m], np.asarray(ur_j)[m], rtol=0, atol=1e-4)  # SAD means: summation order


# ---------------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------------


def test_line_stages_parity(stereo_pair):
    (cfg, tcfg), img, _ = stereo_pair
    lc = cfg.lines
    je = jlines._edge_map(img, lc.grad_threshold)
    te = tlines._edge_map(T(img), lc.grad_threshold)
    np.testing.assert_array_equal(te[0].numpy(), np.asarray(je[0]))
    h, w = img.shape
    ja, _, _ = jlines._hough_vote(*je, lc, h, w)
    ta, _, _ = tlines._hough_vote(*te, tcfg.lines, h, w)
    close(ta, ja, rtol=1e-5, atol=1e-3)  # |grad| via sqrt differs by an ulp on a few pixels
    jp = jlines._hough_peaks(ja, lc.n_candidates)
    tp = tlines._hough_peaks(T(np.asarray(ja)), lc.n_candidates)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(4)
    sup = rng.random((64, 50)) < 0.6
    for gap in (3, 4):  # even and odd windows (asymmetric SAME padding)
        np.testing.assert_array_equal(tlines._close_gaps(T(sup), gap).numpy(), np.asarray(jlines._close_gaps(sup, gap)))
    for a, b in zip(tlines._longest_run(T(sup)), jlines._longest_run(sup)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_line_detect_and_stereo_parity(stereo_pair):
    """Against the jitted reference. XLA's fused arithmetic moves a few
    near-equal segment scores, and the reference's own eager and jitted
    runs disagree on the order (and at the top-N cut) of some segments,
    so segments are compared as sets: at least 90% of the reference's
    segments must appear in the port's output within 1e-3 px with the
    same LBD descriptor bits (<= 2% of bits may flip: a projection within
    float rounding of 0)."""
    (cfg, tcfg), il, ir = stereo_pair
    jl = jax.tree_util.tree_map(np.asarray, jax.jit(partial(jlines.detect, cfg=cfg.lines))(il))
    tl = convert.to_numpy(tlines.detect(T(il), tcfg.lines))
    assert tl["valid"].sum() == jl.valid.sum()
    a = np.concatenate([jl.p0, jl.p1], 1)[jl.valid]
    b = np.concatenate([tl["p0"], tl["p1"]], 1)[tl["valid"]]
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    near = d.argmin(1)
    hit = d.min(1) < 1e-3
    assert hit.mean() >= 0.9, hit.mean()
    flips = (jl.desc[jl.valid][hit] != tl["desc"][tl["valid"]][near[hit]]).mean()
    assert flips <= 0.02, flips

    # descriptor and stereo association on identical segments
    lbd_t = tlines.lbd_descriptor(T(il), T(jl.p0), T(jl.p1), T(jl.valid), tcfg.lines)
    assert (lbd_t.numpy() != jl.desc).mean() <= 0.02
    jr = jax.tree_util.tree_map(np.asarray, jax.jit(partial(jlines.detect, cfg=cfg.lines, with_desc=False))(ir))
    jout = jax.jit(jlines.match_stereo_lines_geom)(jl, jr, il, ir)
    tout = tlines.match_stereo_lines_geom(convert.line_features(jl), convert.line_features(jr), T(il), T(ir))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    m = np.asarray(jout[3])
    np.testing.assert_array_equal(tout[2].numpy()[m], np.asarray(jout[2])[m])
    close(tout[0].numpy()[m], np.asarray(jout[0])[m], atol=1e-3)
    close(tout[1].numpy()[m], np.asarray(jout[1])[m], atol=1e-3)


# ---------------------------------------------------------------------------
# JAX indexing semantics the port writes out
# ---------------------------------------------------------------------------


def test_indexing_semantics():
    x = np.array([1.0, 3.0, 3.0, 0.0, 3.0, 2.0, 2.0], np.float32)
    for k in (2, 3, 5):
        jv, ji = jax.lax.top_k(x, k)
        tv, ti = indexing.top_k(T(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    ids = np.array([5, 3, 9, 3, 1, 9, 9, 7], np.int32)
    for size in (2, 4, 8):
        np.testing.assert_array_equal(indexing.unique_fixed(T(ids), size, 9).numpy(),
                                      np.asarray(jnp.unique(ids, size=size, fill_value=9)))
    idx = np.array([0, 2, 0, 1, 0], np.int32)
    src = np.arange(5, dtype=np.float32) + 10
    dst = np.zeros(4, np.float32)
    jout = jax.jit(lambda d, i, s: d.at[i].set(s))(dst, idx, src)  # XLA CPU: last write wins
    np.testing.assert_array_equal(indexing.scatter_set(T(dst), T(idx), T(src)).numpy(), np.asarray(jout))
