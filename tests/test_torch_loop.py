"""Loop closing in the port against the reference: Sim(3) and quaternions,
Horn and RANSAC, the pose graph, the alternating global BA, loop
verification and correction, and the reference's planted scenarios
(tests/test_loop_closing_e2e.py, tests/test_pgo_4dof_gba.py,
tests/test_failure_guards.py).

Same numpy inputs through both packages. The RANSAC functions take their
drawn hypotheses as an argument in the port; here both packages get the
reference's own draw (`jax.random.choice` with the reference's key), so
whole verifications compare exactly. Tolerances, repeated in each test:
- Sim(3) / quaternion maps: 1e-5;
- Horn, RANSAC: inlier masks and counts exact, R / t / s within 1e-4
  (1e-3 for Horn on three points);
- pose graph (20 Gauss-Newton iterations, a dense [7K, 7K] solve each):
  poses within 1e-4, scale within 1e-5;
- segment sums 1e-5 relative; alternating BA: poses 1e-4, points 3e-3
  relative, the prune verdicts agree on 99.5% of observations (a chi2
  within rounding of the gate may flip);
- decisions (verified, closed, which candidate, projection counts): exact.
"""

import contextlib
import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import loop_closing as jlc
from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.solve import ba as jba
from pli_slam_tpu.solve import pgo as jpgo
from pli_slam_tpu.solve import sim3 as jsim3
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import OptimizerConfig, SlamConfig
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu_torch.frontend import loop_closing as tlc
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.ops import lie as tlie
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.solve import pgo as tpgo
from pli_slam_tpu_torch.solve import sim3 as tsim3
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils.profile import FLAGSHIP_TRAJ, N_FRAMES_LOOP

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = jcam.Camera.pinhole(**CAM_ARGS), tcam.Camera.pinhole(**CAM_ARGS)
# bench.py's camera, for the BA maps: on the 128x96 one a whole-map BA is
# too ill-conditioned in float32 for the delayed-rejection LM to take the
# same accept / reject decisions in two packages
FULL_ARGS = dict(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
JF, TF = jcam.Camera.pinhole(**FULL_ARGS), tcam.Camera.pinhole(**FULL_ARGS)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol)


def reference_draw(seed, probs, shape):
    """The reference's own hypothesis draw: jax.random.choice under PRNGKey(seed)."""
    p = jnp.asarray(probs.detach().cpu().numpy())
    idx = jax.random.choice(jax.random.PRNGKey(seed), p.shape[0], shape=shape, replace=True, p=p)
    return torch.tensor(np.asarray(idx), device=probs.device)


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


def port_stores(ks, ps, ls):
    np_ = partial(jax.tree_util.tree_map, np.asarray)
    return convert.keyframe_store(np_(ks)), convert.point_store(np_(ps)), convert.line_store(np_(ls))


def assert_stores_close(t_stores, j_stores, atol=1e-4):
    """Every field of the three stores: integers and masks exact, floats within `atol`."""
    for ts, js in zip(t_stores, j_stores):
        a, b = convert.to_numpy(ts), convert.to_numpy(jax.tree_util.tree_map(np.asarray, js))
        for k in a:
            if a[k].dtype.kind == "f":
                np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# Sim(3), quaternions, Horn, RANSAC
# ---------------------------------------------------------------------------


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jlie.rotation_from_quat(jnp.asarray(q, jnp.float32)))


def test_sim3_and_quaternion_parity():
    """sim3_exp (generic, small-theta and small-sigma branches), inverse,
    compose, apply; se3_compose / se3_matrix / se3_from_matrix; quaternions
    through every Shepperd case (trace and each diagonal largest).
    Tolerance 1e-5."""
    rng = np.random.default_rng(0)
    xi = rng.normal(size=(24, 7)).astype(np.float32) * 0.7
    xi[:4, 3:6] *= 1e-4  # small theta
    xi[4:8, 6] *= 1e-5  # small sigma
    xi[8:10, 3:] *= 1e-5  # both
    a = tlie.sim3_exp(T(xi))
    b = jlie.sim3_exp(jnp.asarray(xi))
    for u, v in zip(a, b):
        close(u, v, atol=1e-5, rtol=1e-5)
    a2 = tlie.sim3_exp(T(xi[::-1].copy()))
    b2 = jlie.sim3_exp(jnp.asarray(xi[::-1].copy()))
    for u, v in zip(tlie.sim3_compose(*a, *a2), jlie.sim3_compose(*b, *b2)):
        close(u, v, atol=1e-5, rtol=1e-5)
    for u, v in zip(tlie.sim3_inverse(*a), jlie.sim3_inverse(*b)):
        close(u, v, atol=1e-5, rtol=1e-5)
    x = rng.normal(size=(24, 3)).astype(np.float32)
    close(tlie.sim3_apply(*a, T(x)), jlie.sim3_apply(*b, jnp.asarray(x)), atol=1e-5, rtol=1e-5)
    R, t = a[0], a[1]
    for u, v in zip(tlie.se3_compose(R, t, R.flip(0), t.flip(0)),
                    jlie.se3_compose(b[0], b[1], b[0][::-1], b[1][::-1])):
        close(u, v, atol=1e-5, rtol=1e-5)
    M = tlie.se3_matrix(R, t)
    close(M, jlie.se3_matrix(b[0], b[1]), atol=1e-6)
    for u, v in zip(tlie.se3_from_matrix(M), jlie.se3_from_matrix(jlie.se3_matrix(b[0], b[1]))):
        close(u, v, atol=1e-6)

    Rs = list(_rotations(rng, 12))
    for axis in range(3):  # 180-degree turns: the diagonal cases of Shepperd's method
        d = -np.ones(3, np.float32)
        d[axis] = 1.0
        Rs.append(np.diag(d))
    Rs = np.stack(Rs).astype(np.float32)
    qt, qj = tlie.quat_from_rotation(T(Rs)), jlie.quat_from_rotation(jnp.asarray(Rs))
    close(qt, qj, atol=1e-5)
    close(tlie.rotation_from_quat(qt), jlie.rotation_from_quat(qj), atol=1e-5)
    q = rng.normal(size=(8, 4)).astype(np.float32) * 3.0  # unnormalized
    close(tlie.rotation_from_quat(T(q)), jlie.rotation_from_quat(jnp.asarray(q)), atol=1e-5)


def _correspondences(rng, n=120, outliers=0.3, scale=1.0):
    R = _rotations(rng, 1)[0]
    t = rng.normal(size=3).astype(np.float32)
    x = rng.normal(size=(n, 3)).astype(np.float32) * 2.0
    y = scale * x @ R.T + t + rng.normal(size=(n, 3)).astype(np.float32) * 0.005
    bad = rng.random(n) < outliers
    y[bad] += rng.normal(size=(int(bad.sum()), 3)).astype(np.float32) * 2.0
    mask = rng.random(n) > 0.1
    return x, y.astype(np.float32), mask, bad


@pytest.mark.parametrize("with_scale", [True, False])
def test_horn_and_ransac_parity(with_scale):
    """Horn over a batch of weighted inlier triplets (within 1e-3: a 4x4
    eigh of three points, LAPACK against XLA) and over a whole set (1e-4);
    RANSAC with the reference's draw substituted (its key 7 * 11 + 3):
    inliers and counts exact, R / t / s within 1e-4. The port's own draw
    (`sample_indices`) is reproducible and respects the mask."""
    rng = np.random.default_rng(1)
    x, y, mask, bad = _correspondences(rng, scale=1.3 if with_scale else 1.0)
    # hypothesis triplets from the inliers: a triplet with outliers can have
    # nearly equal top eigenvalues, and its rotation is then arbitrary in float32
    idx = rng.choice(np.nonzero(~bad)[0], size=(64, 3))
    w = rng.random((64, 3)).astype(np.float32)
    for u, v in zip(tsim3.horn_alignment(T(x[idx]), T(y[idx]), T(w), with_scale),
                    jsim3.horn_alignment(jnp.asarray(x[idx]), jnp.asarray(y[idx]), jnp.asarray(w), with_scale)):
        close(u, v, atol=1e-3, rtol=1e-3)
    wm = mask.astype(np.float32)
    for u, v in zip(tsim3.horn_alignment(T(x), T(y), T(wm), with_scale),
                    jsim3.horn_alignment(jnp.asarray(x), jnp.asarray(y), jnp.asarray(wm), with_scale)):
        close(u, v, atol=1e-4)

    thresh = 0.05
    key = 7 * 11 + 3
    hyp = reference_draw(key, tsim3.mask_probs(T(mask)), (256, 3))
    out_t = tsim3.ransac_sim3(T(x), T(y), T(mask), hyp, inlier_thresh=thresh, with_scale=with_scale)
    out_j = jsim3.ransac_sim3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), jax.random.PRNGKey(key),
                              n_hypotheses=256, inlier_thresh=thresh, with_scale=with_scale)
    for u, v in zip(out_t[:3], out_j[:3]):
        close(u, v, atol=1e-4)
    np.testing.assert_array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    assert int(out_t[4]) == int(out_j[4]) > 40

    own = tsim3.sample_indices(key, tsim3.mask_probs(T(mask)), (256, 3))
    assert torch.equal(own, tsim3.sample_indices(key, tsim3.mask_probs(T(mask)), (256, 3)))
    assert bool(T(mask)[own].all())


def test_scene_scaled_thresh_even_count():
    """`jnp.nanmedian` averages the two middle values of an even count
    (`torch.nanmedian` would return the lower one): odd, even, single and
    empty masks, exact to float32 rounding (1e-7)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(40, 3)).astype(np.float32) * 3.0
    for n_on in (40, 17, 16, 2, 1, 0):
        mask = np.zeros(40, bool)
        mask[rng.permutation(40)[:n_on]] = True
        a = tlc.scene_scaled_thresh(T(x), T(mask))
        b = jlc.scene_scaled_thresh(jnp.asarray(x), jnp.asarray(mask))
        close(a, b, atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# Pose graph
# ---------------------------------------------------------------------------


def _yaw(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _drifted_circle(K=12, seed=0, tilt=0.0):
    """tests/test_pgo_4dof_gba.py's circle: ground truth on a circle, the
    estimates drifting in yaw and translation (plus a fixed roll `tilt`)."""
    rng = np.random.default_rng(seed)
    R_gt, t_gt, R_est, t_est = [], [], [], []
    roll = np.array([[1, 0, 0], [0, np.cos(tilt), -np.sin(tilt)], [0, np.sin(tilt), np.cos(tilt)]])
    for k in range(K):
        a = 2 * np.pi * k / K
        R_cw = _yaw(a).T
        t_cw = -R_cw @ np.array([np.cos(a), np.sin(a), 0.0])
        R_gt.append(R_cw)
        t_gt.append(t_cw)
        dy = 0.15 * k / K + rng.normal(0, 0.01) if k else 0.0
        dt = 0.3 * k / K * rng.normal(0, 1, 3) * np.array([1, 1, 0.2]) if k else 0.0
        R_est.append(R_cw @ _yaw(dy).T @ roll)
        t_est.append(t_cw + dt)
    f = lambda v: np.stack(v).astype(np.float32)  # noqa: E731
    return f(R_est), f(t_est), f(R_gt), f(t_gt)


def _graph_arrays(R_est, t_est, R_gt, t_gt, covis_ties=True):
    """Chain + covisibility edges from the estimates (both packages' helpers,
    compared), plus a loop edge K-1 -> 0 measured from ground truth, weight 5."""
    K = R_est.shape[0]
    valid = np.ones(K, bool)
    valid[5] = False
    covis = np.zeros((K, K), np.int32)
    for i in range(K):
        for j in range(K):
            if i != j:
                covis[i, j] = 40 if covis_ties and abs(i - j) in (2, 3) else (90 - 7 * abs(i - j)) * (abs(i - j) < 5)
    s = np.ones(K, np.float32)
    ch_t = tpgo.chain_edges(T(R_est), T(t_est), T(s), T(valid))
    ch_j = jpgo.chain_edges(jnp.asarray(R_est), jnp.asarray(t_est), jnp.asarray(s), jnp.asarray(valid))
    cv_t = tpgo.covis_edges(T(R_est), T(t_est), T(s), T(valid), T(covis))
    cv_j = jpgo.covis_edges(jnp.asarray(R_est), jnp.asarray(t_est), jnp.asarray(s), jnp.asarray(valid),
                            jnp.asarray(covis))
    for a, b in zip(ch_t + cv_t, ch_j + cv_j):
        if a.dtype.is_floating_point:
            close(a, b, atol=1e-5)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e = [np.concatenate([np.asarray(a), np.asarray(b)]) for a, b in zip(ch_j, cv_j)]
    Ri, ti = jlie.se3_inverse(jnp.asarray(R_gt[K - 1]), jnp.asarray(t_gt[K - 1]))
    Rl, tl = (np.asarray(v) for v in jlie.se3_compose(jnp.asarray(R_gt[0]), jnp.asarray(t_gt[0]), Ri, ti))
    fixed = np.zeros(K, bool)
    fixed[0] = True
    return dict(R=R_est, t=t_est, s=s, node_mask=valid, fixed_mask=fixed,
                e_i=np.concatenate([e[0], [K - 1]]).astype(np.int32),
                e_j=np.concatenate([e[1], [0]]).astype(np.int32),
                e_R=np.concatenate([e[2], Rl[None]]).astype(np.float32),
                e_t=np.concatenate([e[3], tl[None]]).astype(np.float32),
                e_s=np.concatenate([e[4], [1.0]]).astype(np.float32),
                e_weight=np.concatenate([np.ones(len(e[0])), [5.0]]).astype(np.float32),
                e_mask=np.concatenate([e[5], [True]]))


@pytest.mark.parametrize("mode", ["se3", "sim3", "4dof"])
def test_pgo_parity(mode):
    """`optimize` in the three modes over chain + covisibility edges (with
    weight ties, which the port's top_k breaks towards the lower slot, as
    `lax.top_k` does), an invalid node and a weighted loop edge: 20 GN
    iterations, poses within 1e-4, scale within 1e-5."""
    g = _graph_arrays(*_drifted_circle())
    out_t = tpgo.optimize(tpgo.PoseGraph(**{k: T(v) for k, v in g.items()}), iters=20, mode=mode)
    out_j = jpgo.optimize(jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), iters=20, mode=mode)
    close(out_t.R, out_j.R, atol=1e-4)
    close(out_t.t, out_j.t, atol=1e-4)
    close(out_t.s, out_j.s, atol=1e-5)
    assert np.abs(out_t.t.numpy() - g["t"]).max() > 1e-3  # the graph did move


def test_4dof_preserves_roll_pitch():
    """tests/test_pgo_4dof_gba.py's roll/pitch case in the port: every
    estimate tilted by a fixed 0.2 rad roll; the 4-DoF graph may only turn
    about world z, so R_new R_tilt^T fixes R_tilt's world-z axis (within the
    reference test's 5e-2), and the port equals the reference within 1e-4."""
    R_est, t_est, R_gt, t_gt = _drifted_circle(tilt=0.2)
    g = _graph_arrays(R_est, t_est, R_gt, t_gt, covis_ties=False)
    out_t = tpgo.optimize(tpgo.PoseGraph(**{k: T(v) for k, v in g.items()}), iters=10, mode="4dof")
    out_j = jpgo.optimize(jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), iters=10, mode="4dof")
    close(out_t.R, out_j.R, atol=1e-4)
    close(out_t.t, out_j.t, atol=1e-4)
    for k in (3, 7):
        D = out_t.R[k].numpy() @ R_est[k].T
        axis_c = R_est[k] @ np.array([0, 0, 1.0], np.float32)
        np.testing.assert_allclose(D @ axis_c, axis_c, atol=5e-2)


# ---------------------------------------------------------------------------
# Global BA: segment sums, the alternating solver, both branches of global_ba
# ---------------------------------------------------------------------------


def _line_obs(R, t, xs, xe):
    uv_s = np.asarray(jcam.project(JF, xs @ R.T + t))
    uv_e = np.asarray(jcam.project(JF, xe @ R.T + t))
    l = np.cross(np.concatenate([uv_s, np.ones((len(xs), 1))], -1), np.concatenate([uv_e, np.ones((len(xs), 1))], -1))
    return (l / np.linalg.norm(l[:, :2], axis=-1, keepdims=True)).astype(np.float32)


def _map(rng, K, n_kf, S=40, Sl=6, P=160, L=24, outliers=0.05):
    """Reference stores of a drifted map: n_kf keyframes walking along x
    (slots n_kf.. empty, slot 3 culled), each observing S - 4 of P points
    (stereo, 0.5 px noise, a share `outliers` of gross outliers) and Sl of L lines; poses
    and landmarks perturbed off the truth."""
    pts = np.stack([rng.uniform(-2.5, 2.5, P), rng.uniform(-1.5, 1.5, P), rng.uniform(3, 7, P)], -1).astype(np.float32)
    xs = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1, 1, L), rng.uniform(3, 6, L)], -1).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    xe = xs + 0.8 * d / np.linalg.norm(d, axis=-1, keepdims=True)
    R_true = np.stack([_yaw(0.02 * np.sin(k)).astype(np.float32) for k in range(K)])
    t_true = np.array([[-0.04 * k, 0.01 * np.sin(k), 0.0] for k in range(K)], np.float32)
    obs_pt = np.full((K, S), -1, np.int32)
    obs_uvr = np.zeros((K, S, 3), np.float32)
    obs_ln = np.full((K, Sl), -1, np.int32)
    obs_l = np.zeros((K, Sl, 3), np.float32)
    for k in range(n_kf):
        ids = np.sort(rng.choice(P, S - 4, replace=False))
        obs_pt[k, : S - 4] = ids
        uvr = np.asarray(jcam.stereo_project(JF, pts[ids] @ R_true[k].T + t_true[k]))
        uvr = uvr + rng.normal(size=uvr.shape).astype(np.float32) * 0.5
        uvr[rng.random(len(ids)) < outliers] += 30.0
        obs_uvr[k, : S - 4] = uvr
        lids = np.sort(rng.choice(L, Sl, replace=False))
        obs_ln[k] = lids
        obs_l[k] = _line_obs(R_true[k], t_true[k], xs[lids], xe[lids])
    R0, t0 = R_true.copy(), t_true.copy()
    for k in range(1, n_kf):
        dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01, jnp.float32)))
        R0[k], t0[k] = dR @ R0[k], dR @ t0[k] + dt
    valid = np.arange(K) < n_kf
    valid[3] = False
    ks = jst.KeyFrameStore.empty(K, S, Sl)
    ks = dataclasses.replace(
        ks, R=jnp.asarray(R0), t=jnp.asarray(t0), valid=jnp.asarray(valid), obs_pt=jnp.asarray(obs_pt),
        obs_uvr=jnp.asarray(obs_uvr), obs_sigma2=jnp.ones((K, S)), obs_stereo=jnp.asarray(rng.random((K, S)) > 0.2),
        obs_ln=jnp.asarray(obs_ln), obs_l=jnp.asarray(obs_l), obs_ln_sigma2=jnp.full((K, Sl), 4.0))
    ps = jst.PointStore.empty(P, K)
    ps = dataclasses.replace(ps, x=jnp.asarray(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03),
                             valid=jnp.asarray(rng.random(P) > 0.05),
                             last_kf=jnp.asarray(rng.integers(0, n_kf, P).astype(np.int32)))
    seg = np.concatenate([xs, xe], -1) + rng.normal(size=(L, 6)).astype(np.float32) * 0.02
    ls = jst.LineStore.empty(L, K)
    ls = dataclasses.replace(ls, seg=jnp.asarray(seg), valid=jnp.ones(L, bool),
                             last_kf=jnp.asarray(rng.integers(0, n_kf, L).astype(np.int32)))
    return ks, ps, ls


def test_segment_reduce_and_alternating_ba_parity():
    """`segment_reduce` (1e-5 relative) and `solve_ba_alternating` called
    directly on a 36-pose problem, more than 4 x the window of 8 (global_ba
    takes this solver only past that size): 4 iterations, poses within
    1e-4, points within 3e-3 relative, the prune verdicts agree on 99.5% of
    observations, the cost within 1e-3 relative."""
    rng = np.random.default_rng(3)
    ks, ps, ls = _map(rng, 36, 36)
    window = jnp.arange(36, dtype=jnp.int32)
    prob_j, _, _ = jtr.window_problem(ks, ps, ls, window, window == 0)
    tks, tps, tls = port_stores(ks, ps, ls)
    prob_t, _, _ = tstep.window_problem(tks, tps, tls, T(np.arange(36, dtype=np.int32)), T(np.arange(36) == 0))
    idx_t, _ = tba.prepare_indices(prob_t, wcap_pt=16, wcap_ln=16)
    idx_j, _ = jba.prepare_indices(prob_j, wcap_pt=16, wcap_ln=16)
    vals = rng.normal(size=(prob_t.po_pt.shape[0], 5)).astype(np.float32)
    close(tba.segment_reduce(idx_t, T(vals)), jba.segment_reduce(idx_j, jnp.asarray(vals)), rtol=1e-5, atol=1e-5)

    cfg = OptimizerConfig()
    topt = port_cfg(SlamConfig(opt=cfg)).opt
    rt = tba.solve_ba_alternating(TF, prob_t, topt, iters=4)
    rj = jax.jit(lambda p: jba.solve_ba_alternating(JF, p, cfg, iters=4))(prob_j)
    close(rt.R, rj.R, atol=1e-4)
    close(rt.t, rj.t, atol=1e-4)
    close(rt.pts, rj.pts, rtol=3e-3, atol=1e-3)
    close(rt.cost, rj.cost, rtol=1e-3)
    agree = (rt.po_chi2.numpy() < cfg.prune_chi2_pt) == (np.asarray(rj.po_chi2) < cfg.prune_chi2_pt)
    assert agree.mean() > 0.995
    assert np.abs(rt.t.numpy() - np.asarray(prob_j.t)).max() > 1e-4  # the solver did move the poses


@pytest.mark.parametrize("K", [32, 40])
def test_global_ba_parity(K):
    """`global_ba` over a whole 30-keyframe map in both branches: K = 32
    slots is 4 x the window (the Schur `local_ba`), K = 40 is past it (the
    alternating solver, which also erases the outlier observations it
    finds). 3 iterations, as one amortized chunk; poses within 1e-4,
    points 3e-3 relative, the erased observations equal but for 0.5%. 2%
    gross outliers: with 5%, an observation whose chi2 lies within rounding
    of the prune gate between the Schur solve's two stages was seen to flip
    and send the two packages' LM down different accept / reject paths."""
    rng = np.random.default_rng(4)
    jcfg = SlamConfig.tiny_test()
    jcfg = dataclasses.replace(jcfg, map=dataclasses.replace(jcfg.map, max_keyframes=K))
    ks, ps, ls = _map(rng, K, 30, outliers=0.02)
    out_j = jax.jit(partial(jtr.global_ba, JF, jcfg), static_argnames=("iters",))(ks, ps, ls, iters=3)
    out_t = tstep.global_ba(TF, port_cfg(jcfg), *port_stores(ks, ps, ls), iters=3)
    close(out_t[0].R, out_j[0].R, atol=1e-4)
    close(out_t[0].t, out_j[0].t, atol=1e-4)
    close(out_t[1].x, out_j[1].x, rtol=3e-3, atol=1e-3)
    same = out_t[0].obs_pt.numpy() == np.asarray(out_j[0].obs_pt)
    assert same.mean() > 0.995
    erased = (np.asarray(ks.obs_pt) >= 0) & (np.asarray(out_j[0].obs_pt) < 0)
    assert erased.sum() > 0  # the planted outliers were pruned


# ---------------------------------------------------------------------------
# Verification and correction: the reference's decoy scene
# ---------------------------------------------------------------------------


def _decoy_scene(rng, cfg, partial_rigid=False, scene_scale=1.0):
    """tests/test_loop_closing_e2e.py's scene in both packages: cluster A seen
    by KF0, KF10, KF11 (the true loop); the decoy KF5 sees aliased landmarks
    (same descriptors) -- with `partial_rigid`, half of them an exact rigid
    offset of A (3D-3D RANSAC verifies it) and the rest scattered (only the
    projection re-check rejects it). Returns (reference tracker, port tracker)
    stand-ins with what LoopCloser reads."""
    K, S, nA = 12, 64, 40
    xA = np.stack([rng.uniform(-1.4, 1.4, nA), rng.uniform(-1.0, 1.0, nA), rng.uniform(3, 6, nA)], -1).astype(np.float32)
    descA = np.sign(rng.normal(size=(nA, 256))).astype(np.int8)
    offset = np.asarray([5.0, 0.5, 1.0], np.float32)
    if partial_rigid:
        xD = xA + offset
        xD[nA // 2:] += rng.normal(size=(nA - nA // 2, 3)).astype(np.float32) * 1.3
    else:
        xD = xA + offset + rng.normal(size=(nA, 3)).astype(np.float32) * 1.3
    uvA = np.stack([120.0 * xA[:, 0] / xA[:, 2] + 64.0, 120.0 * xA[:, 1] / xA[:, 2] + 48.0], -1).astype(np.float32)
    obs = np.full((K, S), -1, np.int32)
    uvr = np.zeros((K, S, 3), np.float32)
    for k in (0, 10, 11):
        obs[k, :nA] = np.arange(nA)
        uvr[k, :nA, :2] = uvA
    obs[5, :nA] = np.arange(nA) + nA
    ks = jst.KeyFrameStore.empty(cfg.map.max_keyframes, S, 8)
    ks = dataclasses.replace(ks, valid=ks.valid.at[:K].set(True), obs_pt=ks.obs_pt.at[:K].set(jnp.asarray(obs)),
                             obs_uvr=ks.obs_uvr.at[:K].set(jnp.asarray(uvr)), t=ks.t * scene_scale)
    ps = jst.PointStore.empty(512)
    ps = dataclasses.replace(
        ps, x=ps.x.at[:nA].set(jnp.asarray(xA)).at[nA:2 * nA].set(jnp.asarray(xD)) * scene_scale,
        desc=ps.desc.at[:nA].set(jnp.asarray(descA)).at[nA:2 * nA].set(jnp.asarray(descA)),
        valid=ps.valid.at[:2 * nA].set(True))
    ls = jst.LineStore.empty(64)

    class Stand:
        pass

    out = []
    for stores, cam, zeros in (((ks, ps, ls), JC, lambda n: jnp.zeros(n)),
                               (port_stores(ks, ps, ls), TC, lambda n: torch.zeros(n))):
        tr = Stand()
        tr.kstore, tr.pstore, tr.lstore = stores
        tr.n_kf, tr.cam, tr.cfg, tr.imu_ready = K, cam, cfg, False
        tr.R, tr.t = (jnp.eye(3), jnp.zeros(3)) if cam is JC else (torch.eye(3), torch.zeros(3))
        tr._reset_motion = lambda: None
        tr._full_inertial_ba = lambda: None
        tr.span = lambda name: contextlib.nullcontext()
        out.append(tr)
    return out


def _decoy_cfg(**loop):
    cfg = SlamConfig.tiny_test()
    # run_gba off: the decisions are under test here; the BA that follows a
    # closure is held by test_global_ba_parity and the planted closure below
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, min_kf_gap=2, consistency_kfs=2, proj_min_inliers=30, run_gba=False, **loop))


def _both_closers(cfg, consistent_with):
    jl, tl = jlc.LoopCloser(cfg), tlc.LoopCloser(port_cfg(cfg), draw=reference_draw)
    for lc in (jl, tl):
        lc._consistency, lc._consistent_with = cfg.loop.consistency_kfs, consistent_with
    return jl, tl


def _close_both(cfg, trs, kf, cands, consistent_with):
    jl, tl = _both_closers(cfg, consistent_with)
    closed = (jl.on_keyframe(trs[0], kf, cands), tl.on_keyframe(trs[1], kf, cands))
    assert closed[0] == closed[1], closed
    assert jl.n_loops_closed == tl.n_loops_closed
    return closed[0]


def test_decoy_rejected_true_candidate_verified(rng):
    """The decoy listed first (higher BoW score) fails verification and the
    true candidate behind it closes the loop, in both packages (decisions
    exact); the corrected stores agree within 1e-4."""
    cfg = _decoy_cfg()
    trs = _decoy_scene(rng, cfg)
    assert _close_both(cfg, trs, 11, [(5, 0.9), (0, 0.5)], 5)
    assert_stores_close((trs[1].kstore, trs[1].pstore, trs[1].lstore), (trs[0].kstore, trs[0].pstore, trs[0].lstore))


@pytest.mark.parametrize("scene_scale", [0.1, 1.0, 10.0])
def test_projection_check_and_scale_invariance(rng, scene_scale):
    """The partial-rigid decoy passes the 3D-3D RANSAC (its rigid half) and
    dies at the projection re-check; the true candidate passes both; the
    same at 0.1x / 1x / 10x scene scale (the RANSAC threshold scales with
    the scene). Decisions and projection counts exact."""
    cfg = _decoy_cfg(sim3_min_inliers=15)
    jt, tt = _decoy_scene(rng, cfg, partial_rigid=True, scene_scale=scene_scale)
    lp = port_cfg(cfg).loop
    for cand in (5, 0):
        x, y, m = tlc.match_kf_landmarks(tt.kstore, tt.pstore, 11, cand)
        xj, yj, mj = jlc.match_kf_landmarks(jt.kstore, jt.pstore, 11, cand)
        np.testing.assert_array_equal(m.numpy(), np.asarray(mj))
        thresh = tlc.scene_scaled_thresh(x, m)
        hyp = reference_draw(11 * 7 + cand, tsim3.mask_probs(m), (lp.sim3_hypotheses, 3))
        R, t, s, _, n_in = tsim3.ransac_sim3(x, y, m, hyp, inlier_thresh=thresh, with_scale=False)
        Rj, tj, sj, _, nj = jsim3.ransac_sim3(xj, yj, mj, jax.random.PRNGKey(11 * 7 + cand), n_hypotheses=256,
                                              inlier_thresh=jlc.scene_scaled_thresh(xj, mj), with_scale=False)
        assert int(n_in) == int(nj) >= 15
        for kf_obs in (11, 10):
            n_t = tlc.projection_support(TC, tt.kstore, tt.pstore, kf_obs, cand, R, t, s, radius=lp.proj_radius_px)
            n_j = jlc.projection_support(JC, jt.kstore, jt.pstore, kf_obs, cand, Rj, tj, sj, radius=lp.proj_radius_px)
            assert int(n_t) == int(n_j)
    assert not _close_both(cfg, (jt, tt), 11, [(5, 0.9)], 5)
    assert _close_both(cfg, (jt, tt), 11, [(0, 0.9)], 0)


def _drifted_line_map(rng, scale_drift=None):
    """tests/test_loop_closing_e2e.py's manufactured drift: 12 keyframes out
    along x and back, the second half drifted by a constant offset (or, with
    `scale_drift`, scaled up), 32 landmarks anchored at the last keyframe and
    16 lines at it too."""
    cfg = SlamConfig.tiny_test()
    K = 12
    t_gt = [-np.array([0.5 * (k if scale_drift else min(k, K - 1 - k)), 0.0, 0.0], np.float32) for k in range(K)]
    drift = np.array([0.4, 0.25, -0.3], np.float32)
    t_est = np.stack(t_gt)
    for k in range(K // 2, K):
        if scale_drift:
            t_est[k] = t_gt[k] * scale_drift
        else:
            t_est[k] = t_gt[k] + (k - K // 2 + 1) / (K - K // 2) * drift
    ks = jst.KeyFrameStore.empty(cfg.map.max_keyframes, 8, 4)
    covis = np.zeros((cfg.map.max_keyframes,) * 2, np.int32)
    covis[2, 6] = covis[6, 2] = 45  # one covisibility edge beside the chain
    ks = dataclasses.replace(ks, t=ks.t.at[:K].set(jnp.asarray(t_est)), valid=ks.valid.at[:K].set(True),
                             covis=jnp.asarray(covis))
    x_true = np.stack([rng.uniform(-2, 2, 32), rng.uniform(-2, 2, 32), rng.uniform(3, 6, 32)], -1).astype(np.float32)
    x_d = x_true * scale_drift if scale_drift else x_true - drift
    ps = jst.PointStore.empty(256)
    ps = dataclasses.replace(ps, x=ps.x.at[:32].set(jnp.asarray(x_d)), valid=ps.valid.at[:32].set(True),
                             last_kf=ps.last_kf.at[:32].set(K - 1))
    seg = np.concatenate([x_d[:16], x_d[16:]], -1)
    ls = jst.LineStore.empty(64)
    ls = dataclasses.replace(ls, seg=ls.seg.at[:16].set(jnp.asarray(seg)), valid=ls.valid.at[:16].set(True),
                             last_kf=ls.last_kf.at[:16].set(K - 1))
    return cfg, (ks, ps, ls), t_gt, x_true, drift


@pytest.mark.parametrize("mode", ["se3", "4dof", "sim3"])
def test_apply_loop_correction_parity(rng, mode):
    """Essential-graph correction + re-anchoring of points and line
    endpoints in the three modes (rigid, inertial 4-DoF, and the mono Sim3
    drift of test_scale_drift_corrected_by_sim3_pgo). Stores within 2e-4
    (20 GN iterations of a dense [7K, 7K] solve); and the drift is
    removed as the reference test demands."""
    cfg, stores, t_gt, x_true, drift = _drifted_line_map(rng, 1.10 if mode == "sim3" else None)
    K = 12
    if mode == "sim3":
        R_rel, t_rel, s_rel = np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.float32(1 / 1.10)
    else:
        R_rel, t_rel, s_rel = np.eye(3, dtype=np.float32), drift, None
    inertial = mode == "4dof"
    out_j = jlc.apply_loop_correction(*stores, K, K - 1, 0, jnp.asarray(R_rel), jnp.asarray(t_rel), cfg,
                                      inertial=inertial, s_rel=None if s_rel is None else jnp.asarray(s_rel))
    out_t = tlc.apply_loop_correction(*port_stores(*stores), K - 1, 0, T(R_rel), T(t_rel), port_cfg(cfg),
                                      inertial=inertial, s_rel=None if s_rel is None else T(s_rel))
    assert_stores_close(out_t, out_j, atol=2e-4)
    err_before = np.linalg.norm(np.asarray(stores[0].t[K - 1]) - t_gt[K - 1])
    err_after = np.linalg.norm(out_t[0].t[K - 1].numpy() - t_gt[K - 1])
    assert err_after < 0.35 * err_before, (err_before, err_after)
    lm_before = np.linalg.norm(np.asarray(stores[1].x[:32]) - x_true, axis=1).mean()
    lm_after = np.linalg.norm(out_t[1].x[:32].numpy() - x_true, axis=1).mean()
    assert lm_after < 0.5 * lm_before, (lm_before, lm_after)


def test_queue_gba_divergences(guard_rig):
    """Where the port departs from the reference on purpose: the reference's
    `_queue_gba` for a non-inertial map reads `cfg.opt.gba_chunk_iters`,
    which does not exist (the field is `cfg.loop.gba_chunk_iters`), so an
    amortized closure of its visual path raises AttributeError; and its
    visual tracker has no `_map_event_cooldown`, which `run_deferred_ba`
    reads after a chunk. The port reads the loop config (ceil(10 / 3) = 4
    chunks of 3 iterations) and keeps the counter for every sensor."""
    cfg, _ = guard_rig
    jt, tt = jtr.Tracker(JC, cfg), Tracker(TC, port_cfg(cfg), "cpu")
    with pytest.raises(AttributeError, match="gba_chunk_iters"):
        jt._queue_gba(False)
    assert not hasattr(jt, "_map_event_cooldown")
    tt._queue_gba(False)
    assert tt._deferred_ba == [("gba", cfg.loop.gba_chunk_iters)] * 4
    assert tt._map_event_cooldown == 0


# ---------------------------------------------------------------------------
# tests/test_failure_guards.py in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def guard_rig():
    """tiny_test (loop closing on) with the point store a multiple of the
    reference's 2048-row Pallas tile; the reference on its accelerator
    branch, as test_torch_tracker runs it."""
    cfg = SlamConfig.tiny_test()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_points=2048, local_map_points=2048))
    frames = [(np.array(f["img_l"]), np.array(f["img_r"])) for f in jsyn.make_sequence(JC, 8, fps=20.0)]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    yield cfg, frames
    mp.undo()


def _guard_run(cfg, frames, stamps, steps):
    """Both trackers over `frames` at `stamps`; `steps[i]` (if any) is called
    on each tracker after frame i. Returns per-frame (state, n_kf, n_maps) pairs."""
    jt, tt = jtr.Tracker(JC, cfg), Tracker(TC, port_cfg(cfg), "cpu")
    out = []
    for i, ((il, ir), stamp) in enumerate(zip(frames, stamps)):
        for tr in (jt, tt):
            tr.process(il, ir, stamp)
            if i in steps:
                steps[i](tr)
        out.append(tuple((tr.state, int(tr.n_kf), tr.atlas.n_maps(), tr.imu_ready) for tr in (jt, tt)))
    return out


@pytest.mark.parametrize("case", ["older_stamp_resets", "forward_jump_tolerated", "reset_keeps_parked"])
def test_failure_guards_both_packages(guard_rig, case):
    """tests/test_failure_guards.py's three cases, both trackers on the same
    frames: a frame older than its predecessor resets the active map and
    tracking re-initializes; a forward jump of 4.85 s without an IMU is no
    reset; `reset_active_map` after a parked map keeps it. Per frame the
    state, keyframe count, map count and IMU flag are equal."""
    cfg, frames = guard_rig
    if case == "older_stamp_resets":
        out = _guard_run(cfg, frames, [0.0, 0.05, 0.10, 0.15, 0.02, 0.25, 0.30, 0.35], {})
        assert out[4][0][1] <= 1 and out[-1][0][0] == TrackingState.OK
    elif case == "forward_jump_tolerated":
        out = _guard_run(cfg, frames[:5], [0.0, 0.05, 0.10, 0.15, 5.0], {})
        assert out[4][0][1] >= out[3][0][1]
    else:
        out = _guard_run(cfg, frames[:6], [0.0, 0.05, 0.10, 0.15, 0.20, 0.25],
                         {3: lambda tr: tr._switch_to_new_map(), 5: lambda tr: tr.reset_active_map()})
        assert out[3][0][2] == 2 and out[5][0][2] == 2
        assert out[5][0][:2] == (TrackingState.NOT_INITIALIZED, 0)
    for j, t in out:
        assert j == t, out


# ---------------------------------------------------------------------------
# The reference alone on the full-width loop scenario of chip_smoke.py
# ---------------------------------------------------------------------------


def loop_scenario_config():
    """SlamConfig.euroc_stereo() with loop closing at its defaults and
    bench.py's per-keyframe creation budget for a long run (bench.py:88-91),
    the reference's twin of the port's `utils.profile.loop_config()`."""
    cfg = SlamConfig.euroc_stereo()
    return dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, kf_max_new_points=256))


def _overlapping_pair(stamps, valid, traj, min_gap):
    """The keyframe pair (newer, older), at least `min_gap` slots apart, whose
    ground-truth poses are nearest (m plus viewing-direction angle in rad):
    chip_smoke.py's `_overlapping_pair` over the reference's keyframes."""
    poses = [traj.pose(float(t)) for t in stamps]
    best = (np.inf, -1, -1)
    for i in range(len(stamps)):
        for j in range(i - min_gap + 1):
            if valid[i] and valid[j]:
                (Ri, pi), (Rj, pj) = poses[i], poses[j]
                cost = np.linalg.norm(pi - pj) + np.arccos(np.clip(Ri[:, 2] @ Rj[:, 2], -1.0, 1.0))
                best = min(best, (cost, i, j))
    return best[1], best[2], best[0]


@pytest.mark.slow
def test_full_width_reference_loop_scenario(capsys):
    """The reference alone, on its accelerator branch (Pallas in interpret
    mode, as the port's parity tests run it), over the scenario of
    chip_smoke.py's phase 6a: 180 frames of bench.py's flagship trajectory
    at 752x480, SlamConfig.euroc_stereo() with loop closing on, streaming
    mode. Prints every keyframe's loop candidates (all empty: see PERF.md),
    then plants the closure that phase 6a plants (the keyframes that ground
    truth says overlap, the consistency counter pre-set), runs the queued
    "gba" chunks one by one and prints each keyframe's position error
    against the truth after each, and the ATE. Two defects of the
    reference's visual path are stepped around (test_queue_gba_divergences):
    `_queue_gba` reads `cfg.opt.gba_chunk_iters`, which does not exist (the
    field is `cfg.loop.gba_chunk_iters`), so every amortized closure raises
    AttributeError after the PGO; and the visual tracker has no
    `_map_event_cooldown`, so its first "gba" chunk would raise after its
    BA. The test queues the chunks the port queues and sets the attribute.
    The port's `global_ba` runs each chunk too, from the reference's own
    state (before each of its chunks, and chained from its corrected map):
    every keyframe within 0.05 m of the reference's after each chunk (0.021
    m measured after the first chunk, which moves keyframes ~1 m).
    Last, the kidnap of chip_smoke.py's phase 6b on this tracker, six frames,
    states and distances printed."""
    cfg = loop_scenario_config()
    cam = jcam.Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    try:
        jt = jtr.Tracker(cam, cfg)
        jt.streaming = True
        orig = jt.loop_closer.on_keyframe

        def on_keyframe(tracker, kf_slot, cands):
            closed = orig(tracker, kf_slot, cands)
            with capsys.disabled():
                print(f"\nreference loop: frame {len(tracker.stats)} kf {kf_slot} cands "
                      f"{[(s, round(sc, 3)) for s, sc in cands]} consistency {jt.loop_closer._consistency} "
                      f"closed {closed}", end="", flush=True)
            return closed

        jt.loop_closer.on_keyframe = on_keyframe
        gt, states = [], []
        t0 = time.perf_counter()
        traj = jsyn.Trajectory(**FLAGSHIP_TRAJ)
        for fr in jsyn.make_sequence(cam, N_FRAMES_LOOP, fps=cfg.fps, traj=traj):
            info = jt.process(fr["img_l"], fr["img_r"], fr["t"])
            gt.append(fr["p_w"])
            states.append(info["state"])
        n_loops = jt.loop_closer.n_loops_closed
        pend, done = list(jt._traj_pending), list(jt._traj_done)
        ate_run = jsyn.ate_rmse(jt.positions(), np.stack(gt))
        jt._traj_pending, jt._traj_done = pend, done

        n = int(jt.n_kf)
        stamps, valid = np.asarray(jt.kstore.stamp[:n]), np.asarray(jt.kstore.valid[:n])
        R0, p0 = traj.pose(0.0)
        kf_gt = np.stack([R0.T @ (traj.pose(float(s))[1] - p0) for s in stamps])

        def kf_err():
            R, t = np.asarray(jt.kstore.R[:n]), np.asarray(jt.kstore.t[:n])
            return np.round(np.linalg.norm(-np.einsum("kji,kj->ki", R, t) - kf_gt, axis=1)[valid], 3).tolist()

        kf_cur, kf_loop, cost = _overlapping_pair(stamps, valid, traj, cfg.loop.min_kf_gap)
        jt.loop_closer._consistency, jt.loop_closer._consistent_with = cfg.loop.consistency_kfs, kf_loop
        with capsys.disabled():
            print(f"\nreference: {n_loops} loops closed by the run, ATE {ate_run:.4f} m; planted closure kf "
                  f"{kf_cur} -> {kf_loop} (pose distance {cost:.3f}); keyframe errors {kf_err()}", flush=True)
        chunk = cfg.loop.gba_chunk_iters
        jt._queue_gba = lambda inertial: setattr(jt, "_deferred_ba", [("gba", chunk)] * -(-cfg.opt.gba_iters // chunk))
        jt._map_event_cooldown = 0
        assert orig(jt, kf_cur, [(kf_loop, 1.0)])
        errs = [kf_err()]
        n_chunks = len(jt._deferred_ba)
        # the port's global_ba from the reference's own full-width state: each chunk
        # from the state the reference's chunk started from, and the chain of chunks
        tcfg = port_cfg(cfg)
        chain = port_stores(jt.kstore, jt.pstore, jt.lstore)
        t_errs, gaps, chain_gaps = [], [], []

        def port_pos(ks):
            return -np.einsum("kji,kj->ki", ks.R[:n].numpy(), ks.t[:n].numpy())

        while jt._deferred_ba:
            before = port_stores(jt.kstore, jt.pstore, jt.lstore)
            jt.run_deferred_ba()
            errs.append(kf_err())
            p_ref = -np.einsum("kji,kj->ki", np.asarray(jt.kstore.R[:n]), np.asarray(jt.kstore.t[:n]))
            step_t = tstep.global_ba(TF, tcfg, *before, iters=chunk)
            chain = tstep.global_ba(TF, tcfg, *chain, iters=chunk)
            gaps.append(float(np.linalg.norm(port_pos(step_t[0]) - p_ref, axis=1)[valid].max()))
            chain_gaps.append(float(np.linalg.norm(port_pos(chain[0]) - p_ref, axis=1)[valid].max()))
            t_errs.append(np.round(np.linalg.norm(port_pos(chain[0]) - kf_gt, axis=1)[valid], 3).tolist())
        ate = jsyn.ate_rmse(jt.positions(), np.stack(gt))
        with capsys.disabled():
            print(f"reference: keyframe errors after the PGO and after each of {n_chunks} GBA chunks:", flush=True)
            for e in errs:
                print(f"  {e}", flush=True)
            print("port, its chunks chained from the reference's corrected map: keyframe errors after each:")
            for e in t_errs:
                print(f"  {e}", flush=True)
            print(f"largest keyframe position gap, port to reference, each chunk from the reference's state "
                  f"{np.round(gaps, 5).tolist()} m, chained {np.round(chain_gaps, 5).tolist()} m", flush=True)
            print(f"reference loop scenario: ATE {ate:.4f} m after the planted closure, n_kf {n}, "
                  f"{sum(s == 'OK' for s in states)}/{len(states)} OK, {time.perf_counter() - t0:.0f} s", flush=True)
        assert np.isfinite(ate)
        assert max(gaps + chain_gaps) < 0.05

        # chip_smoke.py's phase 6b on this tracker: tests/test_reloc_pnp.py's kidnap, six times
        R_wc, p_w = traj.pose(0.1)
        p_kid = p_w + np.array([0.45, 0.3, -0.25])
        yaw = 0.35
        R_wc = R_wc @ np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
        R_j, p_j = jnp.asarray(R_wc, jnp.float32), jnp.asarray(p_kid, jnp.float32)
        img_l = jsyn.render_view(cam, R_j, p_j)
        img_r = jsyn.render_view(cam, R_j, p_j + R_j[:, 0] * float(cam.bf / cam.fx))
        R_cw = (R0.T @ R_wc).T
        t_cw = -R_cw @ (R0.T @ (p_kid - p0))
        R, t, *_, n_ref, _, _ = jt._track(jt.build_frame(img_l, img_r), jnp.asarray(R_cw, jnp.float32),
                                          jnp.asarray(t_cw, jnp.float32), jt.pstore, jt.lstore)
        p_ref = -(np.asarray(R).T @ np.asarray(t))
        kid = []
        for i in range(6):
            info = jt.process(img_l, img_r, N_FRAMES_LOOP / cfg.fps + 0.05 * i)
            err = np.linalg.norm(-(np.asarray(jt.R).T @ np.asarray(jt.t)) - p_ref)
            kid.append((info["state"], info["n_inliers"], round(float(err), 3)))
        with capsys.disabled():
            print(f"reference kidnap (inlier floors {cfg.tracking.min_inliers_track} / "
                  f"{cfg.tracking.min_inliers_local_map}; oracle re-track {int(n_ref)} inliers): (state, reported "
                  f"inliers, m from the oracle re-track) per frame {kid}", flush=True)
    finally:
        mp.undo()
