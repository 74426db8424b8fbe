"""Parity of the port's inertial solvers with the JAX package:
solve/inertial.py, solve/vi_ba.py, solve/imu_init.py.

One synthetic world feeds both packages: a body on the analytic trajectory
of the tiny tests, ideal 200 Hz IMU samples preintegrated between keyframes
(by the reference, then carried across as numpy), a cloud of points and
line segments in front of the camera, stereo observations with pixel
noise. Everything is drawn from a seed with numpy.

Tolerances, and why:
- `Extrinsics`, `body_state_from_camera`, `camera_pose`, the seeds
  (`gravity_dir_seed`, `velocity_seed`, `estimate_gravity_direction`):
  1e-5, closed-form float32;
- `estimate_gyro_bias`: 1e-5 rad/s (a 3x3 solve);
- the 15x15 IMU block of the pose solve (`imu_terms`): residual 2e-5,
  Jacobian 1e-4 of each block row's largest entry (forward-mode autodiff
  on both sides);
- `solve_pose_inertial`: rotation 2e-5, position 5e-5 m, velocity 5e-4 m/s,
  biases 2e-4, inlier masks equal. Its information matrix is
  `inv(cov + floors)` with entries up to 1e8 and a Jacobi-equilibrated
  float32 solve per iteration: the two LAPACK paths agree to ~1e-5 relative
  in the step, and ten iterations contract towards the same minimum;
- `vi_ba_iteration` (one iteration from identical input): poses 2e-4,
  velocities 5e-4 m/s, biases 2e-4, landmarks 2e-3 m (measured against the
  jitted reference: 1e-4, 1e-4, 2e-5, 3e-4; against the eager one the
  poses agree to 1e-5, so XLA's own fusion moves the step as much). The [15 W, 15 W] system mixes IMU information (~1e6
  after the 1e-6 floor) with visual blocks (~1e2..1e4) and is solved in
  float32 after equilibration; landmark depth is its weakest direction.
  `solve_vi_ba` (six iterations, which contract the difference): poses
  2e-5, velocities 1e-4, biases 1e-4, landmarks 5e-4 (measured: 2e-6,
  3e-6, 5e-6, 5e-5), and the cost of the chain factors within 2%;
- `inertial_optimization`: gravity direction within 0.02 degrees, biases
  1e-4, velocities 1e-3 m/s, final cost within 1%: fifteen dense GN steps
  on whitened residuals (a float32 Cholesky of `inv(cov + 1e-6)`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import imu as jimu
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.solve import ba as jba
from pli_slam_tpu.solve import gn as jgn
from pli_slam_tpu.solve import imu_init as jii
from pli_slam_tpu.solve import inertial as jinr
from pli_slam_tpu.solve import residuals as jres
from pli_slam_tpu.solve import vi_ba as jvib
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import ImuConfig, OptimizerConfig, SlamConfig
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.ops import imu as timu
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.solve import gn as tgn
from pli_slam_tpu_torch.solve import imu_init as tii
from pli_slam_tpu_torch.solve import inertial as tinr
from pli_slam_tpu_torch.solve import vi_ba as tvib
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2)
JC, TC = jcam.Camera.pinhole(**CAM_ARGS), tcam.Camera.pinhole(**CAM_ARGS)
TRAJ = jsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
G_W = np.float32([0.0, 0.0, -9.81])
# a EuRoC-like body->camera transform: a quarter turn about y and a few centimetres
EUROC_TBC = np.eye(4, dtype=np.float32)
EUROC_TBC[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.02, 1.55, -0.01], jnp.float32)))
EUROC_TBC[:3, 3] = [-0.02, -0.06, 0.01]


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _port_cfg(opt=None, imu=None):
    cfg = SlamConfig(opt=opt or OptimizerConfig(), imu=imu or ImuConfig())
    cfg = convert.config_from_reference(dataclasses.asdict(cfg))
    return cfg.opt, cfg.imu


def _preint_between(t0, t1, rate=200.0, bg=None, ba=None):
    """The reference's preintegration of ideal samples over [t0, t1], its leaves as numpy."""
    n = int(round((t1 - t0) * rate))
    ts = t0 + (np.arange(n) + 0.5) / rate  # midpoint samples
    samples = [TRAJ.imu_sample(float(t)) for t in ts]
    gyro, acc = np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples])
    z = np.zeros(3, np.float32)
    return np_tree(jimu.preintegrate(gyro, acc, np.full(n, 1.0 / rate, np.float32), np.ones(n, bool),
                                     jnp.asarray(z if bg is None else bg), jnp.asarray(z if ba is None else ba),
                                     ImuConfig()))


def _stack(trees):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _body(t):
    R, p = TRAJ.pose(t)
    return R.astype(np.float32), p.astype(np.float32), TRAJ.velocity(t).astype(np.float32)


def _cam_pose(R_wb, p_w, Tbc=None):
    """T_cw of the camera riding on the body."""
    R_bc, t_bc = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)) if Tbc is None else (Tbc[:3, :3], Tbc[:3, 3])
    R_wc, p_c = R_wb @ R_bc, p_w + R_wb @ t_bc
    return R_wc.T, -R_wc.T @ p_c


def _scene(rng, R_cw, t_cw, P=96, L=16):
    """Points and segments 2-6 m in front of the camera (R_cw, t_cw), in world coordinates."""
    def to_world(xc):
        return ((xc - t_cw) @ R_cw).astype(np.float32)

    pts = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P), rng.uniform(2, 6, P)], -1)
    xs = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L), rng.uniform(2, 6, L)], -1)
    d = rng.normal(size=(L, 3))
    xe = xs + d / np.linalg.norm(d, axis=-1, keepdims=True) * 0.8
    return to_world(pts), to_world(xs), to_world(xe)


def _line_obs(R, t, xs, xe):
    uv_s = np.asarray(jcam.project(JC, xs @ R.T + t))
    uv_e = np.asarray(jcam.project(JC, xe @ R.T + t))
    l = np.cross(np.concatenate([uv_s, np.ones((len(xs), 1))], -1), np.concatenate([uv_e, np.ones((len(xs), 1))], -1))
    return (l / np.linalg.norm(l[:, :2], axis=-1, keepdims=True)).astype(np.float32)


def close(t, j, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(t.detach().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# solve/inertial.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Tbc", [None, EUROC_TBC, tuple(EUROC_TBC.reshape(-1).tolist())],
                         ids=["identity", "matrix", "row_major_tuple"])
def test_extrinsics_and_body_camera_round_trip(Tbc):
    jext, text = jinr.Extrinsics.from_Tbc(Tbc), tinr.Extrinsics.from_Tbc(Tbc)
    close(text.R_cb, jext.R_cb, 1e-6)
    close(text.t_cb, jext.t_cb, 1e-6)
    close(convert.extrinsics(np_tree(jext)).R_cb, jext.R_cb, 0)
    rng = np.random.default_rng(0)
    R_cw = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.5, jnp.float32)))
    t_cw, v, bg, ba = (rng.normal(size=3).astype(np.float32) for _ in range(4))
    jb = jinr.body_state_from_camera(R_cw, t_cw, v, bg, ba, jext)
    tb = tinr.body_state_from_camera(T(R_cw), T(t_cw), T(v), T(bg), T(ba), text)
    for (k, a), (_, b) in zip(convert.to_numpy(tb).items(), convert.to_numpy(np_tree(jb)).items()):
        close(a, b, 1e-6, msg=k)
    for a, b, ref in zip(tinr.camera_pose(tb, text), jinr.camera_pose(jb, jext), (R_cw, t_cw)):
        close(a, b, 1e-6)
        close(a, ref, 1e-5)  # and the round trip closes
    delta = (rng.normal(size=15) * 0.05).astype(np.float32)
    for (k, a), (_, b) in zip(convert.to_numpy(tinr._state_from_delta(tb, T(delta))).items(),
                              convert.to_numpy(np_tree(jinr._state_from_delta(jb, delta))).items()):
        close(a, b, 1e-6, msg=k)


def _pose_case(rng, Tbc):
    """Previous state true at t0, one frame of IMU to t1, noisy stereo + line
    observations at t1, and an initial state off the truth."""
    t0, t1 = 0.60, 0.65
    pre = _preint_between(t0, t1)
    R0, p0, v0 = _body(t0)
    R1, p1, v1 = _body(t1)
    R_cw, t_cw = _cam_pose(R1, p1, Tbc)
    pts, xs, xe = _scene(rng, R_cw, t_cw, P=160, L=24)
    uvr = np.asarray(jcam.stereo_project(JC, pts @ R_cw.T + t_cw))
    uvr = (uvr + rng.normal(size=uvr.shape) * 0.5).astype(np.float32)
    bad = rng.random(len(pts)) < 0.15
    uvr[bad] += rng.uniform(-40, 40, size=(bad.sum(), 3)).astype(np.float32)
    obs = dict(x_w=pts, uvr=uvr, stereo_mask=rng.random(len(pts)) > 0.2, point_mask=rng.random(len(pts)) > 0.05,
               sigma2_pt=np.float32(1.2) ** rng.integers(0, 3, len(pts)).astype(np.float32) ** 2,
               xs_w=xs, xe_w=xe, l_obs=_line_obs(R_cw, t_cw, xs, xe), line_mask=np.ones(len(xs), bool),
               sigma2_ln=np.full(len(xs), 4.0, np.float32))
    z = np.zeros(3, np.float32)
    prev = dict(R_wb=R0, p_w=p0, v_w=v0, bg=z, ba=z)
    init = dict(R_wb=R1 @ np.asarray(jlie.so3_exp(jnp.asarray([0.004, -0.003, 0.002], jnp.float32))),
                p_w=p1 + np.float32([0.01, -0.008, 0.006]), v_w=v1 + np.float32([0.03, -0.02, 0.01]), bg=z, ba=z)
    return pre, obs, prev, init, (R1, p1, v1)


@pytest.mark.parametrize("Tbc", [None, EUROC_TBC], ids=["identity", "euroc_like_tbc"])
def test_solve_pose_inertial_parity(Tbc):
    rng = np.random.default_rng(1)
    pre, obs, prev, init, (R1, p1, v1) = _pose_case(rng, Tbc)
    opt, imu = OptimizerConfig(), ImuConfig()
    topt, timu_cfg = _port_cfg(opt, imu)
    jext, text = jinr.Extrinsics.from_Tbc(Tbc), tinr.Extrinsics.from_Tbc(Tbc)

    # the 15x15 IMU block by itself, at the initial state
    def r_of(x):
        st = jinr._state_from_delta(jinr.BodyState(**init), x)
        return jnp.concatenate([jres.imu_residual(pre, prev["R_wb"], prev["p_w"], prev["v_w"],
                                                  st.R_wb, st.p_w, st.v_w, st.bg, st.ba, G_W),
                                st.bg - prev["bg"], st.ba - prev["ba"]])

    r_j, J_j = np.asarray(r_of(jnp.zeros(15))), np.asarray(jax.jacfwd(r_of)(jnp.zeros(15)))
    tstate = lambda d: tinr.BodyState(**{k: T(v) for k, v in d.items()})  # noqa: E731
    r_t, J_t = tinr.imu_terms(convert.preintegrated(pre), tstate(prev), tstate(init), T(G_W))
    assert J_t.dtype == torch.float32 and J_t.shape == (15, 15)
    close(r_t, r_j, 2e-5)
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 15)):
        close(J_t[rows], J_j[rows], 1e-4 * np.abs(J_j[rows]).max())

    solve_j = jax.jit(lambda o, p, a, b: jinr.solve_pose_inertial(JC, jext, o, p, a, b, opt, imu, gravity_w=G_W))
    sj, in_pt_j, in_ln_j, n_j = solve_j(jgn.PoseObservations(**obs), pre,
                                        jinr.BodyState(**prev), jinr.BodyState(**init))
    st, in_pt_t, in_ln_t, n_t = tinr.solve_pose_inertial(
        TC, text, tgn.PoseObservations(**{k: T(v) for k, v in obs.items()}), convert.preintegrated(pre),
        tstate(prev), tstate(init), topt, timu_cfg, gravity_w=T(G_W))
    close(st.R_wb, sj.R_wb, 2e-5)
    close(st.p_w, sj.p_w, 5e-5)
    close(st.v_w, sj.v_w, 5e-4)
    close(st.bg, sj.bg, 2e-4)
    close(st.ba, sj.ba, 2e-4)
    np.testing.assert_array_equal(in_pt_t.numpy(), np.asarray(in_pt_j))
    np.testing.assert_array_equal(in_ln_t.numpy(), np.asarray(in_ln_j))
    assert int(n_t) == int(n_j) > 100
    # and both really pull the perturbed state back to the truth
    assert np.abs(np.asarray(sj.p_w) - p1).max() < 4e-3 and np.abs(st.p_w.numpy() - p1).max() < 4e-3
    # a scalar gravity (the configured magnitude along world -z) is the default
    s0 = tinr.solve_pose_inertial(TC, text, tgn.PoseObservations(**{k: T(v) for k, v in obs.items()}),
                                  convert.preintegrated(pre), tstate(prev), tstate(init), topt, timu_cfg)[0]
    close(s0.p_w, st.p_w, 1e-6)


def _chain(times, bg=None, ba=None):
    return [_preint_between(a, b, bg=bg, ba=ba) for a, b in zip(times[:-1], times[1:])]


def test_estimate_gyro_bias_and_gravity_direction_parity():
    times = 0.3 * np.arange(7)
    pres = _chain(times)
    bodies = [_body(t) for t in times]
    # visual rotations as a biased gyro would contradict them: turn each by JRg @ bias
    bias = np.float32([0.02, -0.015, 0.01])
    dRs = [bodies[i][0].T @ bodies[i + 1][0] @ np.asarray(jlie.so3_exp(jnp.asarray(p.JRg @ bias)))
           for i, p in enumerate(pres)]
    for prior in (1.0, 0.0):
        bj = jinr.estimate_gyro_bias(pres, dRs, prior_info=prior)
        bt = tinr.estimate_gyro_bias([convert.preintegrated(p) for p in pres], [T(d) for d in dRs], prior_info=prior)
        close(bt, bj, 1e-5)
    np.testing.assert_allclose(np.asarray(bj), bias, atol=2e-3)  # without a prior the planted bias comes back
    # gravity: the world is tilted, so the estimate has something to find
    tilt = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.2, 0.1], jnp.float32)))
    Rs = [tilt @ b[0] for b in bodies[:-1]]
    Rj = jinr.estimate_gravity_direction([p for p in pres], Rs)
    Rt = tinr.estimate_gravity_direction([convert.preintegrated(p) for p in pres], [T(R) for R in Rs])
    close(Rt, Rj, 1e-5)
    g_dir = np.asarray(Rj) @ [0, 0, -1.0]
    assert np.degrees(np.arccos(np.clip(g_dir @ (tilt @ [0, 0, -1.0]), -1, 1))) < 8.0


# ---------------------------------------------------------------------------
# solve/vi_ba.py
# ---------------------------------------------------------------------------


def _viba_problem(rng, Tbc=None):
    """Five keyframes 0.25 s apart and a sixth window slot that repeats the
    fifth (the padding of a short window); the factor 0 -> 1 is masked out.
    (Masking a factor in the middle would cut the free poses into a pair
    held by one factor, whose common-mode velocity and accelerometer bias
    nothing observes: both packages then step along float32 noise.)"""
    times = 0.5 + 0.25 * np.arange(5)
    K, W = 5, 6
    bodies = [_body(t) for t in times]
    cams = [_cam_pose(b[0], b[1], Tbc) for b in bodies]
    pts, xs, xe = _scene(rng, *cams[2], P=64, L=12)
    P, L = len(pts), len(xs)
    slot = [0, 1, 2, 3, 4, 4]
    R = np.stack([cams[s][0] for s in slot]).astype(np.float32)
    t = np.stack([cams[s][1] for s in slot]).astype(np.float32)
    po_uvr = np.concatenate([np.asarray(jcam.stereo_project(JC, pts @ R[w].T + t[w])) for w in range(W)])
    po_uvr = (po_uvr + rng.normal(size=po_uvr.shape) * 0.3).astype(np.float32)
    lo_l = np.concatenate([_line_obs(R[w], t[w], xs, xe) for w in range(W)])
    row_ok = np.array([True] * K + [False])  # the duplicate's observations do not count
    po_pt = np.tile(np.arange(P, dtype=np.int32), W)
    po_pt[rng.random(W * P) < 0.1] = -1
    R0, t0 = R.copy(), t.copy()
    for w in range(2, K):  # the free poses start off the truth
        dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.01, jnp.float32)))
        R0[w], t0[w] = dR @ R0[w], dR @ t0[w] + dt
    R0[5], t0[5] = R0[4], t0[4]
    base = dict(
        R=R0, t=t0, pose_mask=np.ones(W, bool), fixed_mask=np.array([True, True, False, False, False, True]),
        pts=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03, pt_mask=np.ones(P, bool),
        lns=np.concatenate([xs, xe], -1) + rng.normal(size=(L, 6)).astype(np.float32) * 0.03,
        ln_mask=np.ones(L, bool),
        po_pose=np.repeat(np.arange(W, dtype=np.int32), P), po_pt=po_pt, po_uvr=po_uvr,
        po_stereo=rng.random(W * P) > 0.2, po_sigma2=np.ones(W * P, np.float32), po_mask=np.repeat(row_ok, P),
        lo_pose=np.repeat(np.arange(W, dtype=np.int32), L), lo_ln=np.tile(np.arange(L, dtype=np.int32), W),
        lo_l=lo_l, lo_sigma2=np.full(W * L, 4.0, np.float32), lo_mask=np.repeat(row_ok, L))
    pres = _chain(times)
    chain = _stack(pres + [pres[-1]])  # [W-1]; the last entry belongs to the duplicate
    v = np.stack([bodies[s][2] for s in slot]) + rng.normal(size=(W, 3)).astype(np.float32) * 0.02
    jext = jinr.Extrinsics.from_Tbc(Tbc)
    rest = dict(v=v.astype(np.float32), bg=np.zeros((W, 3), np.float32) + np.float32([0.002, -0.001, 0.001]),
                ba=np.zeros((W, 3), np.float32) + np.float32([0.02, 0.01, -0.03]),
                imu_mask=np.array([False, True, True, True, False]), gravity_w=G_W,
                R_cb=np.asarray(jext.R_cb), t_cb=np.asarray(jext.t_cb))
    return base, chain, rest


def _both_viba(base, chain, rest):
    jp = jax.tree_util.tree_map(jnp.asarray, jvib.VIBAProblem(base=jba.BAProblem(**base), preint=chain, **rest))
    tp = tvib.VIBAProblem(base=tba.BAProblem(**{k: T(v) for k, v in base.items()}),
                          preint=convert.preintegrated(chain), **{k: T(v) for k, v in rest.items()})
    return jp, tp


VIBA_NAMES = ("R", "t", "v", "bg", "ba", "pts", "lns")


@pytest.mark.parametrize("Tbc", [None, EUROC_TBC], ids=["identity", "euroc_like_tbc"])
def test_vi_ba_iteration_parity(Tbc):
    rng = np.random.default_rng(2)
    jp, tp = _both_viba(*_viba_problem(rng, Tbc))
    opt, imu = OptimizerConfig(), ImuConfig()
    topt, timu_cfg = _port_cfg(opt, imu)
    # the chain factors' residuals and Jacobians, all factors at once
    ks = jnp.arange(5)
    z15 = jnp.zeros(15)
    args = (jp, jp.base.R, jp.base.t, jp.v, jp.bg, jp.ba)
    r_j = jax.vmap(lambda k: jvib._imu_chain_residual(*args, k, z15, z15, imu))(ks)
    Ji_j = jax.vmap(lambda k: jax.jacfwd(lambda d: jvib._imu_chain_residual(*args, k, d, z15, imu))(z15))(ks)
    Jj_j = jax.vmap(lambda k: jax.jacfwd(lambda d: jvib._imu_chain_residual(*args, k, z15, d, imu))(z15))(ks)
    r_t, Ji_t, Jj_t = tvib.chain_linearization(tp, tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba, timu_cfg)
    close(r_t, r_j, 5e-5)
    for a, b in ((Ji_t, Ji_j), (Jj_t, Jj_j)):
        assert a.dtype == torch.float32 and a.shape == (5, 15, 15)
        for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 15)):
            close(a[:, rows], np.asarray(b)[:, rows], 2e-4 * np.abs(np.asarray(b)[:, rows]).max())
    # one factor alone, through the reference's signature
    z = torch.zeros(15)
    close(tvib._imu_chain_residual(tp, tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba, 1, z, z, timu_cfg), r_j[1], 5e-5)

    damping = np.float32(opt.damping_init)
    ji = jba.prepare_indices(jp.base)
    ti = tba.prepare_indices(tp.base)
    oj = jax.jit(lambda p: jvib.vi_ba_iteration(JC, p, *ji, p.base.R, p.base.t, p.v, p.bg, p.ba, p.base.pts,
                                                p.base.lns, opt, imu, damping))(jp)
    ot = tvib.vi_ba_iteration(TC, tp, *ti, tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba, tp.base.pts, tp.base.lns,
                              topt, timu_cfg, T(damping))
    for name, a, b, tol in zip(VIBA_NAMES, ot, oj, (2e-4, 2e-4, 5e-4, 2e-4, 2e-4, 2e-3, 2e-3)):
        close(a, b, tol, msg=name)
    # the fixed poses (gauge, and the duplicated padding slot) did not move; their velocities may
    for w in (0, 1, 5):
        close(ot[0][w], tp.base.R[w], 1e-6)
        close(ot[1][w], tp.base.t[w], 1e-6)
    assert float((ot[1][2:5] - tp.base.t[2:5]).abs().max()) > 1e-3


def test_solve_vi_ba_parity():
    rng = np.random.default_rng(3)
    jp, tp = _both_viba(*_viba_problem(rng))
    opt, imu = OptimizerConfig(), ImuConfig()
    topt, timu_cfg = _port_cfg(opt, imu)
    oj = jax.jit(lambda p: jvib.solve_vi_ba(JC, p, opt, imu))(jp)
    ot = tvib.solve_vi_ba(TC, tp, topt, timu_cfg)
    for name, a, b, tol in zip(VIBA_NAMES, ot, oj, (2e-5, 2e-5, 1e-4, 1e-4, 1e-4, 5e-4, 5e-4)):
        close(a, b, tol, msg=name)

    def chain_cost(R, t, v, bg, ba):
        r = tvib.chain_linearization(tp, T(np.asarray(R)), T(np.asarray(t)), T(np.asarray(v)), T(np.asarray(bg)),
                                     T(np.asarray(ba)), timu_cfg)[0]
        return float((r[tp.imu_mask, :9] ** 2).sum())

    c0, cj, ct = chain_cost(tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba), chain_cost(*oj[:5]), chain_cost(*ot[:5])
    assert ct < 0.5 * c0 and abs(ct - cj) <= 0.02 * cj + 1e-9, (c0, cj, ct)
    # fewer iterations on request
    o2 = tvib.solve_vi_ba(TC, tp, topt, timu_cfg, iters=1)
    assert float((o2[1] - ot[1]).abs().max()) > 0


# ---------------------------------------------------------------------------
# solve/imu_init.py
# ---------------------------------------------------------------------------


def _init_case(rng, K=8):
    """K keyframes 0.3 s apart in a world tilted against gravity, the chain
    integrated at zero biases from samples that carry a bias."""
    times = 0.2 + 0.3 * np.arange(K)
    tilt = np.asarray(jlie.so3_exp(jnp.asarray([0.25, -0.15, 0.1], jnp.float32)))
    bodies = [_body(t) for t in times]
    R_wb = np.stack([tilt @ b[0] for b in bodies]).astype(np.float32)
    p_wb = np.stack([tilt @ b[1] for b in bodies]).astype(np.float32)
    p_wb = p_wb + rng.normal(size=p_wb.shape).astype(np.float32) * 1e-3  # visual SLAM's millimetres
    chain = _stack(_chain(times))
    mask = np.ones(K - 1, bool)
    mask[4] = False
    return chain, mask, R_wb, p_wb, times.astype(np.float32), tilt


def test_imu_init_seeds_parity():
    rng = np.random.default_rng(4)
    chain, mask, R_wb, p_wb, stamps, tilt = _init_case(rng)
    Rj = jii.gravity_dir_seed(chain, mask, R_wb, 9.81)
    Rt = tii.gravity_dir_seed(convert.preintegrated(chain), T(mask), T(R_wb), 9.81)
    close(Rt, Rj, 1e-5)
    close(tii.velocity_seed(T(p_wb), T(stamps)), jii.velocity_seed(p_wb, stamps), 1e-5)
    g_dir = np.asarray(Rj) @ [0, 0, -1.0]
    assert np.degrees(np.arccos(np.clip(g_dir @ (tilt @ [0, 0, -1.0]), -1, 1))) < 8.0


@pytest.mark.parametrize("mode", ["fix_scale", "fix_scale_and_bias", "free_scale"])
def test_inertial_optimization_parity(mode):
    rng = np.random.default_rng(5)
    chain, mask, R_wb, p_wb, stamps, tilt = _init_case(rng)
    imu = ImuConfig()
    _, timu_cfg = _port_cfg(imu=imu)
    kw = dict(fix_scale=mode != "free_scale", fix_bias=mode == "fix_scale_and_bias", prior_g=1e2, prior_a=1e5)
    Rwg0 = np.asarray(jii.gravity_dir_seed(chain, mask, R_wb, 9.81))
    v0 = np.asarray(jii.velocity_seed(p_wb, stamps))
    bg0, ba0 = np.float32([0.001, -0.002, 0.0005]), np.zeros(3, np.float32)
    oj = jax.jit(lambda c, R, p: jii.inertial_optimization(c, mask, R, p, v0, Rwg0, bg0, ba0, imu, **kw))(
        chain, jnp.asarray(R_wb), jnp.asarray(p_wb))
    ot = tii.inertial_optimization(convert.preintegrated(chain), T(mask), T(R_wb), T(p_wb), T(v0), T(Rwg0), T(bg0),
                                   T(ba0), timu_cfg, **kw)
    gj, gt = np.asarray(oj[0]) @ [0, 0, -1.0], ot[0].numpy() @ [0, 0, -1.0]
    assert np.degrees(np.arccos(np.clip(gj @ gt, -1, 1))) < 0.02
    close(ot[1], oj[1], 1e-4, msg="scale")
    close(ot[2], oj[2], 1e-4, msg="bg")
    close(ot[3], oj[3], 1e-4, msg="ba")
    close(ot[4], oj[4], 1e-3, msg="v")
    assert ot[5].shape == (15,)
    close(ot[5][0], oj[5][0], 0, rtol=1e-3, msg="first cost")
    close(ot[5][-1], oj[5][-1], 0, rtol=1e-2, msg="last cost")
    # the MAP estimate finds the tilted gravity and the keyframe velocities
    assert np.degrees(np.arccos(np.clip(gt @ (tilt @ [0, 0, -1.0]), -1, 1))) < 1.0
    if mode != "free_scale":
        assert float(ot[1]) == 1.0
    if mode == "fix_scale_and_bias":  # held at their linearization point
        close(ot[2], bg0, 0)
        close(ot[3], ba0, 0)
