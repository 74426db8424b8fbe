"""The visual-inertial BA's reduced system: one float32 ulp of input, in
float32 and in float64.

The full inertial BA of the IMU initialization solves windows of 8 / 16 / 32
keyframes 0.1-0.3 s apart, the oldest fixed, the IMU information up to ~1e6
from the 1e-6 covariance floor (reference `pli_slam_tpu/solve/vi_ba.py:101`),
in `local_ba_iters` damped Gauss-Newton steps with no acceptance test. The
window below has that shape (`init_window`: twelve keyframes on the
trajectory of test_torch_inertial, 600 points 3-40 m deep seen by all of
them, the free poses 0.02 rad / m off, the velocities 0.05 m/s off). Near
its minimum the reduced system's float32 assembly lies O(1) off a float64
one in the Jacobi-equilibrated entries (a Schur complement of large terms),
so every float32 step there is mostly rounding and the keyframes wander by
fractions of a millimetre from iteration to iteration. With the newest
keyframe's rotation one ulp off (numpy.nextafter), the reference's solve
(JAX, float32, as `pli_slam_tpu.solve.vi_ba.solve_vi_ba` runs on the CPU)
and the port's with the reduced system in float32 (the CPU's default, the
reference's arithmetic) move the keyframes by AMPLIFIED and more; the port's
with it in float64 (the default on CUDA, `ba.reduced_dtype`) by at most
ROUNDED_MOVE, the state's own float32 rounding. A recorded divergence:
ROADMAP queue 3 C. The float64 path is held against the reference on
test_torch_inertial.test_solve_vi_ba_parity's problem at that test's
tolerances, and on both problems against a float64 solve: the port with
every float of the problem in float64.
"""

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.solve import vi_ba as jvib
from pli_slam_tpu.utils.config import ImuConfig, OptimizerConfig
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.solve import vi_ba as tvib
from pli_slam_tpu_torch.utils import convert
from test_torch_inertial import (JC, TC, VIBA_NAMES, _body, _both_viba, _cam_pose, _chain, _line_obs, _port_cfg,
                                 _scene, _stack, _viba_problem, G_W, jcam, jinr, jlie, jnp)

torch.set_num_threads(1)
T = torch.as_tensor
W, P, L = 12, 600, 12
SEEDS = (0, 7)
# Over seeds 0-9 of `init_window` the one-ulp twin moves the keyframes 3.4e-7 to 1.0e-3 m in the reference
# (more than AMPLIFIED in 0 and 7: 1.0e-3, 8.0e-4), 3.0e-7 to 8.4e-4 m in the port's float32 solve (the same
# two: 8.4e-4, 2.7e-4), at most 1.4e-6 m in its float64 solve; that lies at most 1.1e-6 m from the float64
# solve (the reference 2.8e-4 and 2.3e-6 m on seeds 0 and 7). SEEDS are the two that amplify.
AMPLIFIED = 1e-4  # m: the least the float32 solves move a keyframe
ROUNDED_MOVE = 2e-6  # m: the most the float64 solve moves one, and how far it lies from a float64 solve
# Over the float32 solve's six iterates the equilibrated float32 system lies up to 7.7 (seed 0) and 2.1e-2
# (seed 7) off the float64 one; at the first iterate 2.0e-2 and 3.5e-5.
S_F32_OFF = 1e-2


def init_window(rng) -> tuple:
    """An IMU initialization's full-inertial-BA window: W keyframes 0.1-0.3 s
    apart on test_torch_inertial's trajectory, the oldest fixed, each free
    pose 0.02 rad / m off the truth; P points 3-40 m in front of the middle
    keyframe, seen by every keyframe (10% of the slots empty), 80% stereo;
    L lines 2-6 m in front of it (test_torch_inertial's `_scene`); 0.5 px
    of noise; the chain preintegrated from ideal 200 Hz samples (its
    covariance far under the 1e-6 floor); velocities 0.05 m/s off, biases
    small. Returns (base, chain, rest) as `_viba_problem` does."""
    times = 0.5 + np.concatenate([[0.0], np.cumsum(rng.uniform(0.1, 0.3, W - 1))])
    bodies = [_body(t) for t in times]
    cams = [_cam_pose(b[0], b[1]) for b in bodies]
    R_m, t_m = cams[W // 2]
    _, xs, xe = _scene(rng, R_m, t_m, P=P, L=L)  # its lines; the points lie farther
    xc = np.stack([rng.uniform(-8, 8, P), rng.uniform(-4, 4, P), rng.uniform(3, 40, P)], -1)
    pts = ((xc - t_m) @ R_m).astype(np.float32)
    R = np.stack([c[0] for c in cams]).astype(np.float32)
    t = np.stack([c[1] for c in cams]).astype(np.float32)
    po_uvr = np.concatenate([np.asarray(jcam.stereo_project(JC, pts @ R[w].T + t[w])) for w in range(W)])
    po_uvr = (po_uvr + rng.normal(size=po_uvr.shape) * 0.5).astype(np.float32)
    lo_l = np.concatenate([_line_obs(R[w], t[w], xs, xe) for w in range(W)])
    po_pt = np.tile(np.arange(P, dtype=np.int32), W)
    po_pt[rng.random(W * P) < 0.1] = -1
    R0, t0 = R.copy(), t.copy()
    for w in range(1, W):
        dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.02, jnp.float32)))
        R0[w], t0[w] = dR @ R0[w], dR @ t0[w] + dt
    base = dict(
        R=R0, t=t0, pose_mask=np.ones(W, bool), fixed_mask=np.arange(W) < 1,
        pts=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03, pt_mask=np.ones(P, bool),
        lns=np.concatenate([xs, xe], -1) + rng.normal(size=(L, 6)).astype(np.float32) * 0.03,
        ln_mask=np.ones(L, bool), po_pose=np.repeat(np.arange(W, dtype=np.int32), P), po_pt=po_pt, po_uvr=po_uvr,
        po_stereo=rng.random(W * P) > 0.2, po_sigma2=np.ones(W * P, np.float32), po_mask=np.ones(W * P, bool),
        lo_pose=np.repeat(np.arange(W, dtype=np.int32), L), lo_ln=np.tile(np.arange(L, dtype=np.int32), W),
        lo_l=lo_l, lo_sigma2=np.full(W * L, 4.0, np.float32), lo_mask=np.ones(W * L, bool))
    v = np.stack([b[2] for b in bodies]) + rng.normal(size=(W, 3)).astype(np.float32) * 0.05
    jext = jinr.Extrinsics.from_Tbc(None)
    rest = dict(v=v.astype(np.float32), bg=np.zeros((W, 3), np.float32) + np.float32([0.002, -0.001, 0.001]),
                ba=np.zeros((W, 3), np.float32) + np.float32([0.02, 0.01, -0.03]), imu_mask=np.ones(W - 1, bool),
                gravity_w=G_W, R_cb=np.asarray(jext.R_cb), t_cb=np.asarray(jext.t_cb))
    return base, _stack(_chain(times)), rest


def one_ulp(case: tuple) -> tuple:
    """The newest keyframe's rotation, every entry one float32 ulp toward zero."""
    base, chain, rest = case
    R = base["R"].copy()
    R[-1] = np.nextafter(R[-1], np.float32(0))
    return {**base, "R": R}, chain, rest


def float64_problem(case: tuple) -> tvib.VIBAProblem:
    """The port's problem with every float of `case` in float64."""
    up = lambda d: {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in d.items()}  # noqa: E731
    base, chain, rest = case
    chain = jax.tree_util.tree_map(lambda x: x.astype(np.float64) if x.dtype == np.float32 else x, chain)
    return tvib.VIBAProblem(base=tba.BAProblem(**{k: T(v) for k, v in up(base).items()}),
                            preint=convert.preintegrated(chain), **{k: T(v) for k, v in up(rest).items()})


def centres(R, t) -> np.ndarray:
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return -np.einsum("wji,wj->wi", R, t)


def moved(a, b) -> float:
    """The largest keyframe-centre distance, m, between two solves' results."""
    return float(np.linalg.norm(centres(a[0], a[1]) - centres(b[0], b[1]), axis=-1).max())


@pytest.fixture(scope="module")
def cfgs():
    opt, imu = OptimizerConfig(), ImuConfig()
    return opt, imu, *_port_cfg(opt, imu)


@pytest.fixture(scope="module")
def jsolve(cfgs):
    opt, imu = cfgs[:2]
    return jax.jit(lambda p: jvib.solve_vi_ba(JC, p, opt, imu))


_CASES = {}


def case_of(seed: int) -> tuple:
    if seed not in _CASES:
        _CASES[seed] = init_window(np.random.default_rng(seed))
    return _CASES[seed]


def port_solve(case, cfgs, dtype, monkeypatch):
    monkeypatch.setattr(tba, "reduced_dtype", lambda device: dtype)
    return tvib.solve_vi_ba(TC, _both_viba(*case)[1], *cfgs[2:])


def test_reduced_system_dtype_is_float64_on_cuda_only(cfgs, monkeypatch):
    """`vi_ba_iteration` forms its system in `ba.reduced_dtype` of the
    device (float64 on CUDA only), or in float64 for a float64 state
    (`vi_ba.system_dtype`), and returns a float32 state for a float32 one:
    with the default it equals the explicit float32 path on the CPU, and
    with `reduced_dtype` set to float64 the explicit float64 path, bit for
    bit."""
    assert tba.reduced_dtype("cuda") == torch.float64 and tba.reduced_dtype(torch.device("cuda", 0)) == torch.float64
    assert tba.reduced_dtype("cpu") == torch.float32
    assert tvib.system_dtype(torch.zeros(1)) == torch.float32
    assert tvib.system_dtype(torch.zeros(1, dtype=torch.float64)) == torch.float64
    tp = _both_viba(*_viba_problem(np.random.default_rng(3)))[1]
    args = (TC, tp, *tba.prepare_indices(tp.base), tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba, tp.base.pts,
            tp.base.lns, *cfgs[2:], torch.tensor(np.float32(cfgs[0].damping_init)))
    out = {dt: tvib.vi_ba_iteration(*args, dtype=dt) for dt in (torch.float32, torch.float64)}
    assert all(x.dtype == torch.float32 for x in out[torch.float64])
    assert not all(torch.equal(a, b) for a, b in zip(out[torch.float32], out[torch.float64]))
    for dt in (torch.float32, torch.float64):
        if dt == torch.float64:
            monkeypatch.setattr(tba, "reduced_dtype", lambda device: torch.float64)
        assert all(torch.equal(a, b) for a, b in zip(tvib.vi_ba_iteration(*args), out[dt])), dt


@pytest.mark.parametrize("seed", SEEDS)
def test_float32_assembly_of_the_init_window_is_off(seed, cfgs):
    """Along the float32 solve of the window, the equilibrated reduced
    system assembled in float32 (the reference's and the CPU's) lies
    S_F32_OFF and more off the float64 one from the same linearization."""
    tp = _both_viba(*case_of(seed))[1]
    idx = tba.prepare_indices(tp.base)
    damping = torch.tensor(np.float32(cfgs[0].damping_init))
    state, off = (tp.base.R, tp.base.t, tp.v, tp.bg, tp.ba, tp.base.pts, tp.base.lns), []
    for _ in range(cfgs[2].local_ba_iters):
        S32, S64 = (tvib.reduced_system(TC, tp, *idx, *state, *cfgs[2:], damping, dt)[0].double()
                    for dt in (torch.float32, torch.float64))
        d = 1.0 / torch.sqrt(torch.diagonal(S64))
        off.append(float(((S32 - S64) * d[:, None] * d[None, :]).abs().max()))
        state = tvib.vi_ba_iteration(TC, tp, *idx, *state, *cfgs[2:], damping, dtype=torch.float32)
    assert max(off) > S_F32_OFF, off


@pytest.mark.parametrize("seed", SEEDS)
def test_one_ulp_moves_the_float32_solves_not_the_float64_one(seed, cfgs, jsolve, capsys, monkeypatch):
    """The window and its one-ulp twin through the reference's solve_vi_ba
    and the port's with the reduced system in float32 (the CPU's) and in
    float64 (CUDA's, `reduced_dtype` set so here): the first two move the
    keyframes by AMPLIFIED and more, the float64 one by at most ROUNDED_MOVE;
    and the float64 one lies within ROUNDED_MOVE of a float64 solve, no
    farther than the reference's."""
    pair = (case_of(seed), one_ulp(case_of(seed)))
    ref = [jsolve(_both_viba(*c)[0]) for c in pair]
    port = {dt: [port_solve(c, cfgs, dt, monkeypatch) for c in pair] for dt in (torch.float32, torch.float64)}
    r64 = tvib.solve_vi_ba(TC, float64_problem(pair[0]), *cfgs[2:])
    assert r64[0].dtype == torch.float64
    mv = dict(ref=moved(*ref), port32=moved(*port[torch.float32]), port64=moved(*port[torch.float64]))
    far = dict(ref=moved(ref[0], r64), port64=moved(port[torch.float64][0], r64))
    with capsys.disabled():
        print(f"\none ulp, seed {seed}: the keyframes moved {mv['ref']:.3e} m (reference), {mv['port32']:.3e} m "
              f"(port, float32), {mv['port64']:.3e} m (port, float64); from a float64 solve {far['ref']:.3e} m "
              f"(reference), {far['port64']:.3e} m (port, float64)")
    assert mv["ref"] > AMPLIFIED and mv["port32"] > AMPLIFIED, mv
    assert mv["port64"] <= ROUNDED_MOVE, mv
    assert far["port64"] <= ROUNDED_MOVE and far["port64"] <= far["ref"], far


def test_float64_solve_parity_on_the_vi_ba_parity_problem(cfgs, jsolve, monkeypatch):
    """test_torch_inertial.test_solve_vi_ba_parity's problem through the
    port's solve_vi_ba with the reduced system in float64 (CUDA's): every
    field within that test's tolerances of the reference's; the keyframes'
    centres, velocities and accelerometer biases no farther from a float64
    solve than the reference's. (On this well-conditioned problem both lie
    at float32's rounding from it: keyframes 3.3e-7 against 6.3e-7 m,
    velocities 1.35e-6 against 1.36e-6 m/s, accelerometer biases 9.2e-7
    against 2.3e-6; rotations, gyro biases and landmarks either way, the
    landmarks 1.5e-5 / 1.8e-5 against 7.5e-6 / 1.2e-5 m.)"""
    case = _viba_problem(np.random.default_rng(3))
    jp, tp = _both_viba(*case)
    ref = jsolve(jp)
    monkeypatch.setattr(tba, "reduced_dtype", lambda device: torch.float64)
    port = tvib.solve_vi_ba(TC, tp, *cfgs[2:])
    for name, a, b, tol in zip(VIBA_NAMES, port, ref, (2e-5, 2e-5, 1e-4, 1e-4, 1e-4, 5e-4, 5e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, err_msg=name)
    r64 = tvib.solve_vi_ba(TC, float64_problem(case), *cfgs[2:])
    off = lambda res, i: float(np.abs(np.asarray(res[i], np.float64) - r64[i].numpy()).max())  # noqa: E731
    port_off = dict(kf=moved(port, r64), v=off(port, 2), ba=off(port, 4))
    ref_off = dict(kf=moved(ref, r64), v=off(ref, 2), ba=off(ref, 4))
    assert all(port_off[k] <= ref_off[k] for k in port_off), (port_off, ref_off)
