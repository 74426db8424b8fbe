"""Parity of the port's IMU modules with the JAX package: ops/imu.py, the
SO(3) right Jacobians, the synthetic IMU, and the IMU factor with its
Jacobians.

The same numpy inputs, drawn from a seed, go through both packages.
Tolerances, and why:
- preintegration, composition, prediction: 2e-5 absolute on deltas of order
  0.1-1 (the same float32 recurrence in the same order; only the order of
  sums inside 3x3 / 9x9 products may differ), covariances 1e-5 relative
  with a 1e-12 floor (entries run from 1e-12 to 1e-7);
- `PreintStore`, `midpoint_samples`: exact (copies, and elementwise float32
  arithmetic that both packages round alike);
- the synthetic IMU (`Trajectory.velocity`, `imu_sample`, `_ImuCorruptor`,
  `make_sequence`'s IMU fields): exactly equal, it is numpy on both sides;
- the IMU factor: residual 2e-5; its Jacobians 1e-4 relative to the largest
  entry of each block row (forward-mode autodiff on both sides: `jax.jacfwd`
  against the port's `ops.autodiff.jacfwd`), at a zero and at a non-zero
  residual. At zero the `where` branches of `so3_log` and `_sinc_coeffs`
  sit on their Taylor side, where an untaken branch with a non-finite
  tangent would show as NaN.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import imu as jimu
from pli_slam_tpu.ops import lie as jlie
from pli_slam_tpu.solve import residuals as jres
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import ImuConfig
from pli_slam_tpu_torch.ops import autodiff
from pli_slam_tpu_torch.ops import imu as timu
from pli_slam_tpu_torch.ops import lie as tlie
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.solve import residuals as tres
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import synthetic as tsyn
from pli_slam_tpu_torch.utils.config import ImuConfig as TImuConfig

torch.set_num_threads(1)
T = torch.as_tensor
JCFG, TCFG = ImuConfig(), TImuConfig()


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def batch(rng, T_=16, n_valid=10, dt=0.005):
    """A padded batch of `n_valid` real samples: a slow turn and gravity plus noise."""
    gyro = (rng.normal(size=(T_, 3)) * 0.3).astype(np.float32)
    acc = (rng.normal(size=(T_, 3)) + [0.3, -0.2, 9.7]).astype(np.float32)
    dts = np.full(T_, dt, np.float32)
    mask = np.arange(T_) < n_valid
    return gyro, acc, dts, mask


def assert_preint_close(tp, jp, label=""):
    a, b = convert.to_numpy(tp), convert.to_numpy(np_tree(jp))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, (label, k)
        if k == "cov":
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-12, err_msg=f"{label} {k}")
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=2e-5, err_msg=f"{label} {k}")


def both_preintegrate(gyro, acc, dts, mask, bg, ba):
    jp = jimu.preintegrate(gyro, acc, dts, mask, jnp.asarray(bg), jnp.asarray(ba), JCFG)
    tp = timu.preintegrate(T(gyro), T(acc), T(dts), T(mask), T(bg), T(ba), TCFG)
    return tp, jp


@pytest.mark.parametrize("case", ["full", "ragged", "holes", "empty", "biased", "t32"])
def test_preintegrate_parity(case):
    rng = np.random.default_rng(3)
    T_ = 32 if case == "t32" else 16
    gyro, acc, dts, mask = batch(rng, T_, n_valid={"full": T_, "empty": 0}.get(case, 10))
    if case == "holes":  # masked-out samples in the middle carry garbage that must not count
        mask = mask & (np.arange(T_) % 3 != 1)
        gyro[~mask], acc[~mask], dts[~mask] = 50.0, -80.0, 0.5
    z = np.zeros(3, np.float32)
    bg, ba = (np.float32([0.01, -0.02, 0.005]), np.float32([0.1, 0.05, -0.2])) if case == "biased" else (z, z)
    tp, jp = both_preintegrate(gyro, acc, dts, mask, bg, ba)
    assert_preint_close(tp, jp, case)
    np.testing.assert_allclose(float(tp.dt), dts[mask].sum(), rtol=1e-6)
    if case == "empty":  # a zero-length batch is the identity
        assert_preint_close(tp, dataclasses.replace(jimu.Preintegrated.identity(), bg=bg, ba=ba), "identity")


def test_so3_right_jacobians_parity():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=(6, 3)), rng.normal(size=(3, 3)) * 1e-4, np.zeros((1, 3))]).astype(np.float32)
    np.testing.assert_allclose(tlie.so3_right_jacobian(T(w)).numpy(), np.asarray(jlie.so3_right_jacobian(w)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlie.so3_right_jacobian_inv(T(w)).numpy(),
                               np.asarray(jlie.so3_right_jacobian_inv(w)), rtol=1e-5, atol=1e-6)


def test_compose_against_one_long_preintegrate():
    """compose(a, b) of two halves, in both packages, and against one
    integration of the whole batch (first-order exact: 1e-4)."""
    rng = np.random.default_rng(5)
    gyro, acc, dts, mask = batch(rng, 32, n_valid=32)
    bg, ba = np.float32([0.004, -0.003, 0.002]), np.float32([0.03, -0.02, 0.05])
    halves = [both_preintegrate(gyro[s], acc[s], dts[s], mask[s], bg, ba) for s in (slice(0, 16), slice(16, 32))]
    tc = timu.compose(halves[0][0], halves[1][0])
    jc = jimu.compose(halves[0][1], halves[1][1])
    assert_preint_close(tc, jc, "compose")
    whole, _ = both_preintegrate(gyro, acc, dts, mask, bg, ba)
    for k, v in convert.to_numpy(whole).items():
        np.testing.assert_allclose(convert.to_numpy(tc)[k], v, rtol=1e-3, atol=1e-4, err_msg=k)
    # composing onto the identity linearized at the same biases changes nothing
    ident = timu.identity_with_bias(T(bg), T(ba))
    assert_preint_close(timu.compose(ident, halves[0][0]), jimu.compose(jimu.identity_with_bias(bg, ba), halves[0][1]))
    # a segment integrated at other biases is corrected to the accumulator's
    tb, jb = both_preintegrate(gyro[16:], acc[16:], dts[16:], mask[16:], bg * 3, ba * 0)
    assert_preint_close(timu.compose(halves[0][0], tb), jimu.compose(halves[0][1], jb), "rebias")


@pytest.mark.parametrize("gravity", [9.81, np.float32([0.3, -0.5, -9.79])], ids=["scalar", "vector"])
def test_predict_state_parity(gravity):
    rng = np.random.default_rng(7)
    tp, jp = both_preintegrate(*batch(rng), np.zeros(3, np.float32), np.zeros(3, np.float32))
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.4, jnp.float32)))
    v0, p0 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    bg, ba = np.float32([0.002, 0.001, -0.003]), np.float32([0.02, -0.05, 0.01])
    jo = jimu.predict_state(R0, v0, p0, jp, bg, ba, gravity)
    to = timu.predict_state(T(R0), T(v0), T(p0), tp, T(bg), T(ba), T(gravity) if np.ndim(gravity) else gravity)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_preint_store_set_gather():
    rng = np.random.default_rng(9)
    jstore, tstore = jimu.PreintStore.empty(6), timu.PreintStore.empty(6)
    for a, b in zip(convert.to_numpy(tstore).items(), convert.to_numpy(np_tree(jstore)).items()):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])
    z = np.zeros(3, np.float32)
    for k, valid in ((2, True), (4, False), (5, True)):
        tp, jp = both_preintegrate(*batch(rng), z, z)
        jstore = jstore.set(k, jp, valid=valid)
        # the fused step passes the flag as a 0-d device bool
        tstore = tstore.set(k, convert.preintegrated(np_tree(jp)), valid=torch.tensor(valid) if k == 5 else valid)
    for (ka, a), (kb, b) in zip(convert.to_numpy(tstore).items(), convert.to_numpy(np_tree(jstore)).items()):
        np.testing.assert_array_equal(a, b, err_msg=ka)
    np.testing.assert_array_equal(tstore.valid.numpy(), [False, False, True, False, False, True])
    idx = np.array([5, 2, 2, 0], np.int32)
    for (ka, a), (kb, b) in zip(convert.to_numpy(tstore.gather(T(idx))).items(),
                                convert.to_numpy(np_tree(jstore.gather(idx))).items()):
        np.testing.assert_array_equal(a, b, err_msg=ka)
    # the round trip through utils.convert keeps every leaf
    back = convert.preint_store(np_tree(jstore))
    for (ka, a), (kb, b) in zip(convert.to_numpy(back).items(), convert.to_numpy(tstore).items()):
        np.testing.assert_array_equal(a, b, err_msg=ka)
    # a merge's keyframe slot map (test_torch_reloc_atlas holds more cases)
    slots = np.array([3, 4, -1, 0, 1, 2], np.int32)
    for (ka, a), (kb, b) in zip(convert.to_numpy(tstore.remap(slots)).items(),
                                convert.to_numpy(np_tree(jstore.remap(slots))).items()):
        np.testing.assert_array_equal(a, b, err_msg=ka)


def test_midpoint_samples_parity():
    rng = np.random.default_rng(11)
    n = 12
    gyro, acc = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32)
    stamps = (0.1 + 0.005 * np.arange(n)).astype(np.float32)
    mask = np.arange(n) < 10
    t0, t1 = np.float32(0.112), np.float32(0.139)
    jo = jimu.midpoint_samples(gyro, acc, stamps, t0, t1, mask)
    to = timu.midpoint_samples(T(gyro), T(acc), T(stamps), float(t0), float(t1), T(mask))
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(to[3].sum()) < n - 1


# ---------------------------------------------------------------------------
# The synthetic IMU: numpy on both sides, bit-identical
# ---------------------------------------------------------------------------

TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def test_synthetic_imu_samples_equal():
    tj, tt = jsyn.Trajectory(**TRAJ), tsyn.Trajectory(**TRAJ)
    for t in (0.0, 0.05, 0.731, 3.2):
        np.testing.assert_array_equal(tt.velocity(t), tj.velocity(t))
        for a, b in zip(tt.imu_sample(t), tj.imu_sample(t)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(tsyn.ImuNoiseModel.euroc()) == dataclasses.asdict(jsyn.ImuNoiseModel.euroc())
    cj = jsyn._ImuCorruptor(jsyn.ImuNoiseModel(seed=4), 200.0)
    ct = tsyn._ImuCorruptor(tsyn.ImuNoiseModel(seed=4), 200.0)
    for k in range(25):  # the bias random walk is carried from call to call
        g, a = tj.imu_sample(0.005 * k)
        for x, y in zip(ct(g, a), cj(g, a)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["ideal", "noisy_tbc"])
def test_make_sequence_imu_fields_equal(case):
    from pli_slam_tpu.ops.camera import Camera as JCamera

    args = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, bf=6.6, width=64, height=48)
    kw = {}
    if case == "noisy_tbc":
        Tbc = np.eye(4, dtype=np.float32)
        Tbc[:3, :3] = np.asarray(jlie.so3_exp(jnp.asarray([0.02, 1.55, -0.01], jnp.float32)))
        Tbc[:3, 3] = [-0.02, -0.06, 0.01]
        kw = dict(Tbc=Tbc)
    seq_j = jsyn.make_sequence(JCamera.pinhole(**args), 3, fps=20.0, traj=jsyn.Trajectory(**TRAJ), room_half=2.55,
                               imu_noise=jsyn.ImuNoiseModel.euroc() if kw else None, **kw)
    seq_t = tsyn.make_sequence(TCamera.pinhole(**args), 3, "cpu", fps=20.0, traj=tsyn.Trajectory(**TRAJ),
                               room_half=2.55, imu_noise=tsyn.ImuNoiseModel.euroc() if kw else None, **kw)
    for fj, ft in zip(seq_j, seq_t):
        assert set(ft) == set(fj)
        for key in ("R_wc", "p_w", "v_w", "imu_stamps", "imu_gyro", "imu_acc"):
            assert ft[key].dtype == fj[key].dtype
            np.testing.assert_array_equal(ft[key], fj[key], err_msg=key)
        assert ft["imu_gyro"].shape == (10, 3)
        same = np.abs(ft["img_l"].numpy() - np.asarray(fj["img_l"])) < 1e-3
        assert same.mean() > 0.995  # the camera rides at T_wb * Tbc in both renderers


# ---------------------------------------------------------------------------
# The IMU factor and its Jacobians
# ---------------------------------------------------------------------------


def _factor_case(rng, at_zero: bool):
    z = np.zeros(3, np.float32)
    tp, jp = both_preintegrate(*batch(rng, n_valid=16), z, z)
    R0 = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32)))
    p0, v0 = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32) * 0.5
    g = np.float32([0.2, -0.4, -9.8])
    R1, v1, p1 = (np.asarray(x) for x in jimu.predict_state(R0, v0, p0, jp, z, z, g))
    bg, ba = z, z
    if not at_zero:
        R1 = R1 @ np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.01, 0.03], jnp.float32)))
        p1, v1 = p1 + np.float32([0.01, 0.02, -0.01]), v1 + np.float32([-0.05, 0.02, 0.04])
        bg, ba = np.float32([0.003, -0.002, 0.004]), np.float32([0.05, -0.03, 0.06])
    return tp, jp, (R0, p0, v0, R1, p1, v1, bg, ba, g)


@pytest.mark.parametrize("at_zero", [True, False], ids=["zero_residual", "nonzero_residual"])
def test_imu_residual_and_jacobians_parity(at_zero):
    rng = np.random.default_rng(13)
    tp, jp, (R0, p0, v0, R1, p1, v1, bg, ba, g) = _factor_case(rng, at_zero)

    def jr(x):  # perturb both states and the biases: 24 dofs
        return jres.imu_residual(jp, R0 @ jlie.so3_exp(x[0:3]), p0 + x[3:6], v0 + x[6:9],
                                 R1 @ jlie.so3_exp(x[9:12]), p1 + x[12:15], v1 + x[15:18],
                                 bg + x[18:21], ba + x[21:24], g)

    def tr(x):
        return tres.imu_residual(tp, tlie._mm(T(R0), tlie.so3_exp(x[..., 0:3])), T(p0) + x[..., 3:6],
                                 T(v0) + x[..., 6:9], tlie._mm(T(R1), tlie.so3_exp(x[..., 9:12])),
                                 T(p1) + x[..., 12:15], T(v1) + x[..., 15:18], T(bg) + x[..., 18:21],
                                 T(ba) + x[..., 21:24], T(g))

    r_j, J_j = np.asarray(jr(jnp.zeros(24))), np.asarray(jax.jacfwd(jr)(jnp.zeros(24)))
    r_t, J_t = autodiff.jacfwd(tr, torch.zeros(24))
    assert r_t.dtype == J_t.dtype == torch.float32 and J_t.shape == (9, 24)
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=2e-5)
    assert np.all(np.isfinite(J_t.numpy()))
    if at_zero:
        assert np.abs(r_j).max() < 1e-5
    else:
        assert np.abs(r_j).max() > 1e-2
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9)):
        scale = np.abs(J_j[rows]).max()
        np.testing.assert_allclose(J_t.numpy()[rows], J_j[rows], rtol=0, atol=1e-4 * scale)
    # a scalar gravity means that magnitude along world -z, in both packages
    np.testing.assert_allclose(
        tres.imu_residual(tp, T(R0), T(p0), T(v0), T(R1), T(p1), T(v1), T(bg), T(ba), 9.81).numpy(),
        np.asarray(jres.imu_residual(jp, R0, p0, v0, R1, p1, v1, bg, ba, 9.81)), atol=2e-5)


def test_jacfwd_matches_torch_func_and_keeps_float32():
    """The port's batched forward-mode Jacobian against reverse mode, the
    closed form and `torch.func.jacfwd`. The latter runs the function under
    `vmap`, where "0-d tensor (op) Python number" comes out as float64 in
    PyTorch 2.13 and a float32 matmul then refuses the mix: that is why the
    port does not use it. Where a PyTorch does not do that, the values must
    agree; the port's own Jacobian is float32 either way."""
    w = torch.tensor([0.3, -0.2, 0.1])

    def f(x):
        return tlie.so3_log(tlie._mm(tlie.so3_exp(w), tlie.so3_exp(x)))

    r, J = autodiff.jacfwd(f, torch.zeros(3))
    assert J.dtype == torch.float32
    np.testing.assert_allclose(J.numpy(), torch.autograd.functional.jacobian(f, torch.zeros(3)).numpy(), atol=1e-5)
    try:
        J_func = torch.func.jacfwd(f)(torch.zeros(3))
    except RuntimeError as e:
        assert "Double" in str(e) and "Float" in str(e)
    else:
        np.testing.assert_allclose(J.numpy(), J_func.to(torch.float32).numpy(), atol=1e-5)
    np.testing.assert_allclose(J.numpy(), tlie.so3_right_jacobian_inv(w).numpy(), atol=1e-5)
    np.testing.assert_allclose(r.numpy(), w.numpy(), atol=1e-6)
    # a batch of independent rows: J[b] = d f(x)[b] / d x[b]
    xb = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.2, -0.3]])
    rb, Jb = autodiff.jacfwd(f, xb)
    assert rb.shape == (2, 3) and Jb.shape == (2, 3, 3)
    np.testing.assert_allclose(Jb[0].numpy(), J.numpy(), atol=1e-6)
    np.testing.assert_allclose(Jb[1].numpy(), autodiff.jacfwd(f, xb[1])[1].numpy(), atol=1e-6)
