"""IMU preintegration on the SO(3) manifold (port of pli_slam_tpu.ops.imu).

The measurement batch is a fixed-capacity padded array (the mask selects
real samples), float32 throughout, state ordering (phi, v, p) in the
covariance, as in the reference. The reference's `lax.scan` is a Python
loop over the T samples in the same order; what does not depend on the
carried state (bias-corrected samples, the per-sample rotation increment
and its right Jacobian, the noise term's diagonal) is computed for all T
samples at once before the loop, so the loop holds only the recurrence.

`Preintegrated` is a frozen dataclass of tensors; a stacked chain carries
a leading [K] axis on every leaf. The bias-corrected deltas broadcast over
leading axes, so the IMU factor evaluates a whole chain, or a batch of
perturbed states, in one call (see ops.autodiff).
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.utils.config import ImuConfig


@dataclasses.dataclass(frozen=True)
class Preintegrated:
    """Preintegrated IMU deltas between two frames/keyframes."""

    dt: torch.Tensor  # [] total time
    dR: torch.Tensor  # [3,3]
    dV: torch.Tensor  # [3]
    dP: torch.Tensor  # [3]
    cov: torch.Tensor  # [9,9] covariance of (phi, v, p)
    JRg: torch.Tensor  # [3,3] d(dR)/d(bg)
    JVg: torch.Tensor  # [3,3]
    JVa: torch.Tensor  # [3,3]
    JPg: torch.Tensor  # [3,3]
    JPa: torch.Tensor  # [3,3]
    bg: torch.Tensor  # [3] gyro bias used at integration time
    ba: torch.Tensor  # [3] accel bias used

    @staticmethod
    def identity(device=None) -> "Preintegrated":
        z3 = torch.zeros(3, device=device)
        z33 = torch.zeros((3, 3), device=device)
        return Preintegrated(
            dt=torch.zeros((), device=device), dR=torch.eye(3, device=device), dV=z3, dP=z3,
            cov=torch.zeros((9, 9), device=device),
            JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33, bg=z3, ba=z3,
        )

    def leaves(self) -> tuple:
        """The fields in declaration order."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _map(fn, *ps: Preintegrated) -> Preintegrated:
    return Preintegrated(*(fn(*xs) for xs in zip(*(p.leaves() for p in ps))))


def identity_with_bias(bg: torch.Tensor, ba: torch.Tensor) -> Preintegrated:
    """Identity accumulator linearized at the CURRENT biases: composing
    onto it is exact (compose corrects the appended segment to the
    accumulator's linearization bias)."""
    return dataclasses.replace(Preintegrated.identity(bg.device), bg=bg, ba=ba)


@dataclasses.dataclass(frozen=True)
class PreintStore:
    """Per-keyframe preintegration chain on the device: slot k holds the
    composed factor spanning KF k-1 -> KF k."""

    data: Preintegrated  # every leaf carries a leading [K] axis
    valid: torch.Tensor  # [K] bool

    @staticmethod
    def empty(capacity: int, device=None) -> "PreintStore":
        data = _map(lambda x: x.expand((capacity,) + x.shape).clone(), Preintegrated.identity(device))
        return PreintStore(data=data, valid=torch.zeros(capacity, dtype=torch.bool, device=device))

    def set(self, k: int, p: Preintegrated, valid=True) -> "PreintStore":
        """Slot `k` (a host int) <- `p`; `valid` is a bool or a 0-d bool tensor."""

        def put(A, x):
            A = A.clone()
            A[k] = x
            return A

        return PreintStore(data=_map(put, self.data, p), valid=put(self.valid, valid))

    def gather(self, idx: torch.Tensor) -> Preintegrated:
        idx = idx.long()
        return _map(lambda A: A[idx], self.data)

    def remap(self, kf_slots) -> "PreintStore":
        """Re-index through a merge's src -> dst keyframe slot map (-1 =
        dropped). A factor spans KF k-1 -> k, so it survives only where
        both endpoints stayed adjacent in the merged map."""
        K = self.valid.shape[0]
        dev = self.valid.device
        slots = torch.as_tensor(kf_slots, device=dev).to(torch.int64)
        if slots.shape[0] < K:
            slots = torch.cat([slots, torch.full((K - slots.shape[0],), -1, dtype=torch.int64, device=dev)])
        prev = torch.cat([torch.full((1,), -2, dtype=torch.int64, device=dev), slots[:-1]])
        keep = self.valid & (slots >= 1) & (prev == slots - 1)
        dst = torch.clamp(torch.where(keep, slots, torch.full_like(slots, K - 1)), 0, K - 1)

        def scat(A):
            m = keep.reshape((-1,) + (1,) * (A.ndim - 1))
            return torch.zeros_like(A).index_add_(0, dst, torch.where(m, A, torch.zeros_like(A)))

        valid = torch.zeros(K, dtype=torch.int32, device=dev).scatter_reduce(0, dst, keep.to(torch.int32), "amax") > 0
        return PreintStore(data=_map(scat, self.data), valid=valid)


def preintegrate(gyro, acc, dts, mask, bg, ba, cfg: ImuConfig) -> Preintegrated:
    """Integrate a padded batch of IMU midpoint samples: gyro [T,3] rad/s,
    acc [T,3] m/s^2, dts [T] s, mask [T] bool, biases [3]. Masked-out
    samples are dt = 0 no-ops, so T is static whatever landed between two
    frames."""
    dev, dtype = gyro.device, gyro.dtype
    noise_g2 = (cfg.noise_gyro ** 2) * cfg.rate_hz  # discrete: sigma^2 / dt, folded below
    noise_a2 = (cfg.noise_acc ** 2) * cfg.rate_hz
    T = gyro.shape[0]

    # per-sample terms that do not depend on the carried state
    dt_all = torch.where(mask, dts, torch.zeros_like(dts))
    w_all = gyro - bg
    a_all = acc - ba
    wdt = w_all * dt_all[:, None]
    dRi_all = lie.so3_exp(wdt)
    Jr_all = lie.so3_right_jacobian(wdt)
    a_hat_all = lie.hat(a_all)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    nga_all = torch.cat([(noise_g2 * dt_all)[:, None].expand(T, 3), (noise_a2 * dt_all)[:, None].expand(T, 3)], dim=1)

    dR = eye3
    dV = torch.zeros(3, dtype=dtype, device=dev)
    dP = torch.zeros(3, dtype=dtype, device=dev)
    cov = torch.zeros((9, 9), dtype=dtype, device=dev)
    JRg = JVg = JVa = JPg = JPa = torch.zeros((3, 3), dtype=dtype, device=dev)
    t = torch.zeros((), dtype=dtype, device=dev)
    for i in range(T):
        dt, a, dRi, Jr, a_hat = dt_all[i], a_all[i], dRi_all[i], Jr_all[i], a_hat_all[i]
        # position/velocity use the CURRENT rotation (dP/dV before the new dR)
        a_rot = lie._einsum("ij,j->i", dR, a)
        dP_new = dP + dV * dt + 0.5 * a_rot * dt * dt
        dV_new = dV + a_rot * dt

        # covariance propagation: A is the transition, B maps (eta_g, eta_a)
        dRa = lie._mm(dR, a_hat)
        A = torch.eye(9, dtype=dtype, device=dev)
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -dRa * dt
        A[6:9, 0:3] = -0.5 * dRa * dt * dt
        A[6:9, 3:6] = eye3 * dt
        B = torch.zeros((9, 6), dtype=dtype, device=dev)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt * dt
        cov_new = lie._mm(lie._mm(A, cov), A.T) + lie._mm(B * nga_all[i][None, :], B.T)

        dRaJ = lie._mm(dRa, JRg)
        JPa_new = JPa + JVa * dt - 0.5 * dR * dt * dt
        JPg_new = JPg + JVg * dt - 0.5 * dRaJ * dt * dt
        JVa_new = JVa - dR * dt
        JVg_new = JVg - dRaJ * dt
        JRg_new = lie._mm(dRi.T, JRg) - Jr * dt

        dR = lie._mm(dR, dRi)
        dV, dP, cov = dV_new, dP_new, cov_new
        JRg, JVg, JVa, JPg, JPa = JRg_new, JVg_new, JVa_new, JPg_new, JPa_new
        t = t + dt
    return Preintegrated(dt=t, dR=lie.normalize_rotation(dR), dV=dV, dP=dP, cov=cov,
                         JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bg=bg, ba=ba)


def _mv(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return lie._einsum("...ij,...j->...i", M, x)


def delta_rotation(p: Preintegrated, bg: torch.Tensor) -> torch.Tensor:
    """Bias-corrected dR. Like the two below it takes leading batch axes on
    either side (a stacked chain, a batch of biases) and broadcasts them."""
    return lie._mm(p.dR, lie.so3_exp(_mv(p.JRg, bg - p.bg)))


def delta_velocity(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dV + _mv(p.JVg, bg - p.bg) + _mv(p.JVa, ba - p.ba)


def delta_position(p: Preintegrated, bg, ba) -> torch.Tensor:
    return p.dP + _mv(p.JPg, bg - p.bg) + _mv(p.JPa, ba - p.ba)


def compose(a: Preintegrated, b: Preintegrated) -> Preintegrated:
    """Merge two consecutive preintegrations (a, then b) into one:
    first-order exact in noise and bias. b's deltas are corrected to a's
    linearization bias through its own bias Jacobians, then chained."""
    dRb = delta_rotation(b, a.bg)
    dVb = delta_velocity(b, a.bg, a.ba)
    dPb = delta_position(b, a.bg, a.ba)
    dtb = b.dt
    dR = lie._mm(a.dR, dRb)
    dV = a.dV + lie._einsum("ij,j->i", a.dR, dVb)
    dP = a.dP + a.dV * dtb + lie._einsum("ij,j->i", a.dR, dPb)

    aRhV = lie._mm(a.dR, lie.hat(dVb))
    aRhP = lie._mm(a.dR, lie.hat(dPb))
    JRg = lie._mm(dRb.T, a.JRg) + b.JRg
    JVg = a.JVg - lie._mm(aRhV, a.JRg) + lie._mm(a.dR, b.JVg)
    JVa = a.JVa + lie._mm(a.dR, b.JVa)
    JPg = a.JPg + a.JVg * dtb - lie._mm(aRhP, a.JRg) + lie._mm(a.dR, b.JPg)
    JPa = a.JPa + a.JVa * dtb + lie._mm(a.dR, b.JPa)

    # T transports a's (phi, v, p) error across segment b; S rotates b's own
    # error into the composite frame
    I3 = lie._eye3(dR)
    Z3 = torch.zeros_like(I3)
    T = torch.cat([
        torch.cat([dRb.T, Z3, Z3], dim=1),
        torch.cat([-aRhV, I3, Z3], dim=1),
        torch.cat([-aRhP, I3 * dtb, I3], dim=1),
    ], dim=0)
    S = torch.block_diag(I3, a.dR, a.dR)
    cov = lie._mm(lie._mm(T, a.cov), T.T) + lie._mm(lie._mm(S, b.cov), S.T)
    return Preintegrated(dt=a.dt + b.dt, dR=lie.normalize_rotation(dR), dV=dV, dP=dP, cov=cov,
                         JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa, bg=a.bg, ba=a.ba)


def gravity_vector(gravity, like: torch.Tensor) -> torch.Tensor:
    """`gravity` as a world vector [..., 3] on `like`'s device: a magnitude acts along world -z."""
    if isinstance(gravity, torch.Tensor) and gravity.ndim > 0:
        return gravity
    return torch.tensor([0.0, 0.0, -1.0], dtype=like.dtype, device=like.device) * gravity


def predict_state(Rwb0, vw0, pw0, p: Preintegrated, bg, ba, gravity=9.81):
    """Dead-reckon the body state across the preintegration window.
    `gravity` is a magnitude (acts along world -z) or a world vector [3]."""
    g = gravity_vector(gravity, Rwb0)
    dt = p.dt
    dR = delta_rotation(p, bg)
    dV = delta_velocity(p, bg, ba)
    dP = delta_position(p, bg, ba)
    Rwb1 = lie.normalize_rotation(lie._mm(Rwb0, dR))
    vw1 = vw0 + g * dt + lie._einsum("ij,j->i", Rwb0, dV)
    pw1 = pw0 + vw0 * dt + 0.5 * g * dt * dt + lie._einsum("ij,j->i", Rwb0, dP)
    return Rwb1, vw1, pw1


def midpoint_samples(gyro_raw, acc_raw, stamps, t0, t1, mask_raw):
    """Average consecutive raw samples into midpoint measurements covering
    [t0, t1]: [T] raw samples with a validity mask in, [T-1] midpoint
    samples out, dt clipped to the frame interval."""
    g_mid = 0.5 * (gyro_raw[:-1] + gyro_raw[1:])
    a_mid = 0.5 * (acc_raw[:-1] + acc_raw[1:])
    seg_a = torch.clamp(stamps[:-1], min=t0)
    seg_b = torch.clamp(stamps[1:], max=t1)
    dts = torch.clamp(seg_b - seg_a, min=0.0)
    m = mask_raw[:-1] & mask_raw[1:] & (dts > 0)
    return g_mid, a_mid, dts, m
