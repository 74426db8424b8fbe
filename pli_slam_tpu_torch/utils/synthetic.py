"""Synthetic stereo-inertial sequence: ray-traced textured room, analytic
trajectory, ideal or corrupted IMU samples, ground-truth depth (port of
pli_slam_tpu.utils.synthetic). Pinhole and Kannala-Brandt8 (fisheye)
cameras; a stereo pair's right view sits `cam.baseline` along the left
camera's +x axis, for either model.

Images are rendered with torch on the CPU and then moved to the device
the caller names, so a GPU run tracks exactly the pixels a CPU run does
(the GPU's `sin` and fused arithmetic round differently and flip some
texture thresholds); `frame_digest` names a frame pair's bits, which
chip_smoke.py holds equal to a CPU build's.
`Trajectory`, the IMU samples, the noise model and `ate_rmse` are numpy,
as in the reference, and give the same numbers bit for bit.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch

from pli_slam_tpu_torch.ops.camera import PINHOLE, Camera, unproject

ROOM_HALF = 6.35


def _value_noise(p: torch.Tensor, seed: float) -> torch.Tensor:
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    freqs = [(1.3, 2.1, 1.7), (2.9, 1.1, 3.3), (5.1, 4.3, 2.2), (8.7, 7.9, 9.4)]
    amps = [0.4, 0.3, 0.2, 0.1]
    phase = seed * 12.9898
    for (fx, fy, fz), a in zip(freqs, amps):
        out = out + a * torch.sin(fx * p[..., 0] + phase) * torch.sin(fy * p[..., 1] + 1.7 * phase) * torch.sin(
            fz * p[..., 2] + 0.3 * phase)
    return 0.5 + 0.5 * out


def _texture(p: torch.Tensor) -> torch.Tensor:
    base = 60.0 + 150.0 * _value_noise(p * 1.0, 0.7)
    speck = _value_noise(p * 4.0, 3.1)
    base = torch.where(speck > 0.62, 235.0, base)
    base = torch.where(speck < 0.38, 35.0, base)

    def gridline(c):
        return torch.abs(c - torch.round(c)) < 0.06

    grid = gridline(p[..., 0]) | gridline(p[..., 1]) | gridline(p[..., 2])
    return torch.where(grid, 15.0, base)


def _trace_room(cam: Camera, R_wc: torch.Tensor, t_wc: torch.Tensor, room_half: float):
    h, w = cam.height, cam.width
    R_wc, t_wc = R_wc.detach().cpu(), t_wc.detach().cpu()
    if cam.model == PINHOLE:
        us = (torch.arange(w, dtype=torch.float32) - cam.cx) / cam.fx
        vs = (torch.arange(h, dtype=torch.float32) - cam.cy) / cam.fy
        dirs_c = torch.stack([us[None, :].expand(h, w), vs[:, None].expand(h, w), torch.ones((h, w))], dim=-1)
    else:  # fisheye (KB8): each pixel's ray by the model's Newton unprojection
        vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32),
                                indexing="ij")
        dirs_c = unproject(cam, torch.stack([uu, vv], dim=-1))
    d_w = torch.einsum("ij,hwj->hwi", R_wc, dirs_c)
    o_w = t_wc
    t_best = torch.full((h, w), 1e9)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            denom = d_w[..., axis]
            t_hit = (sign * room_half - o_w[axis]) / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
            hit = o_w + t_hit[..., None] * d_w
            other = [a for a in range(3) if a != axis]
            inside = ((t_hit > 0.05) & (torch.abs(hit[..., other[0]]) <= room_half + 1e-3)
                      & (torch.abs(hit[..., other[1]]) <= room_half + 1e-3))
            t_best = torch.where(inside & (t_hit < t_best), t_hit, t_best)
    return t_best, o_w + t_best[..., None] * d_w


def render_view(cam: Camera, R_wc: torch.Tensor, t_wc: torch.Tensor, room_half: float = ROOM_HALF) -> torch.Tensor:
    """Ray-trace the room from T_wc (on the CPU). Returns [H, W] float32 in
    [0, 255] on R_wc's device."""
    t_best, p_hit = _trace_room(cam, R_wc, t_wc, room_half)
    img = _texture(p_hit) * (1.0 - 0.015 * torch.clamp(t_best, 0.0, 12.0))
    return torch.clamp(img, 0.0, 255.0).to(R_wc.device)


def render_depth(cam: Camera, R_wc: torch.Tensor, t_wc: torch.Tensor, room_half: float = ROOM_HALF) -> torch.Tensor:
    """Ground-truth camera-z depth [H, W] on R_wc's device (pinhole rays
    have z = 1, so the ray parameter is the depth); 0 where no surface is hit."""
    t_best, _ = _trace_room(cam, R_wc, t_wc, room_half)
    return torch.where(t_best < 1e8, t_best, torch.zeros_like(t_best)).to(R_wc.device)


def frame_digest(*images: torch.Tensor) -> str:
    """SHA-256 of the images' float32 bytes, in order (a frame pair's bits)."""
    h = hashlib.sha256()
    for img in images:
        h.update(img.detach().cpu().to(torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Analytic smooth trajectory inside the room: p(t), R(t)."""

    amp: tuple = (1.8, 1.2, 0.6)
    freq: tuple = (0.25, 0.31, 0.17)
    yaw_amp: float = 0.5
    yaw_freq: float = 0.2

    def pose(self, t: float):
        """(R_wb [3,3], p_w [3]); camera z forward."""
        ax, ay, az = self.amp
        fx, fy, fz = self.freq
        p = np.array([
            ax * math.sin(2 * math.pi * fx * t),
            ay * math.sin(2 * math.pi * fy * t + 1.0),
            az * math.sin(2 * math.pi * fz * t + 2.0),
        ])
        yaw = self.yaw_amp * math.sin(2 * math.pi * self.yaw_freq * t)
        pitch = 0.15 * math.sin(2 * math.pi * 0.13 * t + 0.5)
        cy, sy = math.cos(yaw), math.sin(yaw)
        cp, sp = math.cos(pitch), math.sin(pitch)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        return Ry @ Rx, p

    def velocity(self, t: float, eps: float = 1e-4):
        _, p0 = self.pose(t - eps)
        _, p1 = self.pose(t + eps)
        return (p1 - p0) / (2 * eps)

    def imu_sample(self, t: float, gravity: float = 9.81, eps: float = 1e-3):
        """Ideal gyro (body rates) and accel (specific force in the body frame)."""
        R0, _ = self.pose(t - eps)
        R1, _ = self.pose(t + eps)
        Rm, _ = self.pose(t)
        dR = R0.T @ R1
        cos_a = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
        ang = np.arccos(cos_a)
        vee = 0.5 * np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
        w = vee if ang < 1e-6 else vee * (ang / np.sin(ang))
        w = w / (2 * eps)
        v0 = self.velocity(t - eps)
        v1 = self.velocity(t + eps)
        a_w = (v1 - v0) / (2 * eps)
        g = np.array([0.0, 0.0, -gravity])
        a_b = Rm.T @ (a_w - g)  # specific force
        return w.astype(np.float32), a_b.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ImuNoiseModel:
    """Additive IMU corruption: white noise + constant bias + bias random
    walk. Continuous-time densities, discretized at the sample rate
    (sigma_d = sigma_c * sqrt(rate); walk step = walk_c * sqrt(dt))."""

    noise_gyro: float = 1.7e-4  # rad/s/sqrt(Hz)
    noise_acc: float = 2.0e-3  # m/s^2/sqrt(Hz)
    walk_gyro: float = 1.94e-5  # rad/s^2/sqrt(Hz)
    walk_acc: float = 3.0e-3  # m/s^3/sqrt(Hz)
    bg0: tuple = (0.003, -0.002, 0.004)  # constant gyro bias, rad/s
    ba0: tuple = (0.05, -0.03, 0.06)  # constant accel bias, m/s^2
    seed: int = 0

    @staticmethod
    def euroc() -> "ImuNoiseModel":
        """The EuRoC noise operating point."""
        return ImuNoiseModel()


class _ImuCorruptor:
    """Stateful sampler: applies an ImuNoiseModel to ideal samples,
    integrating the bias random walk across calls (chronological)."""

    def __init__(self, model: ImuNoiseModel, rate_hz: float):
        self.m = model
        self.rng = np.random.default_rng(model.seed)
        self.sq_rate = math.sqrt(rate_hz)
        self.sq_dt = math.sqrt(1.0 / rate_hz)
        self.bg = np.asarray(model.bg0, np.float32).copy()
        self.ba = np.asarray(model.ba0, np.float32).copy()

    def __call__(self, gyro: np.ndarray, acc: np.ndarray):
        m = self.m
        g = gyro + self.bg + (m.noise_gyro * self.sq_rate) * self.rng.standard_normal(3)
        a = acc + self.ba + (m.noise_acc * self.sq_rate) * self.rng.standard_normal(3)
        self.bg = self.bg + (m.walk_gyro * self.sq_dt) * self.rng.standard_normal(3)
        self.ba = self.ba + (m.walk_acc * self.sq_dt) * self.rng.standard_normal(3)
        return g.astype(np.float32), a.astype(np.float32)


def make_sequence(cam: Camera, n_frames: int, device=None, fps: float = 20.0, traj: Trajectory | None = None,
                  imu_rate: float = 200.0, room_half: float = ROOM_HALF, with_depth: bool = False,
                  Tbc: np.ndarray | None = None, imu_noise: ImuNoiseModel | None = None):
    """Yield per-frame dicts {t, img_l, img_r (and `depth` with `with_depth`:
    tensors on `device`), R_wc, p_w, v_w, imu_stamps, imu_gyro, imu_acc
    (numpy)}. The images are rendered on the CPU and moved to `device`
    (`None` = the GPU; pass "cpu" to keep them there).
    The right camera sits `baseline` along the camera's +x axis; the IMU
    batch covers (t_prev, t].

    With `Tbc` (4x4 body->camera transform), `traj` describes the BODY (IMU)
    trajectory and the rendered camera rides at T_wc = T_wb * Tbc. IMU
    samples are always in the body frame."""
    device = torch.device("cuda" if device is None else device)
    traj = traj or Trajectory()
    baseline = cam.baseline
    n_imu = int(round(imu_rate / fps))
    corrupt = _ImuCorruptor(imu_noise, imu_rate) if imu_noise is not None else None
    R_bc = np.eye(3, dtype=np.float32) if Tbc is None else np.asarray(Tbc, np.float32)[:3, :3]
    t_bc = np.zeros(3, np.float32) if Tbc is None else np.asarray(Tbc, np.float32)[:3, 3]
    for k in range(n_frames):
        t = k / fps
        R_wb, p_wb = traj.pose(t)
        R_wc = R_wb @ R_bc
        p_w = p_wb + R_wb @ t_bc
        R = torch.as_tensor(R_wc, dtype=torch.float32)
        p = torch.as_tensor(p_w, dtype=torch.float32)
        stamps = t - (np.arange(n_imu)[::-1]) / imu_rate
        gyro = np.zeros((n_imu, 3), np.float32)
        acc = np.zeros((n_imu, 3), np.float32)
        for i, ts in enumerate(stamps):
            gyro[i], acc[i] = traj.imu_sample(max(ts, 0.0))
            if corrupt is not None:
                gyro[i], acc[i] = corrupt(gyro[i], acc[i])
        yield {
            "t": t,
            "img_l": render_view(cam, R, p, room_half).to(device),
            "img_r": render_view(cam, R, p + R[:, 0] * baseline, room_half).to(device),
            **({"depth": render_depth(cam, R, p, room_half).to(device)} if with_depth else {}),
            "R_wc": np.asarray(R_wc, np.float32),
            "p_w": np.asarray(p_w, np.float32),
            "v_w": traj.velocity(t).astype(np.float32),
            "imu_stamps": stamps.astype(np.float32),
            "imu_gyro": gyro,
            "imu_acc": acc,
        }


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray) -> float:
    """Absolute trajectory error after SE(3) (Umeyama, no scale) alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    E = est - est.mean(0)
    G = gt - gt.mean(0)
    U, _, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    t = gt.mean(0) - R @ est.mean(0)
    aligned = est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
