"""Synthetic stereo sequence: ray-traced textured room, analytic trajectory
(port of pli_slam_tpu.utils.synthetic without the IMU noise model).

Images are rendered with torch on the given device, so the port's
end-to-end runs need no JAX. `Trajectory` and `ate_rmse` are numpy, as
in the reference.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pli_slam_tpu_torch.ops.camera import PINHOLE, Camera

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
    if cam.model != PINHOLE:
        raise NotImplementedError("the port's renderer draws pinhole views only")
    h, w = cam.height, cam.width
    dev = R_wc.device
    us = (torch.arange(w, dtype=torch.float32, device=dev) - cam.cx) / cam.fx
    vs = (torch.arange(h, dtype=torch.float32, device=dev) - cam.cy) / cam.fy
    dirs_c = torch.stack([us[None, :].expand(h, w), vs[:, None].expand(h, w), torch.ones((h, w), device=dev)], dim=-1)
    d_w = torch.einsum("ij,hwj->hwi", R_wc, dirs_c)
    o_w = t_wc
    t_best = torch.full((h, w), 1e9, device=dev)
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
    """Ray-trace the room from T_wc. Returns [H, W] float32 in [0, 255]."""
    t_best, p_hit = _trace_room(cam, R_wc, t_wc, room_half)
    img = _texture(p_hit) * (1.0 - 0.015 * torch.clamp(t_best, 0.0, 12.0))
    return torch.clamp(img, 0.0, 255.0)


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


def make_sequence(cam: Camera, n_frames: int, device, fps: float = 20.0, traj: Trajectory | None = None,
                  room_half: float = ROOM_HALF):
    """Yield per-frame dicts {t, img_l, img_r (tensors on `device`), R_wc, p_w (numpy)}.
    The right camera sits `baseline` along the camera's +x axis."""
    traj = traj or Trajectory()
    baseline = cam.baseline
    for k in range(n_frames):
        t = k / fps
        R_wc, p_w = traj.pose(t)
        R = torch.as_tensor(R_wc, dtype=torch.float32, device=device)
        p = torch.as_tensor(p_w, dtype=torch.float32, device=device)
        yield {
            "t": t,
            "img_l": render_view(cam, R, p, room_half),
            "img_r": render_view(cam, R, p + R[:, 0] * baseline, room_half),
            "R_wc": np.asarray(R_wc, np.float32),
            "p_w": np.asarray(p_w, np.float32),
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
