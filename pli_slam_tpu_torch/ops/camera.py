"""Camera models: pinhole and Kannala-Brandt-8 (port of pli_slam_tpu.ops.camera).

`Camera` holds Python floats, rounded to float32 at construction so that
arithmetic with float32 tensors sees the same values as the reference's
float32 jnp scalars. The model kind is a plain field; functions branch
on it in Python. The stereo visual slice runs pinhole only; KB8's
Jacobian uses `torch.func.jacfwd`, as the reference uses `jax.jacfwd`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1


def _f32(x) -> float:
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Intrinsics; `bf` = baseline * fx (reference Frame `mbf`)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k: tuple = (0.0, 0.0, 0.0, 0.0)
    bf: float = 0.0
    width: int = 752
    height: int = 480
    model: int = PINHOLE

    @staticmethod
    def pinhole(fx, fy, cx, cy, bf=0.0, width=752, height=480) -> "Camera":
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), (0.0,) * 4, _f32(bf), int(width), int(height), PINHOLE)

    @staticmethod
    def kannala_brandt8(fx, fy, cx, cy, k, bf=0.0, width=752, height=480) -> "Camera":
        return Camera(_f32(fx), _f32(fy), _f32(cx), _f32(cy), tuple(_f32(v) for v in k), _f32(bf),
                      int(width), int(height), KANNALA_BRANDT8)

    @property
    def baseline(self) -> float:
        return float(np.float32(self.bf) / np.float32(self.fx))

    def K(self, device=None) -> torch.Tensor:
        """The 3x3 intrinsic matrix, float32."""
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32, device=device)


def _kb8_theta_d(cam: Camera, theta):
    t2 = theta * theta
    k1, k2, k3, k4 = cam.k
    return theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [...,3] -> pixels [...,2]."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    if cam.model == PINHOLE:
        inv_z = 1.0 / _safe_z(z)
        return torch.stack([cam.fx * x * inv_z + cam.cx, cam.fy * y * inv_z + cam.cy], dim=-1)
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    td = _kb8_theta_d(cam, theta)
    scale = td / torch.clamp(r, min=1e-9)
    return torch.stack([cam.fx * x * scale + cam.cx, cam.fy * y * scale + cam.cy], dim=-1)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [...,2] -> unit-depth rays [...,3] (z = 1); KB8 by 8 Newton steps."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    if cam.model == PINHOLE:
        return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)
    td = torch.sqrt(mx * mx + my * my)
    td_c = torch.clamp(td, 0.0, float(np.float32(np.pi / 2.0 * 1.5)))
    th = td_c
    k1, k2, k3, k4 = cam.k
    for _ in range(8):
        t2 = th * th
        f = th * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) - td_c
        df = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
        th = th - f / torch.clamp(df, min=1e-6)
    scale = torch.tan(th) / torch.clamp(td, min=1e-9)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def project_jacobian(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(camera-frame point): [...,2,3]."""
    if cam.model == PINHOLE:
        x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
        inv_z = 1.0 / _safe_z(z)
        inv_z2 = inv_z * inv_z
        zeros = torch.zeros_like(x)
        row0 = torch.stack([cam.fx * inv_z, zeros, -cam.fx * x * inv_z2], dim=-1)
        row1 = torch.stack([zeros, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
        return torch.stack([row0, row1], dim=-2)
    flat = xyz.reshape(-1, 3)
    J = torch.func.vmap(torch.func.jacfwd(lambda p: project(cam, p)))(flat)
    return J.reshape(xyz.shape[:-1] + (2, 3))


def in_image(cam: Camera, uv: torch.Tensor, margin=0.0) -> torch.Tensor:
    """Bounds check [...,2] -> bool[...]; `margin` may be a float or a 0-d tensor."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= margin) & (u < cam.width - margin) & (v >= margin) & (v < cam.height - margin)


def stereo_project(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """[...,3] -> (u_l, v_l, u_r) with u_r = u_l - bf/z."""
    uv = project(cam, xyz)
    ur = uv[..., 0] - cam.bf / _safe_z(xyz[..., 2])
    return torch.cat([uv, ur[..., None]], dim=-1)


def back_project_stereo(cam: Camera, uv: torch.Tensor, disparity: torch.Tensor) -> torch.Tensor:
    z = cam.bf / torch.clamp(disparity, min=1e-6)
    return unproject(cam, uv) * z[..., None]


def depth_from_disparity(cam: Camera, disparity: torch.Tensor) -> torch.Tensor:
    return cam.bf / torch.clamp(disparity, min=1e-6)
