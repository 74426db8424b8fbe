"""Trajectory writers, readers and error metrics in the TUM, EuRoC and KITTI
formats (port of pli_slam_tpu.utils.trajectory).

Poses are (stamp_seconds, R_wc [3,3], p_w [3]), camera to world. The
quaternions go through ops.lie in float32 on the CPU, as the reference's
go through its float32 jnp helpers.
"""

from __future__ import annotations

import numpy as np
import torch

from pli_slam_tpu_torch.ops import lie


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    return lie.quat_from_rotation(torch.as_tensor(np.asarray(R), dtype=torch.float32)).numpy()


def _rotation(q_wxyz) -> np.ndarray:
    return lie.rotation_from_quat(torch.tensor(q_wxyz, dtype=torch.float32)).numpy()


def save_tum(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """TUM: `stamp tx ty tz qx qy qz qw` per line."""
    with open(path, "w") as f:
        for stamp, R, p in traj:
            w, x, y, z = _quat_wxyz(R)
            f.write(f"{stamp:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} {x:.7f} {y:.7f} {z:.7f} {w:.7f}\n")


def save_euroc(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """EuRoC: `stamp_ns, tx, ty, tz, qw, qx, qy, qz` per line."""
    with open(path, "w") as f:
        for stamp, R, p in traj:
            w, x, y, z = _quat_wxyz(R)
            f.write(f"{int(stamp*1e9)},{p[0]:.7f},{p[1]:.7f},{p[2]:.7f},{w:.7f},{x:.7f},{y:.7f},{z:.7f}\n")


def save_kitti(path: str, traj: list[tuple[float, np.ndarray, np.ndarray]]) -> None:
    """KITTI: the 12 numbers of the row-major [R|t] per line."""
    with open(path, "w") as f:
        for _, R, p in traj:
            T = np.hstack([R, p.reshape(3, 1)])
            f.write(" ".join(f"{v:.9e}" for v in T.reshape(-1)) + "\n")


def load_tum(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            stamp, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            out.append((stamp, _rotation([qw, qx, qy, qz]), np.array([tx, ty, tz])))
    return out


def load_euroc(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """The EuRoC CSV that save_euroc writes."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.split(",")]
            stamp_ns, tx, ty, tz, qw, qx, qy, qz = vals[:8]
            out.append((stamp_ns * 1e-9, _rotation([qw, qx, qy, qz]), np.array([tx, ty, tz])))
    return out


def load_kitti(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """Parse the KITTI 12-number [R|t] format (stamps are row indices)."""
    out = []
    with open(path) as f:
        for i, line in enumerate(f):
            if not line.strip():
                continue
            T = np.array([float(v) for v in line.split()]).reshape(3, 4)
            out.append((float(i), T[:, :3].copy(), T[:, 3].copy()))
    return out


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """SE(3)/Sim(3) alignment est->gt. Returns (s, R, t)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(E.T @ G)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T
    s = float((D * np.diag(S)).sum() / (E ** 2).sum()) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> float:
    s, R, t = align_umeyama(est, gt, with_scale)
    aligned = s * est @ R.T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


def rpe_rmse(
    est_traj: list[tuple[float, np.ndarray, np.ndarray]],
    gt_traj: list[tuple[float, np.ndarray, np.ndarray]],
    delta: int = 1,
) -> tuple[float, float]:
    """Relative pose error over index offset `delta`: (trans_rmse, rot_rmse_deg)."""
    terrs, rerrs = [], []
    n = min(len(est_traj), len(gt_traj))
    for i in range(n - delta):
        _, Re0, pe0 = est_traj[i]
        _, Re1, pe1 = est_traj[i + delta]
        _, Rg0, pg0 = gt_traj[i]
        _, Rg1, pg1 = gt_traj[i + delta]
        d_est_t = Re0.T @ (pe1 - pe0)
        d_gt_t = Rg0.T @ (pg1 - pg0)
        terrs.append(np.linalg.norm(d_est_t - d_gt_t))
        dR = (Rg0.T @ Rg1).T @ (Re0.T @ Re1)
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        rerrs.append(np.degrees(ang))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(np.sqrt(np.mean(np.square(rerrs))))
