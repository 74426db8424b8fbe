"""Write rendered sequences in the on-disk layouts of EuRoC (ASL), TUM RGB-D
and KITTI odometry, with a reference-style YAML for EuRoC: the fixtures of
the drivers' tests and of chip_smoke.py's phase 9, where no dataset is in
the repository.

Frames are the dicts of `utils.synthetic.make_sequence` (images as
tensors or arrays in [0, 255]; `p_w` / `R_wc` the camera's pose in the
room). Images are quantised to 8 bits as a camera's are (`to_uint8`).
Stamps are written as exact integers: EuRoC's in ns, the IMU's on the
sample grid of `imu_rate`, so each frame's slice (previous frame, frame]
holds exactly that frame's samples.
"""

from __future__ import annotations

import os

import numpy as np

from pli_slam_tpu_torch.utils.pngio import write_png


def to_uint8(img) -> np.ndarray:
    """An image in [0, 255] rounded to 8 bits."""
    a = img.detach().cpu().numpy() if hasattr(img, "detach") else np.asarray(img)
    return np.clip(np.rint(a), 0, 255).astype(np.uint8)


def quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) of a rotation matrix."""
    R = np.asarray(R, np.float64)
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = np.copysign(np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0, R[1, 0] - R[0, 1])
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _f(v) -> str:
    """A float32 value's shortest round-trip text."""
    return repr(float(np.float32(v)))


def write_euroc(root: str, frames: list[dict], fps: float, imu_rate: float = 200.0,
                filter_type: int | None = 0) -> list[int]:
    """<root>/mav0/{cam0,cam1}/data/<ns>.png with data.csv, imu0/data.csv
    (each frame's samples) and state_groundtruth_estimate0/data.csv.
    Frame k is stamped k / fps. Returns the frame stamps (ns)."""
    mav = os.path.join(root, "mav0")
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(mav, cam, "data"), exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)
    frame_ns = int(round(1e9 / fps))
    imu_ns = int(round(1e9 / imu_rate))
    stamps, imu_rows, gt_rows = [], [], []
    for k, fr in enumerate(frames):
        ns = k * frame_ns
        stamps.append(ns)
        for cam, key in (("cam0", "img_l"), ("cam1", "img_r")):
            write_png(os.path.join(mav, cam, "data", f"{ns}.png"), to_uint8(fr[key]), filter_type)
        n = len(fr["imu_gyro"])
        for j in range(n):
            g, a = fr["imu_gyro"][j], fr["imu_acc"][j]
            imu_rows.append(f"{ns - (n - 1 - j) * imu_ns}," + ",".join(_f(v) for v in (*g, *a)))
        q = quat_wxyz(fr["R_wc"])
        gt_rows.append(f"{ns}," + ",".join(repr(float(v)) for v in (*fr["p_w"], *q)))
    for cam in ("cam0", "cam1"):
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "".join(f"{ns},{ns}.png\n" for ns in stamps))
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],w_RS_S_z [rad s^-1],"
                "a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],a_RS_S_z [m s^-2]\n" + "\n".join(imu_rows) + "\n")
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []\n"
                + "\n".join(gt_rows) + "\n")
    return stamps


def write_euroc_yaml(path: str, cam, cfg, Tbc=None) -> None:
    """A reference-style (OpenCV FileStorage) YAML with the camera as scalars
    (no rectification blocks: the images are already rectified), Tbc, the
    IMU noise, the feature switches and the ORB budgets of `cfg`."""
    T = np.eye(4) if Tbc is None else np.asarray(Tbc, np.float64).reshape(4, 4)
    o, imu = cfg.orb, cfg.imu
    lines = [
        "%YAML:1.0",
        'Camera.type: "PinHole"',
        f"Camera.fx: {cam.fx!r}", f"Camera.fy: {cam.fy!r}", f"Camera.cx: {cam.cx!r}", f"Camera.cy: {cam.cy!r}",
        "Camera.k1: 0.0", "Camera.k2: 0.0", "Camera.p1: 0.0", "Camera.p2: 0.0",
        f"Camera.width: {cam.width}", f"Camera.height: {cam.height}", f"Camera.fps: {cfg.fps!r}",
        f"Camera.bf: {cam.bf!r}", "Camera.RGB: 1", "ThDepth: 35.0",
        f"has_points: {int(cfg.use_points)}", f"has_lines: {int(cfg.use_lines)}",
        "Tbc: !!opencv-matrix", "   rows: 4", "   cols: 4", "   dt: f",
        "   data: [" + ", ".join(repr(float(v)) for v in T.reshape(-1)) + "]",
        f"IMU.NoiseGyro: {imu.noise_gyro!r}", f"IMU.NoiseAcc: {imu.noise_acc!r}",
        f"IMU.GyroWalk: {imu.walk_gyro!r}", f"IMU.AccWalk: {imu.walk_acc!r}", f"IMU.Frequency: {imu.rate_hz!r}",
        f"ORBextractor.nFeatures: {o.n_features}", f"ORBextractor.scaleFactor: {o.scale_factor!r}",
        f"ORBextractor.nLevels: {o.n_levels}", f"ORBextractor.iniThFAST: {o.fast_threshold}",
        f"ORBextractor.minThFAST: {o.fast_min_threshold}",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_tum(root: str, frames: list[dict], fps: float) -> list[float]:
    """<root>/rgb/<t>.png (8-bit RGB, the gray image in every channel) for
    t = 1 + k / fps, depth/<t + 0.004>.png (16-bit, metres x 5000, TUM's
    DepthMapFactor: 4 ms apart, as a real sensor pair, for `associate` to
    bridge), rgb.txt, depth.txt and groundtruth.txt. Returns the rgb stamps."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rgb_lines, depth_lines, gt_lines, stamps = [], [], [], []
    for k, fr in enumerate(frames):
        t = 1.0 + k / fps
        td = t + 0.004
        gray = to_uint8(fr["img_l"])
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"), np.repeat(gray[..., None], 3, axis=2))
        d = fr["depth"].detach().cpu().numpy() if hasattr(fr["depth"], "detach") else np.asarray(fr["depth"])
        write_png(os.path.join(root, "depth", f"{td:.6f}.png"),
                  np.clip(np.rint(d * 5000.0), 0, 65535).astype(np.uint16))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{td:.6f} depth/{td:.6f}.png")
        q = quat_wxyz(fr["R_wc"])
        gt_lines.append(f"{t:.6f} " + " ".join(repr(float(v)) for v in (*fr["p_w"], q[1], q[2], q[3], q[0])))
        stamps.append(float(f"{t:.6f}"))
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("# color images\n# timestamp filename\n" + "\n".join(rgb_lines) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("# depth maps\n# timestamp filename\n" + "\n".join(depth_lines) + "\n")
    with open(os.path.join(root, "groundtruth.txt"), "w") as f:
        f.write("# ground truth trajectory\n# timestamp tx ty tz qx qy qz qw\n" + "\n".join(gt_lines) + "\n")
    return stamps


def write_kitti(root: str, frames: list[dict], fps: float, fx: float, fy: float, cx: float, cy: float,
                baseline: float) -> None:
    """<root>/image_0/%06d.png, image_1/%06d.png (8-bit gray), times.txt,
    calib.txt (P0 / P1 as KITTI writes them, P1[0,3] = -fx * baseline) and
    poses.txt (each camera's pose in the first camera's frame, 3x4 rows)."""
    os.makedirs(os.path.join(root, "image_0"), exist_ok=True)
    os.makedirs(os.path.join(root, "image_1"), exist_ok=True)
    R0, p0 = np.asarray(frames[0]["R_wc"], np.float64), np.asarray(frames[0]["p_w"], np.float64)
    poses, times = [], []
    for k, fr in enumerate(frames):
        write_png(os.path.join(root, "image_0", f"{k:06d}.png"), to_uint8(fr["img_l"]))
        write_png(os.path.join(root, "image_1", f"{k:06d}.png"), to_uint8(fr["img_r"]))
        R = R0.T @ np.asarray(fr["R_wc"], np.float64)
        t = R0.T @ (np.asarray(fr["p_w"], np.float64) - p0)
        poses.append(" ".join(f"{v:.9e}" for v in np.concatenate([R, t[:, None]], axis=1).reshape(-1)))
        times.append(f"{k / fps:.6e}")
    P = lambda tx: " ".join(f"{v:.12e}" for v in (fx, 0.0, cx, tx, 0.0, fy, cy, 0.0, 0.0, 0.0, 1.0, 0.0))  # noqa: E731
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P0: {P(0.0)}\nP1: {P(-fx * baseline)}\nP2: {P(0.0)}\nP3: {P(-fx * baseline)}\n")
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(times) + "\n")
    with open(os.path.join(root, "poses.txt"), "w") as f:
        f.write("\n".join(poses) + "\n")
