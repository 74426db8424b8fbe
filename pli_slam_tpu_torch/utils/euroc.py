"""EuRoC MAV dataset loader: stereo images, IMU and ground truth (port of
pli_slam_tpu.utils.euroc).

Layout (ASL): <root>/mav0/cam0/data/<ns>.png, cam1/data/<ns>.png,
imu0/data.csv (ns, gyro xyz, acc xyz) and, when present,
state_groundtruth_estimate0/data.csv (ns, position, quaternion wxyz, ...).
Frames carry the RAW (distorted) images; pass a rectifier
(`ops.rectify.euroc_rectifier()`, or the one `load_yaml_full` builds) to
the System / Tracker to undistort and rectify on the device.

PNGs are decoded by the port's native decoder (`utils.native_loader`), never by
pillow, and `frames_native` decodes them ahead on C++ worker threads. The
reference falls back to pillow when its native library cannot be built;
the port raises instead.
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np

from pli_slam_tpu_torch.utils import native_loader


def _read_png(path: str) -> np.ndarray:
    """The image as pillow's `np.asarray(..., dtype=np.float32)` gives it."""
    return native_loader.read_png(path).astype(np.float32)


@dataclasses.dataclass
class EurocCalib:
    """Rectified stereo calibration (the reference's EuRoC.yaml)."""

    fx: float = 435.2046959714599
    fy: float = 435.2046959714599
    cx: float = 367.4517211914062
    cy: float = 252.2008514404297
    bf: float = 47.90639384423901
    width: int = 752
    height: int = 480


def _read_csv_rows(path: str, n_cols: int | None = None) -> np.ndarray:
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if row and not row[0].startswith("#"):
                rows.append([float(v) for v in (row[:n_cols] if n_cols else row)])
    return np.asarray(rows)


class EurocSequence:
    def __init__(self, root: str):
        self.root = root
        mav = os.path.join(root, "mav0")
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.cam1_dir = os.path.join(mav, "cam1", "data")
        self.stamps = sorted(int(f.split(".")[0]) for f in os.listdir(self.cam0_dir) if f.endswith(".png"))
        self.imu = _read_csv_rows(os.path.join(mav, "imu0", "data.csv"))  # [T, 7]: ns, gyro, acc
        gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.gt = _read_csv_rows(gt_csv, 8) if os.path.exists(gt_csv) else None  # [T, 8]: ns, p, q wxyz

    def __len__(self):
        return len(self.stamps)

    def _imu_slice(self, prev_ns, ns) -> np.ndarray:
        """The IMU rows with prev_ns < stamp <= ns (none for the first frame)."""
        if prev_ns is None:
            return np.zeros((0, 7))
        return self.imu[(self.imu[:, 0] > prev_ns) & (self.imu[:, 0] <= ns)]

    @staticmethod
    def _frame(ns, img_l, img_r, imu_batch) -> dict:
        return {"t": ns * 1e-9, "img_l": img_l, "img_r": img_r, "imu_stamps": imu_batch[:, 0] * 1e-9,
                "imu_gyro": imu_batch[:, 1:4].astype(np.float32), "imu_acc": imu_batch[:, 4:7].astype(np.float32)}

    def frames(self, start: int = 0, stop: int | None = None):
        """Per-frame dicts as utils.synthetic.make_sequence yields them (numpy images)."""
        stop = len(self.stamps) if stop is None else stop
        prev_ns = None
        for ns in self.stamps[start:stop]:
            img_l = _read_png(os.path.join(self.cam0_dir, f"{ns}.png"))
            img_r = _read_png(os.path.join(self.cam1_dir, f"{ns}.png"))
            yield self._frame(ns, img_l, img_r, self._imu_slice(prev_ns, ns))
            prev_ns = ns

    def frames_native(self, start: int = 0, stop: int | None = None, n_workers: int = 2):
        """The stream of `frames()`, decoded ahead by the native prefetcher's
        worker threads (8-bit gray images, as EuRoC's are)."""
        stop = len(self.stamps) if stop is None else stop
        stamps = self.stamps[start:stop]
        lp = [os.path.join(self.cam0_dir, f"{ns}.png") for ns in stamps]
        rp = [os.path.join(self.cam1_dir, f"{ns}.png") for ns in stamps]
        h, w = native_loader.read_png(lp[0]).shape[:2]
        pre = native_loader.StereoPrefetcher(lp, rp, w, h, n_workers=n_workers)
        try:
            prev_ns = None
            for ns, (img_l, img_r) in zip(stamps, pre):
                yield self._frame(ns, img_l, img_r, self._imu_slice(prev_ns, ns))
                prev_ns = ns
        finally:
            pre.close()

    def gt_positions_at(self, stamps_sec: list[float]) -> np.ndarray | None:
        """Ground-truth positions interpolated at the given stamps (s)."""
        if self.gt is None:
            return None
        gt_t = self.gt[:, 0] * 1e-9
        return np.stack([np.interp(stamps_sec, gt_t, self.gt[:, i]) for i in (1, 2, 3)], axis=-1)
