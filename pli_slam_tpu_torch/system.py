"""The system facade: the port's public entry point (port of
pli_slam_tpu.system).

`System(cam, cfg, rectifier=None, device=None)` owns one `Tracker` on
`device` (the GPU unless the caller names another) and offers the
reference's API: `track_stereo` / `track_rgbd` / `track_monocular`, each
returning the frame's info with its pose; localization mode, where the
map does not grow; resets; the trajectory and keyframe-trajectory savers
in the TUM, EuRoC and KITTI formats; per-frame timing; the IMU-init log;
and the map as one npz file.

Map files are interchangeable with the JAX package's: the same names
("pt_" / "ln_" / "kf_" + store field, "meta_n_kf", "meta_R", "meta_t") and
the reference's dtypes. The incidence bitsets, int32 bit patterns in the
port, are written as a uint32 view and read back as an int32 view. As in
the reference, `load_map` fills a field missing from the file with the
live store's value.

Sensors: the reference's, stereo, stereo_imu, mono, mono_imu and rgbd;
any other, rgbd_imu included, raises ValueError, as in the reference. The
Tracker itself also runs rgbd_imu (`Tracker.process_rgbd(..., imu=)`) and
a KB8 fisheye stereo rig (`Tracker(cam, cfg, T_rl=...)`), which `System`
cannot describe; a KB8 camera serves mono and mono_imu here.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.utils import trajectory as tio
from pli_slam_tpu_torch.utils.config import SlamConfig

_STORES = (("pt", "pstore"), ("ln", "lstore"), ("kf", "kstore"))


class System:
    SENSORS = ("stereo", "stereo_imu", "mono", "mono_imu", "rgbd")

    def __init__(self, cam: Camera, cfg: SlamConfig | None = None, rectifier=None, device=None):
        """`rectifier`: an ops.rectify.StereoRectifier; raw stereo pairs
        are then rectified on the device inside the frame build."""
        self.cfg = cfg or SlamConfig.euroc_stereo()
        if self.cfg.sensor not in self.SENSORS:
            raise ValueError(f"unknown sensor {self.cfg.sensor}")
        self.cam = cam
        self.rectifier = rectifier
        self.device = device
        self.tracker = Tracker(cam, self.cfg, device, rectifier=rectifier)
        self.localization_only = False
        self._frame_times: list[float] = []

    # -- tracking entry points ---------------------------------------------
    def track_stereo(self, img_l, img_r, stamp: float, imu_batch=None) -> dict:
        """One stereo frame (and the IMU batch since the previous one). Returns
        the frame's info with its pose estimate (`R_wc`, `p_w`)."""
        t0 = time.time()
        info = self.tracker.process(img_l, img_r, stamp, allow_mapping=not self.localization_only, imu=imu_batch)
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def track_rgbd(self, img, depth, stamp: float, imu_batch=None) -> dict:
        """One RGB-D frame (depth in metres). `imu_batch` is not used (as in
        the reference)."""
        t0 = time.time()
        info = self.tracker.process_rgbd(img, depth, stamp, allow_mapping=not self.localization_only)
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def track_monocular(self, img, stamp: float, imu_batch=None) -> dict:
        """One monocular frame (and, with `mono_imu`, the IMU batch since the
        previous one, as in `track_stereo`)."""
        t0 = time.time()
        info = self.tracker.process_mono(img, stamp, allow_mapping=not self.localization_only, imu=imu_batch)
        self._frame_times.append(time.time() - t0)
        return self._with_pose(info)

    def _with_pose(self, info: dict) -> dict:
        _, R_wc, p_w = self.tracker.trajectory[-1]
        return {**info, "R_wc": R_wc, "p_w": p_w}

    # -- modes and resets ------------------------------------------------------
    def activate_localization_mode(self):
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def reset(self):
        """A fresh tracker: every map is dropped. The old tracker is let go
        and collected before the new one is built (the reference builds
        first), so the two never hold the device's memory at once."""
        self.tracker = None
        gc.collect()
        self.tracker = Tracker(self.cam, self.cfg, self.device, rectifier=self.rectifier)
        self._frame_times.clear()

    def reset_active_map(self):
        """Discard the active map only; the Atlas's parked maps stay."""
        self.tracker.reset_active_map()

    def shutdown(self):
        """Drain the queued post-loop BA chunks."""
        self.tracker.finalize()

    # -- trajectory output -------------------------------------------------------
    def save_trajectory_tum(self, path: str):
        self.tracker.finalize()
        tio.save_tum(path, self.tracker.trajectory)

    def save_trajectory_euroc(self, path: str):
        self.tracker.finalize()
        tio.save_euroc(path, self.tracker.trajectory)

    def save_trajectory_kitti(self, path: str):
        self.tracker.finalize()
        tio.save_kitti(path, self.tracker.trajectory)

    def _keyframe_trajectory(self):
        self.tracker.finalize()
        ks = self.tracker.kstore
        n = self.tracker.n_kf
        R, t, stamp = ks.R[:n].cpu().numpy(), ks.t[:n].cpu().numpy(), ks.stamp[:n].cpu().numpy()
        return [(float(stamp[k]), R[k].T, -R[k].T @ t[k]) for k in range(n)]

    def save_keyframe_trajectory_tum(self, path: str):
        tio.save_tum(path, self._keyframe_trajectory())

    def save_keyframe_trajectory_euroc(self, path: str):
        tio.save_euroc(path, self._keyframe_trajectory())

    def save_keyframe_trajectory_kitti(self, path: str):
        tio.save_kitti(path, self._keyframe_trajectory())

    # -- statistics ----------------------------------------------------------------
    def timing_stats(self) -> dict:
        """Mean and median host wall time per tracked frame (the first three
        left out when there are more) and the median's rate."""
        times = np.asarray(self._frame_times[3:] or self._frame_times)
        if not len(times):
            return {"mean_ms": 0.0, "median_ms": 0.0, "fps": 0.0}
        return {"mean_ms": float(times.mean() * 1e3), "median_ms": float(np.median(times) * 1e3),
                "fps": float(1.0 / max(np.median(times), 1e-9))}

    def save_imu_init_log(self, path: str):
        """One CSV row per IMU-initialization attempt: keyframe count,
        accepted / reason, scale, gravity angle from vertical, biases, cost
        before and after, wall time."""
        cols = ("n_kf", "accepted", "reason", "scale", "gravity_angle_deg", "bg", "ba", "cost0", "cost1", "wall_ms")
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for rec in self.tracker.imu_init_log:
                row = []
                for c in cols:
                    v = rec.get(c, "")
                    if isinstance(v, list):
                        v = " ".join(f"{x:.6g}" for x in v)
                    elif isinstance(v, float):
                        v = f"{v:.6g}"
                    row.append(str(v))
                f.write(",".join(row) + "\n")

    # -- the map as one file -------------------------------------------------------
    def save_map(self, path: str):
        """Every store, field by field, and the live pose, into one npz."""
        tr = self.tracker
        arrays = {}
        for prefix, attr in _STORES:
            for name, a in convert.to_numpy(getattr(tr, attr)).items():  # incidence words as uint32
                arrays[f"{prefix}_{name}"] = a
        arrays["meta_n_kf"] = np.asarray(tr.n_kf)
        arrays["meta_R"] = tr.R.cpu().numpy()
        arrays["meta_t"] = tr.t.cpu().numpy()
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        """The stores and pose of a map file; the BoW database is rebuilt
        from the loaded landmarks and the loop closer starts afresh."""
        tr = self.tracker
        dev = tr.device
        with np.load(path) as data:
            for prefix, attr in _STORES:
                store = getattr(tr, attr)
                kw = {f.name: (convert.tensor(data[f"{prefix}_{f.name}"], dev) if f"{prefix}_{f.name}" in data
                               else getattr(store, f.name))
                      for f in dataclasses.fields(store)}
                setattr(tr, attr, type(store)(**kw))
            tr.n_kf = int(data["meta_n_kf"])
            tr.R = torch.as_tensor(data["meta_R"], device=dev)
            tr.t = torch.as_tensor(data["meta_t"], device=dev)
        tr.state = TrackingState.OK if tr.n_kf > 0 else TrackingState.NOT_INITIALIZED
        if tr.n_kf > 0:
            tr.rebuild_bow()
        if tr.loop_closer is not None:
            tr.loop_closer = type(tr.loop_closer)(self.cfg, tr.draw)
