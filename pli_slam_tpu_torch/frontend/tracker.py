"""Host-side tracker for the stereo visual path (port of the stereo, non-IMU
part of pli_slam_tpu/frontend/tracker.py `Tracker`).

The first frame builds on the host path and `_initialize`s the map;
every later frame runs the fused device step (frontend.step) and
`_finish_fused` consumes its stats vector -- one frame late in
`streaming` mode, as in the reference, so the stats read overlaps the
next frame's work.

The rare paths belong to later slices. Where a run reaches one of them
-- relocalization, switching to a new map, a map reset on a timestamp
jump back, loop closing -- the port raises `NotImplementedError` naming
it instead of carrying on. `_try_merge` with a single map is a no-op in
the reference too, and returns False here; the port never parks a map,
so it always has one.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.frontend.frame import FrameData, build_frame
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.camera import PINHOLE, Camera
from pli_slam_tpu_torch.worldmap import stores as st
from pli_slam_tpu_torch.worldmap import vocab as vocab_mod


class TrackingState:
    NOT_INITIALIZED = "NOT_INITIALIZED"
    OK = "OK"
    RECENTLY_LOST = "RECENTLY_LOST"
    LOST = "LOST"


class Tracker:
    """Orchestrates the per-frame device programs on `device`."""

    def __init__(self, cam: Camera, cfg: SlamConfig, device):
        if cfg.sensor != "stereo":
            raise NotImplementedError(f"sensor {cfg.sensor!r}: the port runs the stereo visual path only")
        if cam.model != PINHOLE:
            raise NotImplementedError("fisheye (KB8) stereo is not ported yet")
        if cfg.loop.enabled:
            raise NotImplementedError("loop closing (LoopCloser) is not ported yet: use LoopConfig(enabled=False)")
        self.device = torch.device(device)
        dev = self.device
        self.cam = cam
        self.cfg = cfg
        self.build_frame = partial(build_frame, cam, cfg)
        self.voc_pt = vocab_mod.Vocabulary(seed=17)  # the reference's LSH defaults
        self.voc_ln = vocab_mod.Vocabulary(seed=23)
        self.bow_db = vocab_mod.BowDatabase.empty(cfg.map.max_keyframes, self.voc_pt.n_words, dev)
        self._step = step_mod.make_step_visual(cam, cfg, self.voc_pt, self.voc_ln, self.build_frame)
        m = cfg.map
        self.pstore = st.PointStore.empty(m.max_points, device=dev)
        self.lstore = st.LineStore.empty(m.max_lines, device=dev)
        self.kstore = st.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, dev)
        self.state = TrackingState.NOT_INITIALIZED
        self.n_kf = 0
        self._kf_view_dev = step_mod._empty_kf_views(cfg, dev)
        self._local_pt = step_mod._empty_local_map(cfg, dev)
        self.R = torch.eye(3, device=dev)
        self.t = torch.zeros(3, device=dev)
        self.R_prev = torch.eye(3, device=dev)
        self.t_prev = torch.zeros(3, device=dev)
        self.vel_xi = torch.zeros(6, device=dev)
        self.has_vel = torch.zeros((), dtype=torch.bool, device=dev)
        self.frames_since_kf = 0
        self.last_kf_inliers = 0
        self._lost_frames = 0
        self._prev_stamp: float | None = None
        self.streaming = False
        self._pending_stats = None
        self._traj_pending: list[tuple] = []
        self._traj_done: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.stats: list[dict] = []

    # -- trajectory ----------------------------------------------------------
    def finalize(self):
        """End of run. The reference drains its deferred global-BA chunks
        here; they come from loop closing, which this slice does not run."""

    @property
    def trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """(stamp, R_wc, p_w) per recorded frame; relative poses are composed
        with the CURRENT keyframe poses, so BA refinements reach every frame."""
        if self._traj_pending:
            pend, self._traj_pending = self._traj_pending, []
            refs = torch.tensor([e[1] for e in pend], device=self.device)
            R_cw, t_cw = _compose_trajectory(
                refs, torch.stack([e[2] for e in pend]), torch.stack([e[3] for e in pend]),
                torch.stack([e[4] for e in pend]), torch.stack([e[5] for e in pend]),
                self.kstore.R, self.kstore.t, self.kstore.valid)
            Rs, ts = R_cw.cpu().numpy(), t_cw.cpu().numpy()
            for (stamp, *_), R_, t_ in zip(pend, Rs, ts):
                self._traj_done.append((stamp, R_.T, -R_.T @ t_))
        return self._traj_done

    def positions(self) -> np.ndarray:
        return np.stack([p for _, _, p in self.trajectory])

    def _record(self, stamp: float):
        ref = max(self.n_kf - 1, 0)
        R_cr = lie._mm(self.R, self.kstore.R[ref].T)
        t_cr = self.t - lie._einsum("ij,j->i", R_cr, self.kstore.t[ref])
        self._traj_pending.append((stamp, ref, R_cr, t_cr, self.R, self.t))

    # -- rare paths (later slices) ------------------------------------------
    def _relocalize(self, frame) -> bool:
        raise NotImplementedError("relocalization (Tracker._relocalize) is not ported yet")

    def _switch_to_new_map(self):
        raise NotImplementedError("new-map switch (Tracker._switch_to_new_map, Atlas) is not ported yet")

    def reset_active_map(self):
        raise NotImplementedError("map reset (Tracker.reset_active_map) is not ported yet")

    def _try_merge(self, kf_slot: int) -> bool:
        return False

    def _check_timestamp(self, stamp: float) -> None:
        prev, self._prev_stamp = self._prev_stamp, float(stamp)
        if prev is None or self.state == TrackingState.NOT_INITIALIZED:
            return
        if stamp < prev:
            self.reset_active_map()

    # -- main entries ---------------------------------------------------------
    def process(self, img_l, img_r, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Stereo frame (reference System::TrackStereo). Images are [H, W]
        float32 in [0, 255], numpy or tensors; they are moved to `device`."""
        if imu is not None:
            raise NotImplementedError("stereo-inertial tracking is not ported yet")
        self._check_timestamp(stamp)
        img_args = (torch.as_tensor(img_l, dtype=torch.float32, device=self.device),
                    torch.as_tensor(img_r, dtype=torch.float32, device=self.device))
        if self.state == TrackingState.NOT_INITIALIZED:
            return self._initialize(self.build_frame(*img_args), stamp)
        return self._process_fused(img_args, stamp, allow_mapping)

    def _initialize(self, frame: FrameData, stamp: float) -> dict:
        n_stereo = int((frame.stereo_ok & frame.feats.valid).sum())
        if n_stereo < self.cfg.tracking.min_init_features:
            return {"state": self.state, "n_inliers": 0, "n_kf": 0, "n_points": 0, "n_lines": 0, "new_landmarks": 0}
        dev = self.device
        n, nl = frame.feats.uv.shape[0], frame.lines.angle.shape[0]
        neg = torch.full((n,), -1, dtype=torch.int32, device=dev)
        negl = torch.full((nl,), -1, dtype=torch.int32, device=dev)
        self.pstore, self.lstore, self.kstore, n_new = step_mod.insert_keyframe(
            self.cam, self.cfg, frame, self.R, self.t, stamp, neg, torch.zeros(n, dtype=torch.bool, device=dev),
            negl, torch.zeros(nl, dtype=torch.bool, device=dev), self.n_kf, self.pstore, self.lstore, self.kstore)
        self.n_kf = 1
        self.state = TrackingState.OK
        self.last_kf_inliers = n_stereo
        self.frames_since_kf = 0
        self._refresh_local_map(0)
        # KF0's view is deliberately not seeded into the triangulation ring (reference :2965)
        self._record(stamp)
        info = {"state": self.state, "n_inliers": n_stereo, "n_kf": 1,
                "n_points": int(self.pstore.valid.sum()), "n_lines": int(self.lstore.valid.sum()),
                "new_landmarks": int(n_new)}
        self.stats.append(info)
        return info

    def _refresh_local_map(self, kf_slot: int):
        if kf_slot < 0:
            self._local_pt = step_mod._empty_local_map(self.cfg, self.device)
            return
        self._local_pt = step_mod._local_map_ids(self.cfg, self.kstore, self.pstore, kf_slot)

    def _process_fused(self, img_args, stamp: float, allow_mapping: bool) -> dict:
        (R, t, R_prev, t_prev, self.vel_xi, self.has_vel,
         self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev, self._local_pt,
         _pt_idx, _pt_in, _ln_idx, _ln_in, counters, stats_dev, rel) = self._step(
            img_args, stamp, self.R, self.t, self.R_prev, self.t_prev, self.vel_xi, self.has_vel,
            self.n_kf, self.frames_since_kf, self.last_kf_inliers, allow_mapping,
            self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev, self._local_pt)
        self.R, self.t, self.R_prev, self.t_prev = R, t, R_prev, t_prev
        self._traj_pending.append((stamp, rel[0], rel[1], rel[2], R, t))
        return self._finish_fused(stamp, stats_dev, img_args, counters)

    def _finish_fused(self, stamp, stats_dev, img_args, counters) -> dict:
        """Consume the step's stats vector (the previous frame's in streaming mode)."""
        # the keyframe counters are exact on the host already (see frontend.step)
        self.n_kf, self.frames_since_kf, self.last_kf_inliers = counters
        if self.streaming:
            pending, self._pending_stats = self._pending_stats, (stamp, stats_dev, img_args)
            if pending is None:
                info = {"state": self.state, "n_inliers": 0, "n_kf": 0, "n_points": 0, "n_lines": 0,
                        "new_landmarks": 0}
                self.stats.append(info)
                return info
            _, stats_dev, img_args = pending
        stats = stats_dev.cpu().numpy()

        n_inliers = int(stats[step_mod.ST_NIN])
        if stats[step_mod.ST_OK] > 0:
            self.state = TrackingState.OK
            self._lost_frames = 0
        else:
            self.state = TrackingState.RECENTLY_LOST
            self._lost_frames += 1
            if self._lost_frames >= 2:
                if self._relocalize(self.build_frame(*img_args)):
                    n_inliers = self.cfg.tracking.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > self.cfg.tracking.recently_lost_sec * self.cfg.fps:
                    self._switch_to_new_map()
        if stats[step_mod.ST_KF_CREATED] > 0:
            self._try_merge(int(stats[step_mod.ST_KF_SLOT]))
        info = {"state": self.state, "n_inliers": n_inliers, "n_kf": int(stats[step_mod.ST_NKF]),
                "n_points": int(stats[step_mod.ST_NPTS]), "n_lines": int(stats[step_mod.ST_NLNS]),
                "new_landmarks": int(stats[step_mod.ST_NNEW])}
        self.stats.append(info)
        return info


def _compose_trajectory(refs, R_cr, t_cr, R_abs, t_abs, kR, kt, kvalid):
    """Compose relative per-frame poses with the current keyframe poses."""
    R_r, t_r, ok = kR[refs], kt[refs], kvalid[refs]
    R_cw = torch.einsum("nij,njk->nik", R_cr, R_r)
    t_cw = torch.einsum("nij,nj->ni", R_cr, t_r) + t_cr
    return torch.where(ok[:, None, None], R_cw, R_abs), torch.where(ok[:, None], t_cw, t_abs)
