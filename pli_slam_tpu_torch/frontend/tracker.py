"""Host-side tracker for every sensor of the reference: stereo,
stereo-inertial, RGB-D, RGB-D-inertial, monocular and mono-inertial, on
pinhole or Kannala-Brandt8 (fisheye) cameras (port of
pli_slam_tpu/frontend/tracker.py `Tracker`).

Stereo (`sensor="stereo"`, `process`): the first frame builds on the host
path and `_initialize`s the map; every later frame runs the fused device
step (frontend.step.make_step_visual). With a `rectifier`
(ops.rectify.StereoRectifier) raw pairs are rectified inside the frame
build, on the fused step and the host path alike. A KB8 stereo rig
(`cam_right`, `T_rl`) cannot be rectified: its frames are built by
frontend.frame.build_frame_fisheye_stereo (epipolar-gated L/R matching and
triangulation) on every path, and a rectifier is ignored.

RGB-D (`sensor="rgbd"`, `process_rgbd`): the same, with
frontend.frame.build_frame_rgbd as the frame builder (the depth image
becomes a virtual right coordinate).

Monocular (`sensor="mono"`, `process_mono`): every frame is
host-orchestrated (`_process_frame`). `_initialize_mono` holds an anchor
frame and reconstructs the current one against it (solve.twoview), re-
anchoring while that fails; on success the anchor becomes KF0 with the
median-depth-normalized triangulation, and the current frame is tracked
into KF1. Later keyframes get their depth by triangulation against the
view three keyframes back (`_kf_views`), whose pose is read live from the
store. A Kannala-Brandt8 camera is allowed here: features are undistorted
to the pinhole frame with the same intrinsics, and everything downstream
runs on that pinhole camera.

Stereo-inertial (`sensor="stereo_imu"`, `process(..., imu=...)`): until the
IMU is initialized every frame is host-orchestrated (`_process_frame`:
preintegrate, visual `track_step` against the whole point store, keyframe
and windowed BA decided on the host). Once enough keyframes and IMU time
have gathered, `_try_imu_init` runs the three-stage initialization (gyro
bias, the inertial-only MAP problem, full inertial BA) and from the next
frame on the fused stereo-inertial step (make_step_vi) takes over, with the
VIBA1 / VIBA2 refinements queued as deferred chunks at +5 s and +15 s.

Mono-inertial (`sensor="mono_imu"`, `process_mono(..., imu=...)`) and
RGB-D-inertial (`sensor="rgbd_imu"`, `process_rgbd(..., imu=...)`): every
frame is host-orchestrated, inertial tracking once the IMU is initialized
(the reference runs no fused step for either). The mono map is born at an
arbitrary scale: `_try_imu_init` solves for it (the scale is free in the
inertial-only MAP problem) and `_apply_scale` rescales the map, and while
the map is young `_scale_refinement` re-estimates scale and gravity at each
keyframe after VIBA2.

`_finish_fused` consumes a fused step's stats vector -- one frame late in
`streaming` mode, as in the reference, so the stats read overlaps the next
frame's work.

The rare paths. With `cfg.loop.enabled` a `LoopCloser` sees every new
keyframe's BoW candidates (verification, essential-graph correction, then
the global BA queued as per-frame "gba" chunks). After two lost frames
(three with an inertial sensor) `_relocalize` seeds PnP against the whole
point store and the BoW candidates and keeps the best wide re-track;
persistent loss parks the map in the `Atlas` and starts a new one, which
`_try_merge` welds back into the parked map when place recognition finds
it again. A timestamp going backwards (or a jump with an inertial sensor)
resets or parks the active map. Monocular relocalization solves PnP with
the depth-free DLT.

Random draws (the PnP, two-view and merge RANSACs, and the loop closer's)
go through `Tracker.draw`, `solve.sim3.sample_indices` unless replaced: the
reference seeds its `jax.random` keys with the same integers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from functools import partial

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.frontend.frame import (FrameData, build_frame, build_frame_fisheye_stereo, build_frame_mono,
                                               build_frame_rgbd)
from pli_slam_tpu_torch.frontend.loop_closing import LoopCloser, match_cross_map, scene_scaled_thresh
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie, matching
from pli_slam_tpu_torch.ops.camera import KANNALA_BRANDT8, PINHOLE, Camera
from pli_slam_tpu_torch.solve import imu_init as ii
from pli_slam_tpu_torch.solve import inertial as inr
from pli_slam_tpu_torch.solve import pnp as pnp_mod
from pli_slam_tpu_torch.solve import sim3 as sim3_mod
from pli_slam_tpu_torch.worldmap import stores as st
from pli_slam_tpu_torch.worldmap import vocab as vocab_mod
from pli_slam_tpu_torch.worldmap.atlas import Atlas, MapBundle

_EMPTY_INFO = {"n_inliers": 0, "n_kf": 0, "n_points": 0, "n_lines": 0, "new_landmarks": 0}


class TrackingState:
    NOT_INITIALIZED = "NOT_INITIALIZED"
    OK = "OK"
    RECENTLY_LOST = "RECENTLY_LOST"
    LOST = "LOST"


class Tracker:
    """Orchestrates the per-frame device programs on `device`: the GPU
    unless the caller names another (`device=None` means
    `torch.device("cuda")`; the CPU is used only when asked for).
    `rectifier`: an ops.rectify.StereoRectifier for raw stereo pairs.
    A KB8 stereo rig needs `T_rl` (4x4, left-camera to right-camera
    coordinates); `cam_right` defaults to the left camera. A KB8 camera
    tracks on its pinhole twin (`self.cam`; `self.cam_raw` builds frames).
    `vocab_pt` / `vocab_ln`: the point and line vocabularies (a
    worldmap.vocab.TrainedVocabulary, e.g. from scripts.train_vocab); the
    LSH vocabularies by default. The BoW database is sized by each one's
    `n_words` (the reference sizes both halves by the point vocabulary's).
    On a GPU with loop closing on, construction runs
    `LoopCloser.warm_up` (its time in `loop_warmup_ms`)."""

    SENSORS = ("stereo", "stereo_imu", "rgbd", "rgbd_imu", "mono", "mono_imu")

    def __init__(self, cam: Camera, cfg: SlamConfig, device=None, rectifier=None, cam_right: Camera | None = None,
                 T_rl=None, vocab_pt=None, vocab_ln=None):
        if cfg.sensor not in self.SENSORS:
            raise ValueError(f"unknown sensor {cfg.sensor!r}: the tracker runs {', '.join(self.SENSORS)}")
        self.is_mono = cfg.sensor.startswith("mono")
        self.is_rgbd = cfg.sensor.startswith("rgbd")
        self.device = torch.device("cuda" if device is None else device)
        dev = self.device
        build_fisheye = None
        if cam.model == KANNALA_BRANDT8:
            if cfg.sensor.startswith("stereo"):
                if T_rl is None:
                    raise ValueError("KB8 fisheye stereo needs the rig extrinsics T_rl "
                                     "(4x4 left->right camera transform)")
                T = torch.as_tensor(np.asarray(T_rl, np.float32), device=dev)
                build_fisheye = partial(build_frame_fisheye_stereo, cam, cam_right if cam_right is not None else cam,
                                        cfg, T[:3, :3], T[:3, 3])
            elif not self.is_mono:
                raise ValueError("KB8 fisheye supports mono/mono_imu/stereo/stereo_imu")
        # a KB8 camera: features are undistorted to the pinhole frame with the
        # same intrinsics, and everything downstream runs on that pinhole camera
        self.cam_raw = cam
        cam = dataclasses.replace(cam, model=PINHOLE)
        self.cam = cam
        self.cfg = cfg
        self.rectifier = None if rectifier is None else rectifier.to(dev)
        if self.is_mono:
            self.build_frame = partial(build_frame_mono, self.cam_raw, cfg)
        elif self.is_rgbd:
            self.build_frame = partial(build_frame_rgbd, cam, cfg)
        elif build_fisheye is not None:
            self.build_frame = build_fisheye
        elif self.rectifier is not None:
            self.build_frame = partial(_build_rectified, cam, cfg, self.rectifier)
        else:
            self.build_frame = partial(build_frame, cam, cfg)
        self._mono_init_frame = None  # (FrameData, stamp) of the anchor awaiting its second view
        self._kf_views: list[tuple] = []  # (uv, desc, valid, kf_slot) of the last 3 keyframes (mono)
        self.voc_pt = vocab_pt if vocab_pt is not None else vocab_mod.Vocabulary(seed=17)  # the reference's LSH defaults
        self.voc_ln = vocab_ln if vocab_ln is not None else vocab_mod.Vocabulary(seed=23)
        self.bow_db = self._empty_bow_db()
        self._step = step_mod.make_step_visual(cam, cfg, self.voc_pt, self.voc_ln, self.build_frame)
        # deferred BA chunks, one executed per later non-keyframe frame
        self._deferred_ba: list[tuple] = []
        m = cfg.map
        self.pstore = st.PointStore.empty(m.max_points, device=dev)
        self.lstore = st.LineStore.empty(m.max_lines, device=dev)
        self.kstore = st.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, dev)
        self.state = TrackingState.NOT_INITIALIZED
        self.draw = sim3_mod.sample_indices  # (seed, probs, shape) -> indices; see solve.sim3
        self.atlas = Atlas(cfg, dev)
        self.loop_closer = LoopCloser(cfg, self.draw) if cfg.loop.enabled else None
        # (name) -> a context manager around each rare path: "loop" (a consistent
        # candidate's verification and correction), "gba" / "fiba" (a deferred BA
        # chunk), "reloc" (a relocalization attempt); see utils.profile.SyncSpans
        self.span = _no_span
        self._merge_streak = 0
        self._merge_map_idx = -1
        self._merge_kf = -1
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

        # -- inertial state (sensors *_imu) --------------------------------
        self.use_imu = cfg.sensor.endswith("_imu")
        self.ext = inr.Extrinsics.from_Tbc(cfg.imu.Tbc, dev)
        self.imu_ready = False
        self.gravity_w = None  # world gravity vector after init
        self.v_w = torch.zeros(3, device=dev)
        self.bg = torch.zeros(3, device=dev)
        self.ba = torch.zeros(3, device=dev)
        self.last_preint = None
        self._first_imu_stamp = None
        self._last_imu_raw = None  # boundary sample carried between frame batches
        self._viba_stage: int | None = None  # 0 after init, 1 after VIBA1, 2 done
        self._imu_init_stamp = 0.0
        # one record per IMU-init attempt: accepted / reason, scale, gravity
        # angle from vertical, biases, wall time
        self.imu_init_log: list[dict] = []
        self._preint_since_kf = None  # host path's per-keyframe accumulator
        # per-keyframe preintegration chain on the device (slot k spans KF k-1 -> KF k)
        self._pints = imu_ops.PreintStore.empty(m.max_keyframes, dev)
        self._imu_pad = cfg.imu.max_samples_per_frame
        self._vi_fused_active = False
        self._preint_acc = None  # fused path's per-keyframe accumulator
        # frames of widened matching after a map-changing event (IMU init,
        # full inertial BA, a deferred chunk)
        self._map_event_cooldown = 0
        if self.use_imu and not self.is_mono:  # the RGB-D-inertial sensor never runs it, as in the reference
            self._step_vi = step_mod.make_step_vi(cam, cfg, self.voc_pt, self.voc_ln, self.build_frame)
        self.loop_warmup_ms = None
        if self.loop_closer is not None and dev.type == "cuda":
            self.loop_warmup_ms = self.loop_closer.warm_up(self)

    def _empty_bow_db(self):
        return vocab_mod.BowDatabase.empty(self.cfg.map.max_keyframes, self.voc_pt.n_words, self.device,
                                           n_words_ln=self.voc_ln.n_words)

    # -- pose helpers --------------------------------------------------------
    def _use_motion_model(self) -> torch.Tensor:
        """0-d device bool: a velocity exists and the motion model is on."""
        return self.has_vel & bool(self.cfg.tracking.motion_model)

    def _predict_pose(self):
        dR, dt = lie.se3_exp(self.vel_xi)
        use_mm = self._use_motion_model()
        return (torch.where(use_mm, lie._mm(dR, self.R), self.R),
                torch.where(use_mm, lie._einsum("ij,j->i", dR, self.t) + dt, self.t))

    def _update_motion_model(self):
        # velocity twist: the current T_cw composed with the previous T_wc
        R_rel = lie._mm(self.R, self.R_prev.T)
        t_rel = self.t - lie._einsum("ij,j->i", R_rel, self.t_prev)
        self.vel_xi = lie.se3_log(R_rel, t_rel)
        self.has_vel = torch.ones((), dtype=torch.bool, device=self.device)

    def _reset_motion(self):
        self.has_vel = torch.zeros((), dtype=torch.bool, device=self.device)

    # -- trajectory ----------------------------------------------------------
    def finalize(self):
        """End of run: drain the deferred BA chunks, so that saved poses
        reflect the fully refined map."""
        if self._deferred_ba:
            self.run_deferred_ba(max_chunks=len(self._deferred_ba))

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

    def _flush_trajectory(self):
        """Compose the pending relative poses against the current keyframe
        store: must run before anything that changes keyframe slot identity
        (map reset, new-map switch, merge)."""
        _ = self.trajectory

    def _live_pose_rel(self):
        """The live pose relative to the newest keyframe: (slot, R_cr, t_cr)."""
        ref = max(self.n_kf - 1, 0)
        R_cr = lie._mm(self.R, self.kstore.R[ref].T)
        t_cr = self.t - lie._einsum("ij,j->i", R_cr, self.kstore.t[ref])
        return ref, R_cr, t_cr

    def _recompose_live_pose(self, ref: int, R_cr, t_cr):
        """Carry the live pose along with keyframe `ref`'s refined pose."""
        self.R = lie._mm(R_cr, self.kstore.R[ref])
        self.t = lie._einsum("ij,j->i", R_cr, self.kstore.t[ref]) + t_cr

    def _record(self, stamp: float):
        ref, R_cr, t_cr = self._live_pose_rel()
        self._traj_pending.append((stamp, ref, R_cr, t_cr, self.R, self.t))

    # -- IMU plumbing ---------------------------------------------------------
    def _imu_batch_arrays(self, imu: dict | None, packed: bool = False):
        """Pad and midpoint this frame's raw IMU batch to the fixed [T] arrays
        that preintegration consumes. The PREVIOUS frame's last raw sample is
        prepended: per-frame batches cut the sample stream at frame
        boundaries, and without the carried sample the interval between the
        last sample of frame k-1 and the first of frame k would be dropped
        (10% of every frame's motion at 200 Hz / 20 fps). `packed` gives the
        one [T, 8] tensor g | a | dt | mask of the fused step instead of four."""
        T = self._imu_pad
        g = np.zeros((T, 3), np.float32)
        a = np.zeros((T, 3), np.float32)
        dts = np.zeros(T, np.float32)
        mask = np.zeros(T, bool)
        if imu is not None:
            gyro = np.asarray(imu["gyro"], np.float32).reshape(-1, 3)
            acc = np.asarray(imu["acc"], np.float32).reshape(-1, 3)
            stamps = np.asarray(imu["stamps"], np.float64).reshape(-1)
            if self._first_imu_stamp is None and len(stamps):
                self._first_imu_stamp = float(stamps[0])
            prev = self._last_imu_raw
            if prev is not None and len(stamps) and prev[0] < stamps[0] - 1e-9:
                stamps = np.concatenate([[prev[0]], stamps])
                gyro = np.vstack([prev[1], gyro])
                acc = np.vstack([prev[2], acc])
            if len(stamps):
                self._last_imu_raw = (float(stamps[-1]), gyro[-1].copy(), acc[-1].copy())
            n = min(len(stamps), T)
            if n >= 2:
                g[: n - 1] = 0.5 * (gyro[: n - 1] + gyro[1:n])
                a[: n - 1] = 0.5 * (acc[: n - 1] + acc[1:n])
                dts[: n - 1] = np.diff(stamps[:n]).astype(np.float32)
                mask[: n - 1] = dts[: n - 1] > 0
        if packed:
            buf = np.concatenate([g, a, dts[:, None], mask[:, None].astype(np.float32)], axis=1)
            return torch.from_numpy(buf).to(self.device)
        return tuple(torch.from_numpy(x).to(self.device) for x in (g, a, dts, mask))

    def _ingest_imu(self, imu: dict, stamp: float):
        """Preintegrate this frame's IMU batch with the current biases and
        add it to the per-keyframe accumulator."""
        g, a, dts, mask = self._imu_batch_arrays(imu)
        self.last_preint = imu_ops.preintegrate(g, a, dts, mask, self.bg, self.ba, self.cfg.imu)
        if self._preint_since_kf is None:
            self._preint_since_kf = self.last_preint
        else:
            self._preint_since_kf = imu_ops.compose(self._preint_since_kf, self.last_preint)

    def _kf_chain(self, window: np.ndarray):
        """Stacked preintegration chain and mask (numpy) for consecutive
        window slots: factor i spans window[i] -> window[i+1], valid only
        between adjacent slots with a recorded accumulator."""
        window = np.asarray(window)
        nxt = window[1:]
        stacked = self._pints.gather(torch.as_tensor(nxt, dtype=torch.int32, device=self.device))
        adjacent = nxt == window[:-1] + 1
        imu_mask = self._pints.valid.cpu().numpy()[nxt] & adjacent
        return stacked, imu_mask

    def _body_state(self):
        return inr.body_state_from_camera(self.R, self.t, self.v_w, self.bg, self.ba, self.ext)

    def _kf_body_poses(self, n: int):
        """The first `n` keyframes' body poses (R_wb [n,3,3], p_wb [n,3]) through T_cb."""
        R_k, t_k = self.kstore.R[:n], self.kstore.t[:n]
        return (torch.einsum("kji,jm->kim", R_k, self.ext.R_cb),
                torch.einsum("kji,kj->ki", R_k, self.ext.t_cb[None] - t_k))

    # padded full-inertial-BA window capacities
    _FIBA_CAPS = (8, 16, 32)

    def _full_inertial_ba(self):
        """Whole-map visual-inertial BA. Maps up to the largest padded capacity
        solve in one window; larger maps run overlapping windows oldest ->
        newest, twice. The live frame pose rides along relative to the newest
        keyframe (teleporting it onto the keyframe would rewind the tracker
        by the frames since)."""
        rel = self._live_pose_rel()
        for window, fixed in self._fiba_schedule():
            self._run_fiba_window(window, fixed)
        self._adopt_keyframe_state(rel[0])
        self._recompose_live_pose(*rel)
        self._map_event_cooldown = 5

    def _adopt_keyframe_state(self, k: int):
        self.v_w, self.bg, self.ba = self.kstore.v_w[k], self.kstore.bg[k], self.kstore.ba[k]

    def _fiba_schedule(self):
        """The full-inertial-BA sweep as a list of (window, fixed) chunks, to
        run at once (`_full_inertial_ba`) or one per frame (the deferred queue)."""
        n = self.n_kf
        if n < 3 or self.gravity_w is None:
            return []
        W = next((c for c in self._FIBA_CAPS if c >= n), self._FIBA_CAPS[-1])
        if n <= W:
            starts = [max(n - W, 0)]
            passes = 1
        else:
            step = W - 1  # one keyframe of overlap carries the anchor forward
            starts = list(range(0, n - W, step)) + [n - W]
            passes = 2
        out = []
        for _ in range(passes):
            for lo in starts:
                window = np.clip(np.arange(lo, lo + W), 0, n - 1)
                fixed = np.zeros(W, bool)
                fixed[0] = True
                fixed[1:] |= window[1:] <= window[:-1]
                out.append((window, fixed))
        return out

    def _run_vi_ba(self, window: np.ndarray, fixed: np.ndarray):
        stacked, imu_mask = self._kf_chain(window)
        dev = self.device
        self.kstore, self.pstore, self.lstore = step_mod.local_inertial_ba(
            self.cam, self.cfg, self.kstore, self.pstore, self.lstore,
            torch.as_tensor(window, dtype=torch.int32, device=dev), torch.as_tensor(fixed, device=dev),
            stacked, torch.as_tensor(imu_mask, device=dev), self.gravity_w, self.ext)

    def _run_fiba_window(self, window, fixed):
        # keyframes culled since the schedule was drawn stay pinned
        self._run_vi_ba(window, fixed | ~self.kstore.valid.cpu().numpy()[window])

    def _queue_gba(self, inertial: bool):
        """Schedule the post-loop global BA as per-frame chunks: the
        full-inertial-BA sweep with an initialized IMU, else ceil(gba_iters /
        gba_chunk_iters) chunks of whole-map BA. A new loop supersedes any
        pending schedule; each chunk works on the live map."""
        if inertial:
            self._deferred_ba = [("fiba", chunk) for chunk in self._fiba_schedule()]
        else:
            chunk = max(self.cfg.loop.gba_chunk_iters, 1)
            self._deferred_ba = [("gba", chunk)] * -(-self.cfg.opt.gba_iters // chunk)

    def run_deferred_ba(self, max_chunks: int = 1):
        """Execute up to `max_chunks` queued chunks. The live frame pose rides
        along: recorded relative to the newest keyframe before each chunk and
        recomposed against that keyframe's refined pose after it."""
        n_run = 0
        while self._deferred_ba and n_run < max_chunks:
            kind, arg = self._deferred_ba.pop(0)
            rel = self._live_pose_rel()
            with self.span(kind):
                if kind == "gba":
                    self.kstore, self.pstore, self.lstore = step_mod.global_ba(
                        self.cam, self.cfg, self.kstore, self.pstore, self.lstore, iters=arg)
                else:
                    self._run_fiba_window(*arg)
                    if not self._deferred_ba:  # final chunk: refresh the live state
                        self._adopt_keyframe_state(rel[0])
            self._recompose_live_pose(*rel)
            self._map_event_cooldown = max(self._map_event_cooldown, 2)
            n_run += 1

    def _apply_scale(self, s: float):
        """Rescale the whole map by `s` (the mono-inertial metric scale):
        point positions, line endpoints, keyframe translations and
        velocities, the live and previous translations and velocity, and
        every recorded trajectory entry. As in the reference, the motion
        model's twist keeps the old scale (the view rings hold keyframe
        slots, whose poses are read live)."""
        self.pstore = dataclasses.replace(self.pstore, x=self.pstore.x * s)
        self.lstore = dataclasses.replace(self.lstore, seg=self.lstore.seg * s)
        self.kstore = dataclasses.replace(self.kstore, t=self.kstore.t * s, v_w=self.kstore.v_w * s)
        self.t = self.t * s
        self.t_prev = self.t_prev * s
        self.v_w = self.v_w * s
        # pending entries are (stamp, ref, R_cr, t_cr, R_abs, t_abs): t_cr = t_cw - R_cr t_r
        # is linear in the translations, so a uniform scale multiplies it too
        self._traj_pending = [(st_, ref, R_cr, t_cr * s, R_abs, t_abs * s)
                              for st_, ref, R_cr, t_cr, R_abs, t_abs in self._traj_pending]
        self._traj_done = [(st_, R_wc, p * s) for st_, R_wc, p in self._traj_done]

    def _try_imu_init(self):
        """Three-stage IMU initialization over the keyframe chain:
        1. gyro bias from visual against preintegrated keyframe rotations;
        2. the joint MAP problem over gravity direction, biases and
           per-keyframe velocities with the poses fixed
           (solve.imu_init.inertial_optimization): the scale is fixed for
           stereo and RGB-D and free for mono, whose map is then rescaled;
        3. full inertial BA over the whole map.
        VIBA1 / VIBA2 follow at +5 s / +15 s. Appends one record to `imu_init_log`."""
        t0 = time.perf_counter()

        def log(accepted, reason, **kw):
            self.imu_init_log.append({"n_kf": int(self.n_kf), "accepted": bool(accepted), "reason": reason,
                                      "wall_ms": (time.perf_counter() - t0) * 1e3, **kw})

        n = self.n_kf
        # a thin keyframe set under-constrains the inertial-only MAP problem
        if n < self.cfg.imu.init_min_kfs:
            return log(False, "too_few_keyframes")
        stacked, imu_mask = self._kf_chain(np.arange(n))
        if imu_mask.sum() < 3:
            return log(False, "too_few_preintegrations")
        dev = self.device
        ks = self.kstore
        R_wb, p_wb = self._kf_body_poses(n)

        # stage 1: gyro bias from rotation residuals
        live = np.nonzero(imu_mask)[0]
        preints = [imu_ops._map(lambda a: a[i], stacked) for i in live]
        dRs = [lie._mm(R_wb[i].T, R_wb[i + 1]) for i in live]
        bg0 = inr.estimate_gyro_bias(preints, dRs, prior_info=1.0)

        # stage 2: joint MAP over (gravity direction, bg, ba, velocities)
        mask_dev = torch.as_tensor(imu_mask, device=dev)
        Rwg0 = ii.gravity_dir_seed(stacked, mask_dev, R_wb, self.cfg.imu.gravity)
        v0 = ii.velocity_seed(p_wb, ks.stamp[:n])
        fix_scale = not self.is_mono
        Rwg, s, bg, ba, v, costs = ii.inertial_optimization(
            stacked, mask_dev, R_wb, p_wb, v0, Rwg0, bg0, torch.zeros(3, device=dev), self.cfg.imu,
            prior_g=1e2, prior_a=1e6 if self.is_mono else 1e5, fix_scale=fix_scale)
        g_w = lie._einsum("ij,j->i", Rwg, torch.tensor([0.0, 0.0, -self.cfg.imu.gravity], device=dev))
        if not bool(torch.all(torch.isfinite(g_w))):
            return log(False, "nonfinite_gravity")
        self.gravity_w = g_w
        self.bg = bg
        self.ba = ba
        scale = float(s)
        if not fix_scale and abs(scale - 1.0) > 1e-3 and scale > 1e-3:
            self._apply_scale(scale)
            v = v * scale
        new = {}
        for name, val in (("v_w", v), ("bg", bg.expand(n, 3)), ("ba", ba.expand(n, 3))):
            arr = getattr(self.kstore, name).clone()
            arr[:n] = val
            new[name] = arr
        self.kstore = dataclasses.replace(self.kstore, **new)
        self.v_w = v[n - 1]
        self.imu_ready = True
        # stage 3: full-map visual-inertial BA. No standalone gravity
        # refinement follows: the VIBA chunks re-optimize the state jointly
        self._full_inertial_ba()
        self._imu_init_stamp = float(self.kstore.stamp[n - 1])
        self._viba_stage = 0
        g_np = g_w.cpu().numpy()
        grav_angle = float(np.degrees(np.arccos(np.clip(-g_np[2] / max(np.linalg.norm(g_np), 1e-9), -1.0, 1.0))))
        log(True, "ok", scale=scale, gravity_angle_deg=grav_angle, bg=bg.cpu().numpy().tolist(),
            ba=ba.cpu().numpy().tolist(), cost0=float(costs[0]), cost1=float(costs[-1]))

    def _scale_refinement(self, fix_scale: bool = False):
        """Scale and gravity-direction refinement over the keyframe chain,
        the biases pinned (`fix_bias`): the map is rescaled when the
        correction exceeds 0.2%. With `fix_scale` only the gravity direction
        and the velocities are refined."""
        n = self.n_kf
        if n < 4 or self.gravity_w is None:
            return
        stacked, imu_mask = self._kf_chain(np.arange(n))
        if imu_mask.sum() < 3:
            return
        dev = self.device
        R_wb, p_wb = self._kf_body_poses(n)
        # the current gravity direction seeds the rotation
        g0 = torch.tensor([0.0, 0.0, -self.cfg.imu.gravity], device=dev)
        gw = self.gravity_w / torch.linalg.norm(self.gravity_w)
        gz = g0 / torch.linalg.norm(g0)
        v_axis = torch.linalg.cross(gz, gw)
        s_ang = torch.linalg.norm(v_axis)
        Rwg0 = torch.where(s_ang > 1e-6,
                           lie.so3_exp(v_axis / torch.clamp(s_ang, min=1e-9) * torch.arcsin(torch.clamp(s_ang, -1, 1))),
                           torch.eye(3, device=dev))
        Rwg, s, _bg, _ba, v, _costs = ii.inertial_optimization(
            stacked, torch.as_tensor(imu_mask, device=dev), R_wb, p_wb, self.kstore.v_w[:n], Rwg0, self.bg, self.ba,
            self.cfg.imu, fix_scale=fix_scale, fix_bias=True)
        scale = float(s)
        if not np.isfinite(scale) or scale <= 1e-3:
            return
        g_w = lie._einsum("ij,j->i", Rwg, g0)
        if not bool(torch.all(torch.isfinite(g_w))):
            return
        self.gravity_w = g_w
        if not fix_scale and abs(scale - 1.0) > 0.002:
            self._apply_scale(scale)
            v = v * scale
        v_all = self.kstore.v_w.clone()
        v_all[:n] = v
        self.kstore = dataclasses.replace(self.kstore, v_w=v_all)
        self.v_w = v[n - 1]

    # -- Atlas: a new map on persistent loss, merging back -------------------
    def _park_active(self):
        self.atlas.maps[self.atlas.active_idx] = MapBundle(
            pstore=self.pstore, lstore=self.lstore, kstore=self.kstore, n_kf=self.n_kf, bow_db=self.bow_db)

    def _clear_map_state(self):
        """What a fresh active map starts from (shared by the new-map switch
        and the map reset): no keyframes, no IMU initialization."""
        dev, cfg = self.device, self.cfg
        self.n_kf = 0
        self.state = TrackingState.NOT_INITIALIZED
        self._reset_motion()
        self._lost_frames = 0
        self.frames_since_kf = 0
        self._pending_stats = None
        self._preint_since_kf = None
        self._pints = imu_ops.PreintStore.empty(cfg.map.max_keyframes, dev)
        self._kf_view_dev = step_mod._empty_kf_views(cfg, dev)
        self._kf_views = []
        self._mono_init_frame = None
        self._local_pt = step_mod._empty_local_map(cfg, dev)
        self._deferred_ba = []  # pending chunks name old-map slots
        self.imu_ready = False
        self.gravity_w = None
        self._viba_stage = None
        self.v_w = torch.zeros(3, device=dev)
        self._vi_fused_active = False
        self._preint_acc = None
        self.bow_db = self._empty_bow_db()
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(cfg, self.draw)

    def _switch_to_new_map(self):
        """Park the active map (with its BoW database, so place recognition
        can find it again) and start a fresh one; the IMU initializes anew."""
        self._flush_trajectory()  # pending poses name old-map keyframe slots
        self._park_active()
        fresh = self.atlas.create_new_map()
        self.pstore, self.lstore, self.kstore = fresh.pstore, fresh.lstore, fresh.kstore
        self._clear_map_state()

    def reset_active_map(self):
        """Discard the active map and start afresh; parked maps stay."""
        self._flush_trajectory()
        m, dev = self.cfg.map, self.device
        self.pstore = st.PointStore.empty(m.max_points, device=dev)
        self.lstore = st.LineStore.empty(m.max_lines, device=dev)
        self.kstore = st.KeyFrameStore.empty(m.max_keyframes, self.cfg.orb.n_features, self.cfg.lines.n_lines, dev)
        self._clear_map_state()
        self.last_kf_inliers = 0
        self.bg = torch.zeros(3, device=dev)
        self.ba = torch.zeros(3, device=dev)
        self._first_imu_stamp = None
        self._last_imu_raw = None

    def _bow_of_kf(self, kf_slot: int):
        """BoW vectors of a keyframe's observed landmarks (their own descriptors)."""
        ids, lids = self.kstore.obs_pt[kf_slot], self.kstore.obs_ln[kf_slot]
        safe, lsafe = torch.clamp(ids, min=0).long(), torch.clamp(lids, min=0).long()
        return (self.voc_pt.bow(self.pstore.desc[safe], (ids >= 0) & self.pstore.valid[safe]),
                self.voc_ln.bow(self.lstore.desc[lsafe], (lids >= 0) & self.lstore.valid[lsafe]))

    def _try_merge(self, kf_slot: int) -> bool:
        """Query the parked maps' BoW databases with the new keyframe; on a
        hit that persists over two keyframes, verify with SE3 RANSAC over
        cross-map landmark matches and weld the active map into the parked
        one, the verified matches fused, then a welding BA across the seam."""
        if self.atlas.n_maps() <= 1 or self.n_kf < 2:
            return False
        bow_p, bow_l = self._bow_of_kf(kf_slot)
        cand_maps, lazy = [], []
        for mi, bundle in enumerate(self.atlas.maps):
            if mi == self.atlas.active_idx or bundle.bow_db is None:
                continue
            excl = torch.zeros(bundle.bow_db.valid.shape[0], dtype=torch.bool, device=self.device)
            slots, scores = vocab_mod.query(bundle.bow_db, bow_p, bow_l, excl, n_best=1)
            cand_maps.append(mi)
            lazy.append(torch.stack([slots[0].float(), scores[0]]))
        best = (-1, -1, -1.0)
        if lazy:
            for mi, (slot_f, score) in zip(cand_maps, torch.stack(lazy).cpu().numpy()):  # one read for all maps
                if float(score) > best[2]:
                    best = (mi, int(slot_f), float(score))
        mi, k_dst, score = best
        if mi < 0 or k_dst < 0 or score < 0.12:
            self._merge_streak = 0
            return False
        if self._merge_map_idx == mi and abs(k_dst - self._merge_kf) <= 3:
            self._merge_streak += 1
        else:
            self._merge_streak = 1
        self._merge_map_idx, self._merge_kf = mi, k_dst
        if self._merge_streak < 2:
            return False

        dst = self.atlas.maps[mi]
        xa, xb, idx_b, m = match_cross_map(self.kstore, self.pstore, kf_slot, dst.kstore, dst.pstore, k_dst)
        hyp = self.draw(1000 + kf_slot, sim3_mod.mask_probs(m), (self.cfg.loop.sim3_hypotheses, 3))
        R_rel, t_rel, _, inl, n_in = sim3_mod.ransac_sim3(xa, xb, m, hyp, inlier_thresh=scene_scaled_thresh(xa, m),
                                                          with_scale=False)
        if int(n_in) < self.cfg.loop.sim3_min_inliers:
            return False

        self._flush_trajectory()  # keyframe slots are about to be remapped
        neg = torch.full_like(idx_b, -1)
        fuse_src = torch.where(inl, self.kstore.obs_pt[kf_slot], neg)
        fuse_dst = torch.where(inl, idx_b, neg)
        self._park_active()
        merged = self.atlas.merge_active_into(mi, R_rel, t_rel, fuse_src, fuse_dst)
        kf_slots = self.atlas.last_kf_slots  # active slot -> merged slot
        self.pstore, self.lstore, self.kstore, self.n_kf = merged.pstore, merged.lstore, merged.kstore, merged.n_kf
        # the live pose into the merged world: T_cw' = T_cw o T_rel^-1
        Rr_inv, tr_inv = lie.se3_inverse(R_rel, t_rel)
        self.t = lie._einsum("ij,j->i", self.R, tr_inv) + self.t
        self.R = lie._mm(self.R, Rr_inv)
        self._reset_motion()
        # the active side's preintegration chain survives where both ends stay adjacent
        self._pints = self._pints.remap(kf_slots)
        if self.gravity_w is not None:
            self.gravity_w = lie._einsum("ij,j->i", R_rel, self.gravity_w)
            self.v_w = lie._einsum("ij,j->i", R_rel, self.v_w)
        self._preint_since_kf = None
        self._kf_views = []
        # the view ring's keyframe slots through the merge map (-1 drops a view)
        uvv, descv, validv, slotv = self._kf_view_dev
        slot_map = torch.as_tensor(np.concatenate([kf_slots.astype(np.int32), [-1]]), device=self.device)
        new_slot = slot_map[torch.clamp(slotv, -1, len(kf_slots) - 1).long()]
        self._kf_view_dev = (uvv, descv, validv & (new_slot >= 0)[:, None], new_slot)
        self._deferred_ba = []  # pending chunks name pre-merge slots
        self.rebuild_bow()
        merged.bow_db = None
        if self.loop_closer is not None:
            self.loop_closer = LoopCloser(self.cfg, self.draw)
        self._merge_streak = 0
        self._merge_map_idx = -1
        self._weld_ba(k_dst)
        return True

    def _weld_ba(self, k_dst: int):
        """The welding BA after a merge: the matched parked-side neighbourhood
        of `k_dst` (fixed) and the newest active-side keyframes,
        visual-inertial with an initialized IMU; tracking continues from the
        newest keyframe."""
        W = self.cfg.opt.local_ba_window
        half = W // 2
        old_side = [k_dst + i - half // 2 for i in range(W - half)]
        new_side = [self.n_kf - half + i for i in range(half)]
        window = np.asarray([min(max(k, 0), self.n_kf - 1) for k in old_side + new_side], np.int32)
        fixed = np.zeros(W, bool)
        fixed[: W - half] = True
        fixed |= np.asarray([window[i] in window[:i] for i in range(W)])
        if self.imu_ready and self.gravity_w is not None:
            self._run_vi_ba(window, fixed)
        else:
            dev = self.device
            self.kstore, self.pstore, self.lstore = step_mod.local_ba(
                self.cam, self.cfg, self.kstore, self.pstore, self.lstore,
                torch.as_tensor(window, device=dev), torch.as_tensor(fixed, device=dev))
        self.R, self.t = self.kstore.R[self.n_kf - 1], self.kstore.t[self.n_kf - 1]

    def rebuild_bow(self):
        """Recompute the BoW database from the landmark stores (after a merge)."""
        ks, ps, ls = self.kstore, self.pstore, self.lstore
        ids, lids = ks.obs_pt, ks.obs_ln
        safe, lsafe = torch.clamp(ids, min=0).long(), torch.clamp(lids, min=0).long()
        bow_p = self.voc_pt.bow_rows(ps.desc[safe], (ids >= 0) & ps.valid[safe])
        bow_l = self.voc_ln.bow_rows(ls.desc[lsafe], (lids >= 0) & ls.valid[lsafe])
        zero = torch.zeros((), device=self.device)
        self.bow_db = vocab_mod.BowDatabase(hist_pt=torch.where(ks.valid[:, None], bow_p, zero),
                                            hist_ln=torch.where(ks.valid[:, None], bow_l, zero), valid=ks.valid)
        if self.n_kf > 0:
            self._refresh_local_map(self.n_kf - 1)

    # -- relocalization ---------------------------------------------------------
    def _bow_query_frame(self, desc, fvalid, ldesc, lvalid, n_best: int):
        """The frame's top BoW candidates over the whole database: (slots, scores)."""
        excl = torch.zeros(self.bow_db.valid.shape[0], dtype=torch.bool, device=self.device)
        return step_mod.vocab_query(self.bow_db, self.voc_pt.bow(desc, fvalid), self.voc_ln.bow(ldesc, lvalid),
                                    excl, n_best=n_best)

    def _pnp_reloc(self, frame: FrameData, seed: int):
        """Pose-free PnP: the frame's descriptors against the whole point
        store (mutual nearest neighbours, ratio 0.8), RANSAC lifted by the
        stereo depth (mono: the depth-free 6-point DLT), then the GN polish."""
        cfg, ps = self.cfg, self.pstore
        dist = matching.hamming_matrix(frame.feats.desc, ps.desc)
        idx, _, okm = matching.match_nn(dist, frame.feats.valid, ps.valid, max_dist=cfg.match.orb_th_low, ratio=0.8)
        okm = matching.mutual_consistency(idx, okm, dist, frame.feats.valid, ps.valid)
        if not self.is_mono:
            okm = okm & (frame.depth > 0)
        hyp = self.draw(seed, sim3_mod.mask_probs(okm), (pnp_mod.N_HYPOTHESES, 6 if self.is_mono else 3))
        return pnp_mod.solve_pnp(self.cam, ps.x[idx.long()], frame.feats.uv, frame.u_right, frame.stereo_ok,
                                 frame.depth, frame.sigma2, okm, hyp, cfg.opt, inlier_px=8.0, min_inliers=12,
                                 mono=self.is_mono)

    def _relocalize(self, frame: FrameData) -> bool:
        """Seeds: the PnP pose (if its RANSAC clears its floor) and the BoW
        candidates' keyframe poses. Every seed gets a wide re-track and the
        best one is kept if it reaches min_inliers_local_map; the local map
        is then re-anchored at the keyframe nearest by |t_cw|."""
        if self.n_kf == 0:
            return False
        with self.span("reloc"):
            seeds = []
            Rp, tp, _, _, okp = self._pnp_reloc(frame, 7000 + len(self.stats))
            if bool(okp):
                seeds.append((Rp, tp))
            nb = self.cfg.loop.bow_candidates
            slots, scores = self._bow_query_frame(frame.feats.desc, frame.feats.valid, frame.lines.desc,
                                                  frame.lines.valid, n_best=nb)
            slots, scores = slots.cpu().numpy(), scores.cpu().numpy()
            for c in range(nb):
                k = int(slots[c])
                if k >= 0 and float(scores[c]) > 0.05:
                    seeds.append((self.kstore.R[k], self.kstore.t[k]))
            best_n, best_pose = 0, None
            wide = torch.ones((), dtype=torch.bool, device=self.device)
            for R0, t0 in seeds:
                R, t, *_, n_in, self.pstore, self.lstore = step_mod.track_step(
                    self.cam, self.cfg, frame, R0, t0, self.pstore, self.lstore, wide=wide)
                if int(n_in) > best_n:
                    best_n, best_pose = int(n_in), (R, t)
            if best_pose is None or best_n < self.cfg.tracking.min_inliers_local_map:
                return False
            self.R, self.t = best_pose
            self._reset_motion()
            self.state = TrackingState.OK
            # the nearest keyframe by |t_cw| difference, as in the reference
            d = np.linalg.norm(self.kstore.t[: self.n_kf].cpu().numpy() - self.t.cpu().numpy()[None], axis=1)
            d[~self.kstore.valid[: self.n_kf].cpu().numpy()] = np.inf
            self._refresh_local_map(int(np.argmin(d)))
            return True

    def _check_timestamp(self, stamp: float) -> None:
        """A frame older than its predecessor resets the active map; a forward
        jump of more than 1 s with an inertial sensor breaks the
        preintegration chain: the map is parked if the IMU was initialized,
        and reset if not."""
        prev, self._prev_stamp = self._prev_stamp, float(stamp)
        if prev is None or self.state == TrackingState.NOT_INITIALIZED:
            return
        if stamp < prev:
            self.reset_active_map()
        elif stamp - prev > 1.0 and self.use_imu:
            if self.imu_ready:
                self._switch_to_new_map()
            else:
                self.reset_active_map()

    # -- keyframes on the host path -----------------------------------------
    def _bow_kf(self, frame: FrameData, kf_slot: int, n_kf: int):
        """BoW add and loop-candidate query for a host-path keyframe (the
        same database the fused steps maintain)."""
        bow_p = self.voc_pt.bow(frame.feats.desc, frame.feats.valid & (self.kstore.obs_pt[kf_slot] >= 0))
        bow_l = self.voc_ln.bow(frame.lines.desc, frame.lines.valid)
        self.bow_db = self.bow_db.add(kf_slot, bow_p, bow_l)
        K = self.bow_db.valid.shape[0]
        excl = torch.arange(K, device=self.device) >= max(n_kf - self.cfg.loop.min_kf_gap, 0)
        slots, scores = step_mod.vocab_query(self.bow_db, bow_p, bow_l, excl, n_best=step_mod.N_LOOP_CANDS,
                                             covis=self.kstore.covis)
        if kf_slot < self.cfg.loop.min_kf_gap:
            slots, scores = torch.full_like(slots, -1), torch.full_like(scores, -1.0)
        return slots, scores

    def _cull_keyframes(self):
        """Invalidate redundant keyframes: >= kf_cull_redundancy of their
        landmarks are seen by more than cull_min_obs keyframes. KF 0 and the
        active window are kept."""
        W = self.cfg.opt.local_ba_window
        lo, hi = 1, self.n_kf - W
        if self.n_kf < W + 2 or hi <= lo:
            return
        obs = self.kstore.obs_pt[lo:hi]
        has = obs >= 0
        n_obs = self.pstore.n_obs[torch.clamp(obs, min=0).long()]
        redundant = torch.sum((n_obs >= self.cfg.map.cull_min_obs + 1) & has, dim=1) / torch.clamp(
            torch.sum(has, dim=1), min=1)
        cull = (redundant >= self.cfg.map.kf_cull_redundancy) & self.kstore.valid[lo:hi]
        valid = self.kstore.valid.clone()
        valid[lo:hi] &= ~cull
        self.kstore = dataclasses.replace(self.kstore, valid=valid)

    def _create_keyframe(self, frame, stamp, pt_idx, pt_in, ln_idx, ln_in) -> int:
        if self.is_mono and self._kf_views:
            # no depth channel: triangulate against the view three keyframes
            # back (consecutive keyframes carry too little parallax), its pose
            # read live from the store (windowed BA refines it)
            uvk, desck, validk, slotk = self._kf_views[0]
            depth = step_mod._mono_triangulated_depths(self.cam, self.cfg, frame, self.R, self.t, uvk, desck, validk,
                                                       self.kstore.R[slotk], self.kstore.t[slotk])
            frame = dataclasses.replace(frame, depth=depth)
        self.pstore, self.lstore, self.kstore, n_new = step_mod.insert_keyframe(
            self.cam, self.cfg, frame, self.R, self.t, stamp, pt_idx, pt_in, ln_idx, ln_in, self.n_kf,
            self.pstore, self.lstore, self.kstore)
        if self.use_imu:
            k = self.n_kf
            new = {}
            for name, val in (("v_w", self.v_w), ("bg", self.bg), ("ba", self.ba)):
                arr = getattr(self.kstore, name).clone()
                arr[k] = val
                new[name] = arr
            self.kstore = dataclasses.replace(self.kstore, **new)
            # snapshot the chain factor KF(k-1) -> KF(k) and start the accumulator again
            if k > 0 and self._preint_since_kf is not None:
                self._pints = self._pints.set(k, self._preint_since_kf)
            self._preint_since_kf = None
        self.n_kf += 1
        # windowed BA over the last W keyframes, the oldest fixed for gauge
        W = self.cfg.opt.local_ba_window
        lo = max(self.n_kf - W, 0)
        window = np.clip(np.arange(lo, lo + W), 0, max(self.n_kf - 1, 0))
        n_fixed = max(self.cfg.opt.local_ba_fixed, W - (self.n_kf - lo))
        fixed = np.zeros(W, bool)
        fixed[: max(1, n_fixed)] = True
        fixed[1:] |= window[1:] <= window[:-1]  # duplicated padding entries
        if self.n_kf >= 3:
            k = self.n_kf - 1
            if self.use_imu and self.imu_ready and self.gravity_w is not None:
                self._run_vi_ba(window, fixed)
                self._adopt_keyframe_state(k)
            else:
                dev = self.device
                self.kstore, self.pstore, self.lstore = step_mod.local_ba(
                    self.cam, self.cfg, self.kstore, self.pstore, self.lstore,
                    torch.as_tensor(window, dtype=torch.int32, device=dev), torch.as_tensor(fixed, device=dev))
            # tracking continues from the refined latest keyframe
            self.R, self.t = self.kstore.R[k], self.kstore.t[k]
        if self.is_mono:
            self._kf_views = (self._kf_views + [(frame.feats.uv, frame.feats.desc, frame.feats.valid,
                                                 self.n_kf - 1)])[-3:]
        slots, scores = self._bow_kf(frame, self.n_kf - 1, self.n_kf)
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(self, self.n_kf - 1,
                                         list(zip(slots.cpu().tolist(), scores.cpu().tolist())))
        self._try_merge(self.n_kf - 1)
        self._cull_keyframes()
        self._refresh_local_map(self.n_kf - 1)
        return int(n_new)

    # -- main entries ---------------------------------------------------------
    def process(self, img_l, img_r, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Stereo / stereo-inertial frame. Images are [H, W] float32 in
        [0, 255], numpy or tensors; they are moved to `device`. `imu` is this
        frame's raw batch {"gyro" [n,3], "acc" [n,3], "stamps" [n]} covering
        (previous frame, this frame]; the visual sensor ignores it."""
        self._check_timestamp(stamp)
        img_args = (self._image(img_l), self._image(img_r))
        if self.use_imu:
            # after IMU init the frames run the fused stereo-inertial step;
            # before it, and after a loss, they are host-orchestrated
            if self.imu_ready and self.gravity_w is not None and self.state == TrackingState.OK:
                return self._process_fused_vi(img_args, stamp, allow_mapping, imu)
            if self._vi_fused_active:
                self._exit_vi_fused()
            return self._process_frame(self.build_frame(*img_args), stamp, allow_mapping, imu)
        if self.state == TrackingState.NOT_INITIALIZED:
            return self._initialize(self.build_frame(*img_args), stamp)
        return self._process_fused(img_args, stamp, allow_mapping)

    def process_rgbd(self, img, depth, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """RGB-D frame: `img` [H, W] float32 in [0, 255] and `depth` [H, W]
        in metres (0 where unknown), numpy or tensors; `imu` as in
        `process`. The map initializes on the host path; later frames run
        the fused step, but with an IMU every frame is host-orchestrated."""
        self._check_timestamp(stamp)
        img_args = (self._image(img), self._image(depth))
        if self.use_imu or self.state == TrackingState.NOT_INITIALIZED:
            return self._process_frame(self.build_frame(*img_args), stamp, allow_mapping, imu)
        return self._process_fused(img_args, stamp, allow_mapping)

    def process_mono(self, img, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Monocular / mono-inertial frame (`imu` as in `process`): every
        frame is host-orchestrated."""
        self._check_timestamp(stamp)
        return self._process_frame(self.build_frame(self._image(img)), stamp, allow_mapping, imu)

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32, device=self.device)

    def _info(self, n_inliers: int, n_new: int) -> dict:
        info = {"state": self.state, "n_inliers": int(n_inliers), "n_kf": self.n_kf,
                "n_points": int(self.pstore.valid.sum()), "n_lines": int(self.lstore.valid.sum()),
                "new_landmarks": int(n_new)}
        self.stats.append(info)
        return info

    def _initialize(self, frame: FrameData, stamp: float) -> dict:
        n_stereo = int((frame.stereo_ok & frame.feats.valid).sum())
        if n_stereo < self.cfg.tracking.min_init_features:
            return {"state": self.state, **_EMPTY_INFO}
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
        # the per-keyframe accumulator starts AT KF0: batches ingested before
        # (frame 0's samples lie before t0) must not leak into the KF0 -> KF1 factor
        self._preint_since_kf = None
        # KF0's view is deliberately not seeded into the triangulation ring (reference :2965)
        self._record(stamp)
        return self._info(n_stereo, n_new)

    def _initialize_mono(self, frame: FrameData, stamp: float) -> dict:
        """Two-view bootstrapping: hold the first well-featured frame, and
        reconstruct each next one against it (re-anchoring on the current
        frame while that fails); on success KF0 is the anchor at the origin
        with the normalized triangulation, and the current frame, tracked
        from the reconstructed pose, becomes KF1."""
        n_feat = int(frame.feats.valid.sum())
        if self._mono_init_frame is None:
            if n_feat >= self.cfg.tracking.min_init_features:
                self._mono_init_frame = (frame, stamp)
            self._record(stamp)
            return self._info(0, 0)
        prev, prev_stamp = self._mono_init_frame
        okf, R, t, depth1, n_inl = step_mod._mono_reconstruct(self.cam, self.cfg, prev, frame, self.draw,
                                                              len(self.trajectory) + 1)
        if not bool(okf):
            if n_feat >= self.cfg.tracking.min_init_features:
                self._mono_init_frame = (frame, stamp)
            self._record(stamp)
            return self._info(n_inl, 0)

        dev = self.device
        n, nl = prev.feats.uv.shape[0], prev.lines.angle.shape[0]
        self.pstore, self.lstore, self.kstore, n_new0 = step_mod.insert_keyframe(
            self.cam, self.cfg, dataclasses.replace(prev, depth=depth1), torch.eye(3, device=dev),
            torch.zeros(3, device=dev), prev_stamp, torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev), torch.full((nl,), -1, dtype=torch.int32, device=dev),
            torch.zeros(nl, dtype=torch.bool, device=dev), 0, self.pstore, self.lstore, self.kstore)
        self.n_kf = 1
        self._kf_views = [(prev.feats.uv, prev.feats.desc, prev.feats.valid, 0)]
        self._mono_init_frame = None
        self.state = TrackingState.OK
        self._preint_since_kf = None  # the accumulator starts at KF0, as in `_initialize`

        R2, t2, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore = step_mod.track_step(
            self.cam, self.cfg, frame, R, t, self.pstore, self.lstore, wide=torch.zeros((), dtype=torch.bool,
                                                                                       device=dev))
        self.R_prev, self.t_prev = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        self.R, self.t = R2, t2
        self._update_motion_model()
        n_new = self._create_keyframe(frame, stamp, pt_idx, pt_in, ln_idx, ln_in)
        self.last_kf_inliers = int(n_in) + n_new
        self.frames_since_kf = 0
        self._record(stamp)
        return self._info(n_in, int(n_new0) + n_new)

    def _refresh_local_map(self, kf_slot: int):
        if kf_slot < 0:
            self._local_pt = step_mod._empty_local_map(self.cfg, self.device)
            return
        self._local_pt = step_mod._local_map_ids(self.cfg, self.kstore, self.pstore, kf_slot)

    def _process_frame(self, frame: FrameData, stamp: float, allow_mapping: bool = True,
                       imu: dict | None = None) -> dict:
        """Host-orchestrated frame: every monocular and RGB-D-inertial frame,
        the first frame of the visual paths, and the stereo-inertial frames
        before the IMU initialization and after a tracking loss."""
        if self.use_imu and imu is not None:
            self._ingest_imu(imu, stamp)
        if self.state == TrackingState.NOT_INITIALIZED:
            return self._initialize_mono(frame, stamp) if self.is_mono else self._initialize(frame, stamp)
        tc = self.cfg.tracking
        lost_limit = tc.recently_lost_sec * self.cfg.fps

        if self.use_imu and self.imu_ready and self.last_preint is not None:
            prev_state = self._body_state()
            R_pred, v_pred, p_pred = imu_ops.predict_state(
                prev_state.R_wb, prev_state.v_w, prev_state.p_w, self.last_preint, self.bg, self.ba, self.gravity_w)
            init_state = inr.BodyState(R_wb=R_pred, p_w=p_pred, v_w=v_pred, bg=self.bg, ba=self.ba)
            (state2, R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore) = (
                step_mod.track_step_inertial(self.cam, self.cfg, frame, self.last_preint, prev_state, init_state,
                                             self.gravity_w, self.ext, self.pstore, self.lstore))
            n_inliers = int(n_in)
            self.R_prev, self.t_prev = self.R, self.t
            if n_inliers >= tc.min_inliers_track:
                self.R, self.t = R, t
                self.v_w, self.bg, self.ba = state2.v_w, state2.bg, state2.ba
                self.state = TrackingState.OK
                self._update_motion_model()
                self._lost_frames = 0
            else:
                # dead-reckon on the IMU, the velocity clamped to 5 m/s
                self.R, self.t = inr.camera_pose(init_state, self.ext)
                self.v_w = v_pred * torch.clamp(5.0 / torch.clamp(torch.linalg.norm(v_pred), min=1e-9), max=1.0)
                self.state = TrackingState.RECENTLY_LOST
                self._lost_frames += 1
                # tracking lost within 10 s of IMU init on a small map: the
                # gravity estimate was bad, so the map is reset
                if self._lost_frames > lost_limit and stamp - self._imu_init_stamp < 10.0 and self.n_kf <= 10:
                    self.reset_active_map()
                    info = {"state": self.state, **_EMPTY_INFO}
                    self.stats.append(info)
                    return info
                if self._lost_frames >= 3 and self._relocalize(frame):
                    n_inliers = tc.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > lost_limit:
                    self._switch_to_new_map()
        else:
            R0, t0 = self._predict_pose()
            (R, t, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore) = step_mod.track_step(
                self.cam, self.cfg, frame, R0, t0, self.pstore, self.lstore, wide=~self._use_motion_model())
            n_inliers = int(n_in)
            self.R_prev, self.t_prev = self.R, self.t
            if n_inliers >= tc.min_inliers_track:
                self.R, self.t = R, t
                self.state = TrackingState.OK
                self._update_motion_model()
                self._lost_frames = 0
            else:
                # dead-reckon on the motion model
                self.R, self.t = R0, t0
                self.state = TrackingState.RECENTLY_LOST
                self._lost_frames += 1
                if self._lost_frames >= 2 and self._relocalize(frame):
                    n_inliers = tc.min_inliers_local_map
                    self._lost_frames = 0
                elif self._lost_frames > lost_limit:
                    self._switch_to_new_map()

        # inertial bookkeeping: initialize once enough keyframes and data
        # span exist, then the staged VIBA1 / VIBA2 refinement
        if self.use_imu and self.last_preint is not None and self.state == TrackingState.OK:
            if not self.imu_ready:
                if (self._first_imu_stamp is not None
                        and stamp - self._first_imu_stamp >= self.cfg.imu.init_time_sec):
                    self._try_imu_init()
            elif self._viba_stage is not None and self._viba_stage < 2:
                if stamp - self._imu_init_stamp > (5.0 if self._viba_stage == 0 else 15.0):
                    self._full_inertial_ba()
                    self._viba_stage += 1
            elif (self.is_mono and self._viba_stage == 2 and stamp - self._imu_init_stamp < 50.0
                  and self.frames_since_kf == 0):
                # the mono scale drifts: refine scale and gravity while the map is young
                self._scale_refinement()

        self.frames_since_kf += 1
        # keyframe decision against what the reference keyframe OBSERVES
        # (its inliers plus the landmarks it created)
        need_kf = (self.state == TrackingState.OK and n_inliers >= tc.kf_min_inliers
                   and self.frames_since_kf > max(tc.kf_min_interval, 1)
                   and (self.frames_since_kf >= tc.kf_max_interval
                        or n_inliers < tc.kf_ref_ratio * max(int(self.last_kf_inliers), 1)))
        n_new = 0
        if allow_mapping and need_kf and self.n_kf < self.cfg.map.max_keyframes:
            n_new = self._create_keyframe(frame, stamp, pt_idx, pt_in, ln_idx, ln_in)
            self.last_kf_inliers = n_inliers + n_new
            self.frames_since_kf = 0
        elif self._deferred_ba:
            self.run_deferred_ba()  # one bounded chunk on a non-keyframe frame
        self._record(stamp)
        return self._info(n_inliers, n_new)

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

    def _process_fused_vi(self, img_args, stamp: float, allow_mapping: bool, imu: dict | None) -> dict:
        """One fused stereo-inertial frame (after IMU init): the whole
        preintegrate -> predict -> inertial track -> keyframe / VI-BA / BoW
        pipeline is make_step_vi; the host handles the rare paths and the
        VIBA1 / VIBA2 schedule."""
        if not self._vi_fused_active:
            self._vi_fused_active = True
            acc = self._preint_since_kf
            self._preint_acc = acc if acc is not None else imu_ops.identity_with_bias(self.bg, self.ba)
            self._preint_since_kf = None
            self.last_preint = None
        imu_packed = self._imu_batch_arrays(imu, packed=True)  # one upload per frame
        wide = self._map_event_cooldown > 0
        if wide:
            self._map_event_cooldown -= 1
        (R, t, R_prev, t_prev, self.v_w, self.bg, self.ba, self._preint_acc,
         self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev, self._local_pt, self._pints,
         _pt_idx, _pt_in, _ln_idx, _ln_in, counters, stats_dev, rel) = self._step_vi(
            img_args, imu_packed, stamp, self.R, self.t, self.v_w, self.bg, self.ba, self.gravity_w,
            self._preint_acc, self.ext, self.n_kf, self.frames_since_kf, self.last_kf_inliers, allow_mapping,
            wide, self.pstore, self.lstore, self.kstore, self.bow_db, self._kf_view_dev, self._local_pt,
            self._pints)
        self.R, self.t, self.R_prev, self.t_prev = R, t, R_prev, t_prev
        self._traj_pending.append((stamp, rel[0], rel[1], rel[2], R, t))
        info = self._finish_fused(stamp, stats_dev, img_args, counters)
        # staged refinement (VIBA1 at +5 s, VIBA2 at +15 s), queued as
        # per-frame chunks so the full-map sweep never lands on one frame
        if (self.state == TrackingState.OK and self._viba_stage is not None and self._viba_stage < 2
                and not self._deferred_ba):
            if stamp - self._imu_init_stamp > (5.0 if self._viba_stage == 0 else 15.0):
                self._deferred_ba.extend(("fiba", chunk) for chunk in self._fiba_schedule())
                self._viba_stage += 1
        return info

    def _exit_vi_fused(self):
        """Leaving the fused stereo-inertial mode (after a loss): hand the
        per-keyframe accumulator back to the host-orchestrated path."""
        self._vi_fused_active = False
        if self._preint_acc is not None:
            self._preint_since_kf = self._preint_acc
            self._preint_acc = None

    def _finish_fused(self, stamp, stats_dev, img_args, counters) -> dict:
        """Consume a fused step's stats vector (the previous frame's in
        streaming mode): shared by the visual and the stereo-inertial step."""
        # the keyframe counters are exact on the host already (see frontend.step)
        self.n_kf, self.frames_since_kf, self.last_kf_inliers = counters
        if self.streaming:
            pending, self._pending_stats = self._pending_stats, (stamp, stats_dev, img_args)
            if pending is None:
                info = {"state": self.state, **_EMPTY_INFO}
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
            kf_slot = int(stats[step_mod.ST_KF_SLOT])
            if self.loop_closer is not None:
                cands = [(int(stats[step_mod.ST_LOOP_SLOT + c]), float(stats[step_mod.ST_LOOP_SCORE + c]))
                         for c in range(step_mod.N_LOOP_CANDS)]
                self.loop_closer.on_keyframe(self, kf_slot, cands)
            self._try_merge(kf_slot)
        elif self._deferred_ba:
            self.run_deferred_ba()  # one bounded chunk on a non-keyframe frame
        info = {"state": self.state, "n_inliers": n_inliers, "n_kf": int(stats[step_mod.ST_NKF]),
                "n_points": int(stats[step_mod.ST_NPTS]), "n_lines": int(stats[step_mod.ST_NLNS]),
                "new_landmarks": int(stats[step_mod.ST_NNEW])}
        self.stats.append(info)
        return info


def _build_rectified(cam, cfg, rectifier, img_l, img_r):
    return build_frame(cam, cfg, *rectifier(img_l, img_r))


def _no_span(name: str):
    """The default `Tracker.span`: no timing."""
    return contextlib.nullcontext()


def _compose_trajectory(refs, R_cr, t_cr, R_abs, t_abs, kR, kt, kvalid):
    """Compose relative per-frame poses with the current keyframe poses."""
    R_r, t_r, ok = kR[refs], kt[refs], kvalid[refs]
    R_cw = torch.einsum("nij,njk->nik", R_cr, R_r)
    t_cw = torch.einsum("nij,nj->ni", R_cr, t_r) + t_cr
    return torch.where(ok[:, None, None], R_cw, R_abs), torch.where(ok[:, None], t_cw, t_abs)
