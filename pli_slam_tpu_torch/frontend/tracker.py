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

`_finish_fused` consumes a fused step's stats vector, the frame's one read
-- one frame late in `streaming` mode, as in the reference, so the stats
read overlaps the next frame's work. The keyframe counters then lead on
the device, chained from frame to frame; `n_kf`, `frames_since_kf` and
`last_kf_inliers` are the host's mirrors, and a rare path that reads one
while the device is ahead reads the device once (the reference's
`int(self.n_kf)`). A frame's images (and the fused stereo-inertial frame's
IMU batch) go to the device through pinned memory, so the upload never
waits for the previous frame's program.

CUDA graphs. On a GPU every fused frame (stereo, RGB-D and KB8 fisheye
stereo after the map's first frame; stereo-inertial after the IMU
initialization) replays one captured graph (frontend.graphs.FusedStep, the
counterpart of the reference's jitted step): T, the keyframe decision on
the device, and K with or without windowed BA as conditional IF nodes;
the step is captured when the tracker is constructed, with the host-path
stages the sensor's first frames run (`warm_up_fused`). The tracker's
fused-step tensors are then the graph's static buffers; a rare path
replaces them with new tensors, which are copied in before the next
replay, and the Atlas parks copies. The host-orchestrated frames run
their stages as captured graphs (frontend.graphs.StageProgram, the
counterpart of the reference's jitted stage programs): preintegration and
its composition, the frame build,
tracking (one read: inliers and the stores' counts), and on a keyframe the
insertion, windowed BA, BoW add and candidate query (one read: new
landmarks, counts, candidates), culling and the local map. The rare paths
run as stage programs too: relocalization (`reloc_match`, `reloc_pnp`,
one `reloc_track` per seed, `reloc_pick`), the loop closer's verification
and correction (`loop_match`, `loop_verify`, `loop_correct`), the full and
windowed visual-inertial BA and the "fiba" chunks (`vi_ba`, the chain
gathered on the device) and the "gba" chunks (`gba`). So do the map's
initializations: the mono two-view reconstruction (`mono_init_match`, the
draw, `mono_init`) and its first tracking (`track_init`), the mono
keyframes' triangulated depths (`mono_depths`), and the IMU
initialization's inertial-only problem with VIBA1 / VIBA2's scale
refinement (`imu_init`; the refinement padded to 8 / 16 / 32 / ...
keyframes); and the
Atlas merge (`merge_query`, `merge_match`, the draw, `merge_verify`,
`rebuild_bow`, the welding BA through `local_ba` or `vi_ba`). What stays
eager: `Atlas.merge_active_into` (the reference does not jit `merge_maps`
either) and the host's bookkeeping around the stages.

Warm-ups. Under graphs a stage is captured before the frame it serves: a
mono tracker captures its initialization's stages and `mono_depths` at
construction; an inertial tracker captures `imu_init` at `init_min_kfs`
keyframes and `vi_ba` at that count's width at construction, and both
again at the end of a frame after which the initialization may come at
another keyframe count (it runs at its exact count: the full inertial BA
after it carries any change of its rounding far, ROADMAP queue 3 A7); a
mono-inertial one its scale refinement at the end of a frame after which
the next keyframe takes the map into a wider padded width; the merge's stages are captured whenever the Atlas
gains a map, relocalization's at the first lost frame, and the loop
closer's at construction.

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
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as step_mod
from pli_slam_tpu_torch.frontend.frame import (FrameData, build_frame, build_frame_fisheye_stereo, build_frame_mono,
                                               build_frame_rgbd, empty_frame)
from pli_slam_tpu_torch.frontend.loop_closing import (LoopCloser, loop_correct, loop_match, loop_verify,
                                                      merge_match, merge_verify)
from pli_slam_tpu_torch.ops import imu as imu_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.camera import KANNALA_BRANDT8, PINHOLE, Camera
from pli_slam_tpu_torch.ops.consts import device_const
from pli_slam_tpu_torch.solve import inertial as inr
from pli_slam_tpu_torch.solve import pnp as pnp_mod
from pli_slam_tpu_torch.solve import sim3 as sim3_mod
from pli_slam_tpu_torch.solve import twoview
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
    `LoopCloser.warm_up` (its time in `loop_warmup_ms`); under CUDA graphs a
    mono or inertial tracker captures its initialization's stages there too
    (`warm_up_init`, `init_warmup_ms`), and a stereo, RGB-D, KB8 stereo or
    stereo-inertial one its fused step and its first frames' stages
    (`warm_up_fused`, `fused_warmup_ms`).

    On a GPU the fused steps (visual, RGB-D, fisheye stereo and
    stereo-inertial after IMU initialization) run as one CUDA graph each,
    captured at construction and replayed once a frame
    (frontend.graphs.FusedStep; the keyframe branch is a pair of
    conditional nodes, and the frame's one read is its stats vector).
    `cuda_graphs=False` runs them eagerly, for comparison (None: the class
    attribute `default_cuda_graphs`, True); on the CPU they always run
    eagerly. The stages of the host-orchestrated frames (the
    stereo-inertial frames before IMU initialization and after a loss,
    mono, mono- and RGB-D-inertial) run as CUDA graphs too, captured at
    their first use (frontend.graphs.StageProgram), under the same switch,
    and so do relocalization, the loop closer's verification and
    correction and the BA chunks."""

    SENSORS = ("stereo", "stereo_imu", "rgbd", "rgbd_imu", "mono", "mono_imu")
    default_cuda_graphs = True

    def __init__(self, cam: Camera, cfg: SlamConfig, device=None, rectifier=None, cam_right: Camera | None = None,
                 T_rl=None, vocab_pt=None, vocab_ln=None, cuda_graphs: bool | None = None):
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
        self.cuda_graphs = bool(self.default_cuda_graphs if cuda_graphs is None else cuda_graphs) and dev.type == "cuda"
        # the keyframe counters' host mirrors (see the `n_kf` property); set before anything assigns them
        self._n_kf = self._frames_since_kf = self._last_kf_inliers = 0
        self._counters_moved, self._counters_ahead, self._fused_last = True, False, None
        self._step = self._fused_program(step_mod.visual_segments(cam, cfg, self.voc_pt, self.voc_ln,
                                                                  self.build_frame))
        # the host-orchestrated frames' stages, sharing one graph memory pool
        self._stage_pool = torch.cuda.graph_pool_handle() if self.cuda_graphs else None
        self._stages = {name: self._program(fn, name) for name, fn in (
            ("preintegrate", partial(step_mod.preintegrate_packed, cfg)),
            ("compose", imu_ops.compose),
            ("track", partial(step_mod.host_track, cam, cfg)),
            ("track_inertial", partial(step_mod.host_track_inertial, cam, cfg)),
            ("insert", partial(step_mod.host_insert, cam, cfg)),
            ("local_ba", partial(step_mod.local_ba, cam, cfg)),
            ("bow", partial(step_mod.host_bow, cfg, self.voc_pt, self.voc_ln)),
            ("cull", partial(step_mod.cull_keyframes, cfg)),
            ("local_map", partial(step_mod._local_map_ids, cfg)),
            # the rare paths: relocalization, loop verification and correction, the BA chunks
            ("reloc_match", partial(step_mod.reloc_match, cfg, self.is_mono)),
            ("reloc_pnp", partial(step_mod.reloc_pnp, cam, cfg, self.is_mono, self.voc_pt, self.voc_ln)),
            ("reloc_track", partial(step_mod.reloc_track, cam, cfg)),
            ("reloc_pick", step_mod.reloc_pick),
            ("loop_match", loop_match),
            ("loop_verify", partial(loop_verify, cam, cfg, cfg.sensor == "mono")),
            ("loop_correct", partial(loop_correct, cfg)),
            ("vi_ba", partial(step_mod.vi_ba_window, cam, cfg)),
            ("gba", partial(step_mod.global_ba, cam, cfg)),
            # the map's initializations, the mono keyframes' depths, the Atlas merge
            ("mono_init_match", partial(step_mod.mono_init_match, cfg)),
            ("mono_init", partial(step_mod.mono_init, cam)),
            ("track_init", partial(step_mod.track_step, cam, cfg)),
            ("mono_depths", partial(step_mod.mono_depths, cam, cfg)),
            ("imu_init", partial(step_mod.imu_init, cfg, self.is_mono)),
            ("merge_query", partial(step_mod.merge_query, self.voc_pt, self.voc_ln)),
            ("merge_match", merge_match),
            ("merge_verify", merge_verify),
            ("rebuild_bow", partial(step_mod.rebuild_bow, self.voc_pt, self.voc_ln)))}
        # "imu_init": one capture per keyframe count the initialization sees and per padded width of the refinement
        self._stages["imu_init"].max_signatures = cfg.map.max_keyframes + 2 * len(
            {step_mod.imu_init_width(n, cfg.map.max_keyframes) for n in range(1, cfg.map.max_keyframes + 1)})
        self._build_stage = None  # the frame build's stage, made for the current `build_frame`
        self._counts = None  # (pstore, lstore, valid points, valid lines) of the last read
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
            self._step_vi = self._fused_program(step_mod.vi_segments(cam, cfg, self.voc_pt, self.voc_ln,
                                                                     self.build_frame))
        # a frame's images as float32 device tensors: arrays and CPU tensors go through pinned memory (a copy from
        # pageable memory would make the host wait for the device's queue, the previous frame's program included)
        self._images = graphs.PinnedUpload(dev)
        self._imu_upload = graphs.PinnedUpload(dev)  # the fused stereo-inertial frame's IMU batch
        self.loop_warmup_ms = None
        if self.loop_closer is not None and dev.type == "cuda":
            self.loop_warmup_ms = self.loop_closer.warm_up(self)
        self.reloc_warmup_ms = None  # set by the first lost frame's `warm_up_reloc` under graphs
        self.merge_warmup_ms = None  # the merge stages' warm-ups (`warm_up_merge`) summed, under graphs
        self._warmed: set[tuple] = set()  # (inertial stage, keyframe count or width) captured by `_warm_inertial`
        self.init_warmup_ms = self.warm_up_init() if self.cuda_graphs and (self.is_mono or self.use_imu) else None
        self.fused_warmup_ms = self.warm_up_fused() if self._fused_step() is not None else None

    def _fused_program(self, segs) -> graphs.FusedStep:
        return graphs.FusedStep(segs, self.device, self.cuda_graphs)

    def _fused_step(self) -> graphs.FusedStep | None:
        """The fused step this sensor runs (stereo, RGB-D and KB8 stereo: the
        visual one; stereo-inertial: the inertial one; none for the others)."""
        if self.is_mono or self.cfg.sensor == "rgbd_imu":
            return None
        return self._step_vi if self.use_imu else self._step

    # -- the keyframe counters ------------------------------------------------
    # Host mirrors of the fused step's device counters. After a fused frame the
    # device's lead (in streaming mode the host has read only the previous
    # frame's stats): reading a mirror then reads the device once, as the
    # reference's `int(self.n_kf)` does. Setting one (a host path that moves
    # the counters) marks all three to be written at the next fused frame.
    def _sync_counters(self) -> None:
        if self._counters_ahead:
            self._counters_ahead = False
            c = self._fused_last.counters
            self._n_kf, self._frames_since_kf, self._last_kf_inliers = torch.stack(
                [c["n_kf"], c["fs"], c["last"]]).tolist()

    def _set_counter(self, name: str, value) -> None:
        self._sync_counters()
        setattr(self, name, int(value))
        self._counters_moved = True

    n_kf = property(lambda self: (self._sync_counters(), self._n_kf)[1],
                    lambda self, v: self._set_counter("_n_kf", v), doc="keyframes in the active map")
    frames_since_kf = property(lambda self: (self._sync_counters(), self._frames_since_kf)[1],
                               lambda self, v: self._set_counter("_frames_since_kf", v),
                               doc="frames since the newest keyframe")
    last_kf_inliers = property(lambda self: (self._sync_counters(), self._last_kf_inliers)[1],
                               lambda self, v: self._set_counter("_last_kf_inliers", v),
                               doc="what the newest keyframe observes: its inliers plus the landmarks it created")

    def _program(self, fn, name: str) -> graphs.StageProgram:
        return graphs.StageProgram(fn, self.device, self.cuda_graphs, name, self._stage_pool)

    def _build_host(self, *images) -> FrameData:
        """A host-path frame's build through its stage (`build_frame` may be
        replaced after construction: the stage follows it)."""
        if self._build_stage is None or self._build_stage.fn is not self.build_frame:
            self._build_stage = self._program(self.build_frame, "build_frame")
        return self._build_stage(*images)

    def stage_programs(self) -> list[graphs.StageProgram]:
        """Every stage program the host-orchestrated frames have used."""
        return list(self._stages.values()) + ([self._build_stage] if self._build_stage is not None else [])

    def _dev(self, x, dtype=torch.int32) -> torch.Tensor:
        """A per-call host value (slot, count, stamp, flag) as a 0-d device tensor."""
        return torch.full((), x, dtype=dtype, device=self.device)

    def _empty_bow_db(self):
        return vocab_mod.BowDatabase.empty(self.cfg.map.max_keyframes, self.voc_pt.n_words, self.device,
                                           n_words_ln=self.voc_ln.n_words)

    # -- pose helpers --------------------------------------------------------
    def _update_motion_model(self):
        self.vel_xi = step_mod._motion_twist(self.R, self.t, self.R_prev, self.t_prev)
        self.has_vel = torch.ones((), dtype=torch.bool, device=self.device)

    def _reset_motion(self):
        self.has_vel = torch.zeros((), dtype=torch.bool, device=self.device)

    # -- trajectory ----------------------------------------------------------
    def finalize(self):
        """End of run: drain the deferred BA chunks, so that saved poses
        reflect the fully refined map, and read the stats of a fused frame
        still pending (streaming), so that its kernel launches are counted."""
        if self._deferred_ba:
            self.run_deferred_ba(max_chunks=len(self._deferred_ba))
        fused = self._fused_step()
        if fused is not None:
            fused.settle()

    @property
    def trajectory(self) -> list[tuple[float, np.ndarray, np.ndarray]]:
        """(stamp, R_wc, p_w) per recorded frame; relative poses are composed
        with the CURRENT keyframe poses, so BA refinements reach every frame."""
        if self._traj_pending:
            pend, self._traj_pending = self._traj_pending, []
            # a fused frame's reference keyframe is the step's own (a device scalar), a host-path frame's a host int
            refs = torch.stack([r if isinstance(r, torch.Tensor) else self._dev(r) for _, r, *_ in pend]).long()
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
        one [T, 8] tensor g | a | dt | mask of the fused step instead of four,
        uploaded through pinned memory (`_imu_upload`)."""
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
            return self._imu_upload(np.concatenate([g, a, dts[:, None], mask[:, None].astype(np.float32)], axis=1))[0]
        return tuple(torch.from_numpy(x).to(self.device) for x in (g, a, dts, mask))

    def _ingest_imu(self, imu: dict, stamp: float):
        """Preintegrate this frame's IMU batch with the current biases and
        add it to the per-keyframe accumulator."""
        self.last_preint = self._stages["preintegrate"](self._imu_batch_arrays(imu, packed=True), self.bg, self.ba)
        if self._preint_since_kf is None:
            self._preint_since_kf = self.last_preint
        else:
            self._preint_since_kf = self._stages["compose"](self._preint_since_kf, self.last_preint)

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
            self._run_vi_ba(window, fixed)
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
        """Visual-inertial BA over `window` (host-computed slots and their
        fixed flags, uploaded) through the "vi_ba" stage: the chain gathered
        and keyframes culled since the window was drawn pinned on the device."""
        dev = self.device
        self.kstore, self.pstore, self.lstore = self._stages["vi_ba"](
            self.kstore, self.pstore, self.lstore, self._pints,
            torch.as_tensor(window, dtype=torch.int32, device=dev), torch.as_tensor(fixed, device=dev),
            self.gravity_w, self.ext)

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
                    self.kstore, self.pstore, self.lstore = self._stages["gba"](self.kstore, self.pstore,
                                                                                self.lstore, arg)
                else:
                    self._run_vi_ba(*arg)
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
        Stages 1-2 are the "imu_init" stage (one read); stage 3 runs the
        "vi_ba" stage. VIBA1 / VIBA2 follow at +5 s / +15 s. Appends one
        record to `imu_init_log`."""
        t0 = time.perf_counter()

        def log(accepted, reason, **kw):
            self.imu_init_log.append({"n_kf": int(self.n_kf), "accepted": bool(accepted), "reason": reason,
                                      "wall_ms": (time.perf_counter() - t0) * 1e3, **kw})

        n = self.n_kf
        # a thin keyframe set under-constrains the inertial-only MAP problem
        if n < self.cfg.imu.init_min_kfs:
            return log(False, "too_few_keyframes")
        fix_scale = not self.is_mono
        g_w, bg, ba, v, read = self._imu_init_stage(n, None, fix_scale, fix_bias=False)
        n_live, scale, finite, cost0, cost1 = read.tolist()  # the stage's one read
        if n_live < 3:
            return log(False, "too_few_preintegrations")
        if not finite:
            return log(False, "nonfinite_gravity")
        self.gravity_w = g_w
        self.bg = bg
        self.ba = ba
        v = v[:n]
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
            ba=ba.cpu().numpy().tolist(), cost0=cost0, cost1=cost1)

    def _imu_init_stage(self, n: int, gravity_w, fix_scale: bool, fix_bias: bool):
        """The "imu_init" stage over the first `n` keyframes: (g_w, bg, ba, v
        [width, 3], read), see frontend.step.imu_init. The scale refinement
        (`fix_bias`) runs padded to its width; the initialization at exactly
        `n` keyframes, since the full inertial BA after it carries any change
        of its rounding far (ROADMAP queue 3 A7)."""
        width = step_mod.imu_init_width(n, self.cfg.map.max_keyframes) if fix_bias else n
        return self._stages["imu_init"](self.kstore, self._pints, self.ext, self._dev(n), gravity_w, self.bg, self.ba,
                                        width, fix_scale, fix_bias)

    def _scale_refinement(self, fix_scale: bool = False):
        """Scale and gravity-direction refinement over the keyframe chain,
        the biases pinned (`fix_bias`): the map is rescaled when the
        correction exceeds 0.2%. With `fix_scale` only the gravity direction
        and the velocities are refined. The "imu_init" stage in its
        refinement mode, seeded with the current gravity and velocities."""
        n = self.n_kf
        if n < 4 or self.gravity_w is None:
            return
        g_w, _bg, _ba, v, read = self._imu_init_stage(n, self.gravity_w, fix_scale, fix_bias=True)
        n_live, scale, finite, _, _ = read.tolist()  # the stage's one read
        if n_live < 3 or not np.isfinite(scale) or scale <= 1e-3 or not finite:
            return
        self.gravity_w = g_w
        v = v[:n]
        if not fix_scale and abs(scale - 1.0) > 0.002:
            self._apply_scale(scale)
            v = v * scale
        v_all = self.kstore.v_w.clone()
        v_all[:n] = v
        self.kstore = dataclasses.replace(self.kstore, v_w=v_all)
        self.v_w = v[n - 1]

    # -- Atlas: a new map on persistent loss, merging back -------------------
    def _park_active(self):
        # copies: under CUDA graphs the live stores are the graphs' buffers, which the next replay overwrites
        self.atlas.maps[self.atlas.active_idx] = MapBundle(
            pstore=graphs.tree_clone(self.pstore), lstore=graphs.tree_clone(self.lstore),
            kstore=graphs.tree_clone(self.kstore), n_kf=self.n_kf, bow_db=graphs.tree_clone(self.bow_db))

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
        if self.cuda_graphs:  # the Atlas gained a map: the next keyframes may merge
            self.merge_warmup_ms = (self.merge_warmup_ms or 0.0) + self.warm_up_merge()

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

    def _parked_dbs(self) -> tuple[list[int], tuple]:
        """The parked maps that place recognition can find (their indices) and their BoW databases."""
        found = [(mi, b.bow_db) for mi, b in enumerate(self.atlas.maps)
                 if mi != self.atlas.active_idx and b.bow_db is not None]
        return [mi for mi, _ in found], tuple(db for _, db in found)

    def warm_up_merge(self) -> float:
        """Run the merge's stages once on the tracker's stores and the parked
        maps', results dropped: under CUDA graphs that captures them (the
        query for the current number of parked maps), so that a merge frame
        only replays. Returns its wall time in ms, the device synchronised
        at the end."""
        t0 = time.perf_counter()
        st_, dev, cfg = self._stages, self.device, self.cfg
        cand_maps, dbs = self._parked_dbs()
        if dbs:
            zero = self._dev(0)
            st_["merge_query"](self.kstore, self.pstore, self.lstore, zero, dbs)
            dst = self.atlas.maps[cand_maps[0]]
            x, y, idx_b, m, _ = st_["merge_match"](self.kstore, self.pstore, zero, dst.kstore, dst.pstore, zero)
            hyp = torch.zeros((cfg.loop.sim3_hypotheses, 3), dtype=torch.int64, device=dev)
            st_["merge_verify"](self.kstore, zero, x, y, idx_b, m, hyp)
            st_["rebuild_bow"](self.kstore, self.pstore, self.lstore)
            W = cfg.opt.local_ba_window
            window = torch.zeros(W, dtype=torch.int32, device=dev)
            fixed = torch.ones(W, dtype=torch.bool, device=dev)
            if self.use_imu:
                st_["vi_ba"](self.kstore, self.pstore, self.lstore, self._pints, window, fixed, self._gravity0(),
                             self.ext)
            st_["local_ba"](self.kstore, self.pstore, self.lstore, window, fixed)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def _try_merge(self, kf_slot: int) -> bool:
        """Query the parked maps' BoW databases with the new keyframe; on a
        hit that persists over two keyframes, verify with SE3 RANSAC over
        cross-map landmark matches and weld the active map into the parked
        one, the verified matches fused, then a welding BA across the seam.
        Stages: `merge_query` (all parked maps, one read), `merge_match`,
        the draw on the host, `merge_verify` (one read), `rebuild_bow`, the
        welding BA."""
        if self.atlas.n_maps() <= 1 or self.n_kf < 2:
            return False
        st_ = self._stages
        cand_maps, dbs = self._parked_dbs()
        kf = self._dev(kf_slot)
        best = (-1, -1, -1.0)
        if dbs:
            found = st_["merge_query"](self.kstore, self.pstore, self.lstore, kf, dbs)
            for mi, (slot_f, score) in zip(cand_maps, found.cpu().numpy()):  # one read for all maps
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
        xa, xb, idx_b, m, probs = st_["merge_match"](self.kstore, self.pstore, kf, dst.kstore, dst.pstore,
                                                     self._dev(k_dst))
        hyp = self.draw(1000 + kf_slot, probs, (self.cfg.loop.sim3_hypotheses, 3))
        R_rel, t_rel, fuse_src, fuse_dst, read = st_["merge_verify"](self.kstore, kf, xa, xb, idx_b, m, hyp)
        if int(read[0]) < self.cfg.loop.sim3_min_inliers:  # the stage's one read
            return False

        self._flush_trajectory()  # keyframe slots are about to be remapped
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
            self.kstore, self.pstore, self.lstore = self._stages["local_ba"](
                self.kstore, self.pstore, self.lstore, torch.as_tensor(window, device=dev),
                torch.as_tensor(fixed, device=dev))
        self.R, self.t = self.kstore.R[self.n_kf - 1], self.kstore.t[self.n_kf - 1]

    def rebuild_bow(self):
        """Recompute the BoW database from the landmark stores (after a merge;
        the "rebuild_bow" stage)."""
        self.bow_db = self._stages["rebuild_bow"](self.kstore, self.pstore, self.lstore)
        if self.n_kf > 0:
            self._refresh_local_map(self.n_kf - 1)

    # -- relocalization ---------------------------------------------------------
    def _note_lost(self):
        """Count a lost frame. The first one, when the relocalization stages
        are captured programs, captures them (`warm_up_reloc`): a later lost
        frame's relocalization then only replays, and a tracker that never
        loses tracking never pays for them (~3 s and ~0.85 GiB of graph pool
        at 752x480 on an H100)."""
        self._lost_frames += 1
        if self.reloc_warmup_ms is None and self._stages["reloc_track"].graphs:
            self.reloc_warmup_ms = self.warm_up_reloc()

    def warm_up_reloc(self) -> float:
        """Run the relocalization stages once on an empty frame and the
        tracker's stores, results dropped, for every number of seeds: under
        CUDA graphs that captures them, so that a relocalization frame only
        replays. Returns its wall time in ms, the device synchronised at the
        end."""
        t0 = time.perf_counter()
        st_, dev = self._stages, self.device
        frame = empty_frame(self.cfg, dev)
        idx, okm, _ = st_["reloc_match"](frame, self.pstore)
        hyp = torch.zeros((pnp_mod.N_HYPOTHESES, 6 if self.is_mono else 3), dtype=torch.int64, device=dev)
        R, t, _ = st_["reloc_pnp"](frame, self.pstore.x, idx, okm, hyp, self.bow_db)
        R, t, n_in, _, _ = st_["reloc_track"](frame, R, t, self.pstore, self.lstore, self._dev(True, torch.bool))
        for n_seeds in range(1, 2 + self.cfg.loop.bow_candidates):
            st_["reloc_pick"](self.kstore, self._dev(0), [n_in] * n_seeds, [R] * n_seeds, [t] * n_seeds)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def warm_up_init(self) -> float:
        """Run the map initializations' stages once on an empty frame and the
        tracker's stores, results dropped: under CUDA graphs that captures
        them, so that the frame that initializes a mono map, its keyframes
        and the IMU initialization only replay. Mono: `mono_init_match`,
        `mono_init`, `track_init`, `mono_depths` and the host-path stages its
        first frames and keyframes run (`_warm_host_stages`); inertial:
        `imu_init` at `init_min_kfs` keyframes and `vi_ba` at that count's
        width (`_warm_inertial`). Returns its wall time in ms, the device
        synchronised at the end."""
        t0 = time.perf_counter()
        st_, dev, cfg = self._stages, self.device, self.cfg
        if self.is_mono:
            frame = empty_frame(cfg, dev)
            idx, ok, _ = st_["mono_init_match"](frame, frame)
            hyp_f = torch.zeros((twoview.N_HYPOTHESES, 8), dtype=torch.int64, device=dev)
            R, t, _, _ = st_["mono_init"](frame, frame, idx, ok, hyp_f, hyp_f[:, :4].contiguous())
            st_["track_init"](frame, R, t, self.pstore, self.lstore, self._dev(False, torch.bool))
            st_["mono_depths"](frame, R, t, frame.feats.uv, frame.feats.desc, frame.feats.valid, self._dev(0),
                               self.kstore.R, self.kstore.t)
            self._warm_host_stages(frame)
        if self.use_imu:
            self._warm_inertial(cfg.imu.init_min_kfs, ("init", "vi_ba"))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def _blank_images(self) -> tuple:
        cam = self.cam_raw
        return tuple(torch.zeros((cam.height, cam.width), device=self.device) for _ in range(2))

    def warm_up_fused(self) -> float:
        """Under CUDA graphs, capture the sensor's fused step on the empty
        stores and blank images (`FusedStep.prepare`), and the host-path
        stages its first frames run (the frame build, `_warm_host_stages`,
        and for the stereo-inertial sensor the preintegration and its
        composition), results dropped: no capture then lands inside a
        frame. Returns its wall time in ms, the device synchronised at the
        end."""
        t0 = time.perf_counter()
        fused, dev = self._fused_step(), self.device
        imgs = self._blank_images()
        if fused.graphs:
            names = self._VI_STATE if self.use_imu else self._VISUAL_STATE
            state = {k: getattr(self, a) for k, a in names.items()}
            inputs = dict(img=imgs, stamp=0.0, allow=True)
            if self.use_imu:
                state.update(gravity_w=self._gravity0(), preint_acc=imu_ops.identity_with_bias(self.bg, self.ba))
                inputs.update(imu=torch.zeros((self._imu_pad, 8), device=dev), wide=False)
            fused.prepare(state, inputs)
        if self._stages["track"].graphs:
            self._warm_host_stages(self._build_host(*imgs))
            if self.use_imu:
                p = self._stages["preintegrate"](torch.zeros((self._imu_pad, 8), device=dev), self.bg, self.ba)
                self._stages["compose"](p, p)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) * 1e3

    def _warm_host_stages(self, frame: FrameData) -> None:
        """The host-path stages of a map's first frames and keyframes, run once
        on `frame` and the tracker's stores, results dropped: tracking,
        insertion (matched to nothing, as a map's first keyframe, and to the
        tracking's matches), windowed BA, the BoW add and query, culling, the
        local map."""
        st_, dev = self._stages, self.device
        kf = self._dev(0)
        o = st_["track"](frame, self.R, self.t, self.vel_xi, self.has_vel, self.pstore, self.lstore)
        for m in (self._no_matches(frame), o["matches"]):
            ps, ls, ks, n_new = st_["insert"](frame, self.R, self.t, self._dev(0.0, torch.float32), m, kf, self.pstore,
                                              self.lstore, self.kstore, self.v_w, self.bg, self.ba,
                                              self._dev(self.use_imu, torch.bool))
        W = self.cfg.opt.local_ba_window
        st_["local_ba"](ks, ps, ls, torch.zeros(W, dtype=torch.int32, device=dev),
                        torch.ones(W, dtype=torch.bool, device=dev))
        st_["bow"](self.bow_db, ks, frame.feats.desc, frame.feats.valid, frame.lines.desc, frame.lines.valid, kf, kf,
                   n_new, ps.valid, ls.valid)
        st_["cull"](ks, ps, kf)
        st_["local_map"](ks, ps, kf)

    def _warm_inertial(self, n: int, kinds: tuple) -> None:
        """Under CUDA graphs, capture the inertial stages `kinds` for a map of
        `n` keyframes, results dropped, unless captured already: "init" the
        IMU initialization at exactly `n` keyframes (`imu_init`), "vi_ba" the
        visual-inertial BA at `_fiba_schedule`'s width and at the keyframes'
        window (a host-path keyframe's BA, which the initialization's own
        frame may run), "refine" mono's scale refinement at its padded
        width."""
        st_, dev = self._stages, self.device
        if not st_["imu_init"].graphs:
            return
        widths = {"init": (n,), "refine": (step_mod.imu_init_width(n, self.cfg.map.max_keyframes),),
                  "vi_ba": (next((c for c in self._FIBA_CAPS if c >= n), self._FIBA_CAPS[-1]),
                            self.cfg.opt.local_ba_window)}
        g0, args = self._gravity0(), (self.kstore, self._pints, self.ext, self._dev(n))
        for kind, k in ((kind, k) for kind in kinds for k in widths[kind]):
            if (kind, k) in self._warmed:
                continue
            self._warmed.add((kind, k))
            if kind == "vi_ba":
                window = torch.arange(k, dtype=torch.int32, device=dev)
                st_["vi_ba"](self.kstore, self.pstore, self.lstore, self._pints, window,
                             torch.ones(k, dtype=torch.bool, device=dev), g0, self.ext)
            else:
                st_["imu_init"](*args, g0 if kind == "refine" else None, self.bg, self.ba, k,
                                not self.is_mono and kind == "init", kind == "refine")

    def _warm_ahead(self, stamp: float) -> None:
        """At the end of a host-path frame of an inertial tracker, capture what
        the next frames may run at the map's keyframe count
        (`_warm_inertial`): before the IMU initialization, when the next
        frame may run it (its time comes within one and a half frame periods,
        the map holds enough keyframes), the initialization at the count it
        will see and its full inertial BA; for mono, while the scale
        refinement runs (after VIBA2, for 50 s), the refinement at the
        map's padded width and at the next keyframe's."""
        cfg = self.cfg.imu
        if not self.imu_ready:
            if (self._first_imu_stamp is not None and self.n_kf >= cfg.init_min_kfs
                    and stamp + 1.5 / self.cfg.fps >= self._first_imu_stamp + cfg.init_time_sec):
                self._warm_inertial(self.n_kf, ("init", "vi_ba"))
        elif self.is_mono and self._viba_stage == 2 and stamp - self._imu_init_stamp < 50.0:
            for n in (self.n_kf, self.n_kf + 1):  # the next frame's refinement, and the one after a keyframe
                self._warm_inertial(n, ("refine",))

    def _gravity0(self) -> torch.Tensor:
        """The world gravity vector of a gravity-aligned world: the warm-ups' stand-in for `gravity_w`."""
        g = self.cfg.imu.gravity
        return device_const(("gravity_vector", g), self.device, lambda: [0.0, 0.0, -g])

    def _relocalize(self, frame: FrameData) -> bool:
        """Seeds: the PnP pose (if its RANSAC clears its floor) and the BoW
        candidates' keyframe poses. Every seed gets a wide re-track and the
        best one is kept if it reaches min_inliers_local_map; the local map
        is then re-anchored at the keyframe nearest by |t_cw|. Stages:
        `reloc_match` (pose-free matching against the whole point store),
        the draw on the host, `reloc_pnp` (PnP, mono: the depth-free DLT,
        and the BoW query; one read), one `reloc_track` per seed in the
        seeds' order with no read between them, `reloc_pick` (the best seed
        and the nearest keyframe; one read), `local_map`."""
        if self.n_kf == 0:
            return False
        with self.span("reloc"):
            st_ = self._stages
            idx, okm, probs = st_["reloc_match"](frame, self.pstore)
            hyp = self.draw(7000 + len(self.stats), probs, (pnp_mod.N_HYPOTHESES, 6 if self.is_mono else 3))
            Rp, tp, read = st_["reloc_pnp"](frame, self.pstore.x, idx, okm, hyp, self.bow_db)
            okp, cands = step_mod.reloc_read(read.cpu().numpy(), self.cfg.loop.bow_candidates)
            seeds = [(Rp, tp)] if okp else []
            seeds += [(self.kstore.R[k], self.kstore.t[k]) for k, score in cands if k >= 0 and score > 0.05]
            if not seeds:
                return False
            wide = self._dev(True, torch.bool)
            n_ins, Rs, ts = [], [], []
            for R0, t0 in seeds:
                R, t, n_in, self.pstore, self.lstore = st_["reloc_track"](frame, R0, t0, self.pstore, self.lstore,
                                                                           wide)
                n_ins.append(n_in)
                Rs.append(R)
                ts.append(t)
            R, t, read = st_["reloc_pick"](self.kstore, self._dev(self.n_kf), n_ins, Rs, ts)
            best_n, _, kf_near = read.tolist()  # the attempt's last read
            if best_n <= 0 or best_n < self.cfg.tracking.min_inliers_local_map:
                return False
            self.R, self.t = R, t
            self._reset_motion()
            self.state = TrackingState.OK
            self._refresh_local_map(kf_near)
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
    def _create_keyframe(self, frame, stamp, matches) -> int:
        """A host-path keyframe from the frame's tracking `matches` (pt_idx,
        pt_in, ln_idx, ln_in): insertion (with the inertial state), the
        chain factor, windowed BA, BoW add and candidate query, the loop
        closer, a merge attempt, culling, the local map. Returns the number
        of new landmarks."""
        if self.is_mono and self._kf_views:
            # no depth channel: triangulate against the view three keyframes
            # back (consecutive keyframes carry too little parallax), its pose
            # read live from the store (windowed BA refines it)
            uvk, desck, validk, slotk = self._kf_views[0]
            depth = self._stages["mono_depths"](frame, self.R, self.t, uvk, desck, validk, self._dev(slotk),
                                                self.kstore.R, self.kstore.t)
            frame = dataclasses.replace(frame, depth=depth)
        kf = self._dev(self.n_kf)
        self.pstore, self.lstore, self.kstore, n_new = self._stages["insert"](
            frame, self.R, self.t, self._dev(stamp, torch.float32), matches, kf, self.pstore, self.lstore,
            self.kstore, self.v_w, self.bg, self.ba, self._dev(self.use_imu, torch.bool))
        if self.use_imu:
            k = self.n_kf
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
                self.kstore, self.pstore, self.lstore = self._stages["local_ba"](
                    self.kstore, self.pstore, self.lstore, torch.as_tensor(window, dtype=torch.int32, device=dev),
                    torch.as_tensor(fixed, device=dev))
            # tracking continues from the refined latest keyframe
            self.R, self.t = self.kstore.R[k], self.kstore.t[k]
        if self.is_mono:
            self._kf_views = (self._kf_views + [(frame.feats.uv, frame.feats.desc, frame.feats.valid,
                                                 self.n_kf - 1)])[-3:]
        n_kf = self._dev(self.n_kf)
        self.bow_db, _, _, read = self._stages["bow"](
            self.bow_db, self.kstore, frame.feats.desc, frame.feats.valid, frame.lines.desc, frame.lines.valid, kf,
            n_kf, n_new, self.pstore.valid, self.lstore.valid)
        n_new, n_points, n_lines, cands = step_mod.keyframe_read(read.cpu().numpy())  # the keyframe's one read
        self._counts = (self.pstore, self.lstore, n_points, n_lines)
        if self.loop_closer is not None:
            self.loop_closer.on_keyframe(self, self.n_kf - 1, cands)
        self._try_merge(self.n_kf - 1)
        self.kstore = self._stages["cull"](self.kstore, self.pstore, n_kf)
        self._refresh_local_map(self.n_kf - 1)
        return n_new

    # -- main entries ---------------------------------------------------------
    def process(self, img_l, img_r, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Stereo / stereo-inertial frame. Images are [H, W] float32 in
        [0, 255], numpy or tensors; they are moved to `device`. `imu` is this
        frame's raw batch {"gyro" [n,3], "acc" [n,3], "stamps" [n]} covering
        (previous frame, this frame]; the visual sensor ignores it."""
        self._check_timestamp(stamp)
        img_args = self._images(img_l, img_r)
        if self.use_imu:
            # after IMU init the frames run the fused stereo-inertial step;
            # before it, and after a loss, they are host-orchestrated
            if self.imu_ready and self.gravity_w is not None and self.state == TrackingState.OK:
                return self._process_fused_vi(img_args, stamp, allow_mapping, imu)
            if self._vi_fused_active:
                self._exit_vi_fused()
            return self._process_frame(self._build_host(*img_args), stamp, allow_mapping, imu)
        if self.state == TrackingState.NOT_INITIALIZED:
            return self._initialize(self._build_host(*img_args), stamp)
        return self._process_fused(img_args, stamp, allow_mapping)

    def process_rgbd(self, img, depth, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """RGB-D frame: `img` [H, W] float32 in [0, 255] and `depth` [H, W]
        in metres (0 where unknown), numpy or tensors; `imu` as in
        `process`. The map initializes on the host path; later frames run
        the fused step, but with an IMU every frame is host-orchestrated."""
        self._check_timestamp(stamp)
        img_args = self._images(img, depth)
        if self.use_imu or self.state == TrackingState.NOT_INITIALIZED:
            return self._process_frame(self._build_host(*img_args), stamp, allow_mapping, imu)
        return self._process_fused(img_args, stamp, allow_mapping)

    def process_mono(self, img, stamp: float, allow_mapping: bool = True, imu: dict | None = None) -> dict:
        """Monocular / mono-inertial frame (`imu` as in `process`): every
        frame is host-orchestrated."""
        self._check_timestamp(stamp)
        return self._process_frame(self._build_host(*self._images(img)), stamp, allow_mapping, imu)

    def _info(self, n_inliers: int, n_new: int) -> dict:
        """The frame's record. The stores' counts come from the frame's last
        read unless a path after it replaced a store."""
        c = self._counts
        if c is not None and c[0] is self.pstore and c[1] is self.lstore:
            n_points, n_lines = c[2], c[3]
        else:
            n_points, n_lines = int(self.pstore.valid.sum()), int(self.lstore.valid.sum())
        info = {"state": self.state, "n_inliers": int(n_inliers), "n_kf": self.n_kf, "n_points": n_points,
                "n_lines": n_lines, "new_landmarks": int(n_new)}
        self.stats.append(info)
        return info

    def _initialize(self, frame: FrameData, stamp: float) -> dict:
        n_stereo = int((frame.stereo_ok & frame.feats.valid).sum())
        if n_stereo < self.cfg.tracking.min_init_features:
            return {"state": self.state, **_EMPTY_INFO}
        self.pstore, self.lstore, self.kstore, n_new = self._stages["insert"](
            frame, self.R, self.t, self._dev(stamp, torch.float32), self._no_matches(frame), self._dev(self.n_kf),
            self.pstore, self.lstore, self.kstore, self.v_w, self.bg, self.ba, self._dev(False, torch.bool))
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

    def _no_matches(self, frame: FrameData) -> tuple:
        """(pt_idx, pt_in, ln_idx, ln_in) of a frame matched to nothing (a map's first keyframe)."""
        dev = self.device
        n, nl = frame.feats.uv.shape[0], frame.lines.angle.shape[0]
        return (torch.full((n,), -1, dtype=torch.int32, device=dev), torch.zeros(n, dtype=torch.bool, device=dev),
                torch.full((nl,), -1, dtype=torch.int32, device=dev), torch.zeros(nl, dtype=torch.bool, device=dev))

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
        st_ = self._stages
        idx, ok, probs = st_["mono_init_match"](prev, frame)
        seed = len(self.trajectory) + 1
        hyp_f, hyp_h = (self.draw(seed, probs, (twoview.N_HYPOTHESES, k)) for k in (8, 4))
        R, t, depth1, read = st_["mono_init"](prev, frame, idx, ok, hyp_f, hyp_h)
        okf, n_inl = read.tolist()  # the stage's one read
        if not okf:
            if n_feat >= self.cfg.tracking.min_init_features:
                self._mono_init_frame = (frame, stamp)
            self._record(stamp)
            return self._info(n_inl, 0)

        dev = self.device
        self.pstore, self.lstore, self.kstore, n_new0 = self._stages["insert"](
            dataclasses.replace(prev, depth=depth1), torch.eye(3, device=dev), torch.zeros(3, device=dev),
            self._dev(prev_stamp, torch.float32), self._no_matches(prev), self._dev(0), self.pstore, self.lstore,
            self.kstore, self.v_w, self.bg, self.ba, self._dev(False, torch.bool))
        self.n_kf = 1
        self._kf_views = [(prev.feats.uv, prev.feats.desc, prev.feats.valid, 0)]
        self._mono_init_frame = None
        self.state = TrackingState.OK
        self._preint_since_kf = None  # the accumulator starts at KF0, as in `_initialize`

        R2, t2, pt_idx, pt_in, ln_idx, ln_in, n_in, self.pstore, self.lstore = st_["track_init"](
            frame, R, t, self.pstore, self.lstore, self._dev(False, torch.bool))
        self.R_prev, self.t_prev = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        self.R, self.t = R2, t2
        self._update_motion_model()
        n_new = self._create_keyframe(frame, stamp, (pt_idx, pt_in, ln_idx, ln_in))
        self.last_kf_inliers = int(n_in) + n_new
        self.frames_since_kf = 0
        self._record(stamp)
        return self._info(n_in, int(n_new0) + n_new)

    def _tracked(self, o: dict) -> int:
        """Adopt a tracking stage's stores and, if it held, its pose and the
        motion model; the frame's one read before the keyframe decision.
        Returns the inlier count."""
        self.pstore, self.lstore = o["pstore"], o["lstore"]
        n_in, n_points, n_lines = o["read"].tolist()
        self._counts = (self.pstore, self.lstore, n_points, n_lines)
        self.R_prev, self.t_prev = self.R, self.t
        if n_in >= self.cfg.tracking.min_inliers_track:
            self.R, self.t = o["R"], o["t"]
            self.state = TrackingState.OK
            self.vel_xi = o["vel_xi"]
            self.has_vel = torch.ones((), dtype=torch.bool, device=self.device)
            self._lost_frames = 0
        return n_in

    def _refresh_local_map(self, kf_slot: int):
        if kf_slot < 0:
            self._local_pt = step_mod._empty_local_map(self.cfg, self.device)
            return
        self._local_pt = self._stages["local_map"](self.kstore, self.pstore, self._dev(kf_slot))

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
            o = self._stages["track_inertial"](frame, self.last_preint, self.R, self.t, self.v_w, self.bg, self.ba,
                                               self.gravity_w, self.ext, self.pstore, self.lstore)
            n_inliers = self._tracked(o)
            if n_inliers >= tc.min_inliers_track:
                self.v_w, self.bg, self.ba = o["v_w"], o["bg"], o["ba"]
            else:
                # dead-reckon on the IMU, the velocity clamped to 5 m/s
                self.R, self.t, self.v_w = o["R0"], o["t0"], o["v0"]
                self.state = TrackingState.RECENTLY_LOST
                self._note_lost()
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
            o = self._stages["track"](frame, self.R, self.t, self.vel_xi, self.has_vel, self.pstore, self.lstore)
            n_inliers = self._tracked(o)
            if n_inliers < tc.min_inliers_track:
                # dead-reckon on the motion model
                self.R, self.t = o["R0"], o["t0"]
                self.state = TrackingState.RECENTLY_LOST
                self._note_lost()
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
            n_new = self._create_keyframe(frame, stamp, o["matches"])
            self.last_kf_inliers = n_inliers + n_new
            self.frames_since_kf = 0
        elif self._deferred_ba:
            self.run_deferred_ba()  # one bounded chunk on a non-keyframe frame
        if self.use_imu:
            self._warm_ahead(stamp)
        self._record(stamp)
        return self._info(n_inliers, n_new)

    # the tracker's attribute for each entry of a fused step's state
    _FUSED_STATE = dict(R="R", t="t", R_prev="R_prev", t_prev="t_prev", pstore="pstore", lstore="lstore",
                        kstore="kstore", bow_db="bow_db", kf_view="_kf_view_dev", local_pt="_local_pt")
    _VISUAL_STATE = dict(_FUSED_STATE, vel_xi="vel_xi", has_vel="has_vel")
    _VI_STATE = dict(_FUSED_STATE, v_w="v_w", bg="bg", ba="ba", gravity_w="gravity_w", preint_acc="_preint_acc",
                     ext="ext", pints="_pints")

    def _run_fused(self, fused: graphs.FusedStep, names: dict, inputs: dict, stamp: float) -> graphs.FrameStats:
        """One fused frame: the step on the tracker's state, which the tracker
        then adopts (under CUDA graphs, the graphs' buffers), with the
        keyframe counters a host path moved since the last fused frame; the
        frame's record relative to the step's reference keyframe. Returns the
        frame's stats on their way to the host."""
        if self._counters_moved or fused is not self._fused_last:
            fused.set_counters(self._n_kf, self._frames_since_kf, self._last_kf_inliers)
            self._counters_moved = False
        state = {k: getattr(self, a) for k, a in names.items()}
        s, rec, stats = fused(state, inputs)
        for k, a in names.items():
            setattr(self, a, s[k])
        self._fused_last, self._counters_ahead = fused, True
        self._traj_pending.append((stamp, rec["ref"], rec["rel_R"], rec["rel_t"], self.R.clone(), self.t.clone()))
        return stats

    def _process_fused(self, img_args, stamp: float, allow_mapping: bool) -> dict:
        stats = self._run_fused(self._step, self._VISUAL_STATE,
                                dict(img=tuple(img_args), stamp=stamp, allow=bool(allow_mapping)), stamp)
        return self._finish_fused(stamp, stats, img_args)

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
        stats = self._run_fused(self._step_vi, self._VI_STATE,
                                dict(img=tuple(img_args), imu=imu_packed, stamp=stamp, allow=bool(allow_mapping),
                                     wide=wide), stamp)
        info = self._finish_fused(stamp, stats, img_args)
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

    def _finish_fused(self, stamp, stats: graphs.FrameStats, img_args) -> dict:
        """Consume a fused step's stats vector, the frame's one read -- the
        previous frame's in streaming mode, as in the reference (its
        `_finish_fused`): the device's counters then stay ahead, chained into
        the next frame, and code that needs the current count reads it (see
        `n_kf`). Without streaming the host's counter mirrors are set from
        the stats. Shared by the visual and the stereo-inertial step."""
        if self.streaming:
            pending, self._pending_stats = self._pending_stats, (stamp, stats, img_args)
            if pending is None:
                info = {"state": self.state, **_EMPTY_INFO}
                self.stats.append(info)
                return info
            _, stats, img_args = pending
        stats = stats.read()
        # the mirrors as the read frame left the counters (the frame just launched may have moved them since)
        self._n_kf, self._frames_since_kf, self._last_kf_inliers = (
            int(stats[step_mod.ST_NKF]), int(stats[step_mod.ST_FSKF]), int(stats[step_mod.ST_LASTKFIN]))
        self._counters_ahead = self.streaming

        n_inliers = int(stats[step_mod.ST_NIN])
        if stats[step_mod.ST_OK] > 0:
            self.state = TrackingState.OK
            self._lost_frames = 0
        else:
            self.state = TrackingState.RECENTLY_LOST
            self._note_lost()
            if self._lost_frames >= 2:
                if self._relocalize(self._build_host(*img_args)):
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
