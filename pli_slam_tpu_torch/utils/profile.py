"""Where the port's main paths spend their time on one GPU.

Run from the repository root:
  python3 -m pli_slam_tpu_torch.utils.profile [--out DIR] [--vi | --vi-drift N | --spread rgbd|mono|loop|flagship
                                              | --first-closure | --nondet rgbd|mono|flagship | --stages
                                              | --init-split | --busy
                                              | --ba-cost | --rounding loop|mono-vi|one-ulp|vi [--variants DIR]]

It drives the slice configuration (`slice_config()`: SlamConfig.euroc_stereo()
with loop closing off, 752x480, on `slice_camera()`) over the 40-frame
synthetic sequence that chip_smoke.py uses. Every pass takes a fresh tracker
in streaming mode, runs the 12 warm frames untimed and then a window of 10
steady frames (frames 12-21):

0. plain: no profiler; the window's host wall time.
1. busy: torch.profiler with CUDA activity only. Device busy time is the
   union of the kernel, memcpy and memset intervals in that trace; the busy
   share is that union over the same window's host wall time. Tracing slows
   the host, so the window's wall time is printed beside pass 0's and the
   share holds for the traced window; the union over pass 0's wall time is
   printed as a derived estimate for the untraced run, named as such.
   Launches are what the host issues: the trace's `cudaLaunchKernel*` calls
   and, apart, its `cudaGraphLaunch` calls (the fused steps run as CUDA
   graphs); with them the capture time and the graph pool's size.
2. ops: torch.profiler with CPU and CUDA activity: the top ops by device
   time and by call count (written to DIR/ops.txt).
3. stages: all 40 frames with `torch.cuda.synchronize()` around each stage
   (build_frame and the step's stages), which makes the stage times exclusive
   and inflates the frame; the fused steps and the host-path stages run
   eagerly here (a synchronise cannot sit inside a captured graph).

With `--vi` it profiles the stereo-inertial path instead
(`slice_config_vi()`: SlamConfig.euroc_stereo_inertial() with loop closing
off and the IMU settings of bench.py's flagship run, 52 frames with 200 Hz
IMU under ImuNoiseModel.euroc()): launches and device busy time per frame
from two CUDA-only trace windows of one tracker (10 host-path frames before
IMU initialization, 10 fused stereo-inertial frames after it), then the
synchronised stage pass with `preintegrate`, `track_step_inertial`,
`local_inertial_ba` and `_try_imu_init` added to the stages. `--vi-drift N`
runs N frames of that path twice and prints, per frame after the
initialization, how far velocity, accelerometer bias and trajectory have
drifted from the truth.
`--spread rgbd|mono|loop|flagship` runs chip_smoke.py's RGB-D, mono,
loop-closing (6a) or inertial-closure (14a) phase N_SPREAD times on the
same frames and prints each run's accuracy, a digest of its trajectory,
and whether all runs were bit-identical. `--first-closure` runs phase 6a twice in a fresh process:
the closure warm-up's time at Tracker construction, the first closure's
wall time and the second's. `--nondet rgbd|mono|flagship` runs phase 7, 8 or 14a once
under `torch.use_deterministic_algorithms(True, warn_only=True)` (a
diagnostic switched off again after the run) and `NondetSites`, and lists
the ops that can make two runs differ. `--stages` runs only pass 3 (the
synchronised stage times), which `python3 -m
pli_slam_tpu_torch.scripts.profile_stages` also runs. `--init-split`
drives the stereo-inertial path (chip_smoke.py's phase 5, 52 frames) with
graphs and then eagerly, each up to its IMU-initialization frame, and
splits that frame's time by synchronised timers around the
initialization's parts: `_try_imu_init`, the full inertial BA, the
"imu_init" and "vi_ba" stages (their captures apart), and, on a tree that
still has them, the eager MAP problem and its seeds. `--busy` gives the
device's busy share over a window of 10 consecutive fused visual frames
and, apart, 10 fused stereo-inertial frames (graphs, streaming; one
CUDA-only trace a window, nothing per frame) and each tracker's
construction time; it runs on an earlier tree given this profile.py
(`git archive` the parent into `build/parent`, copy this file over its
own, run both in one call). `--ba-cost` gives the device time of the
visual path's windowed BA on the last window of phase 4's frames, the
whole `local_ba` call and `ba.solve_ba` alone (graph replays), then the
visual-inertial BA's with its reduced system in float32 and in float64
over the fused step's window and the widest full-inertial-BA window on
phase 5's map (`vi_ba_cost`); it runs on an earlier tree the same way
(the visual part only). `--rounding loop|mono-vi|one-ulp` is the rounding
tracer (`utils/rounding.py`): where two builds of rot3, or the two-view's
two eigenvector routes, make phase 6a's or phase 11's runs part, and how
far they grow apart; `one-ulp` runs phases 5, 7, 12 and 14b under graphs as
chip_smoke.py does and once more one ulp off, and says whether each
outcome is robust or re-rolled (the inertial phases with the
visual-inertial BA's reduced system in float32 and as shipped); `vi` runs
phases 5, 12 and 14b so eagerly, recorded stage by stage, and says where
the runs first part by more than a millimetre.

Needs a CUDA device. The chrome trace of pass 1 is written under `build/`
and deleted once read (it runs to ~100 MB).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import time
import traceback
import warnings
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.ops.camera import Camera

N_FRAMES = 40
N_WARM = 12  # frames before the timed window, as bench.py's run_visual
N_WINDOW = 10
# The stereo-inertial run stops at 52 frames: the IMU initializes at frame 30,
# and from the first keyframe after it visual-inertial BA drives the
# accelerometer bias and the velocity off (in the reference too), until
# tracking is lost near frame 57-59 (on an NVIDIA H100; the reference, on a
# CPU, at frame 57). 52 frames leave 21 fused stereo-inertial frames that both
# packages still track.
N_FRAMES_VI = 52
# The loop-closing run: bench.py's flagship trajectory (bench.py:98-101), back
# at its start after 140 frames, 180 frames of it.
FLAGSHIP_TRAJ = dict(amp=(1.0, 0.5, 0.3), freq=(1 / 7, 2 / 7, 3 / 7), yaw_amp=0.4, yaw_freq=1 / 7)
N_FRAMES_LOOP = 180
N_FRAMES_RGBD = 40  # chip_smoke.py's phase 7
N_FRAMES_MONO = 40  # and phase 8: the reference initializes on consecutive frames at 752x480, no stride
N_SPREAD = 4
STAGES = ("track_step", "insert_keyframe", "local_ba", "far_point_depths", "_local_map_ids")
STAGES_VI = STAGES + ("track_step_inertial", "local_inertial_ba")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def loop_off(cfg: SlamConfig) -> SlamConfig:
    """`cfg` with loop closing off: the configuration of the measured visual
    and stereo-inertial paths, whose sequences never revisit a place."""
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))


def slice_config() -> SlamConfig:
    """The visual path's measured configuration: the EuRoC operating point at
    its published widths with loop closing off."""
    return loop_off(SlamConfig.euroc_stereo())


def loop_config() -> SlamConfig:
    """The loop-closing run's configuration: SlamConfig.euroc_stereo() as
    published, loop closing on at its defaults, with bench.py's per-keyframe
    creation budget for a long run (bench.py:88-91: at the default budget the
    16384-point store fills at ~40 keyframes)."""
    cfg = SlamConfig.euroc_stereo()
    return dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, kf_max_new_points=256))


def slice_config_vi() -> SlamConfig:
    """The stereo-inertial slice's configuration: the EuRoC stereo-inertial
    operating point at its published widths with loop closing off and the
    IMU settings of bench.py's flagship run (init after 1.5 s, 16-sample batches)."""
    cfg = loop_off(SlamConfig.euroc_stereo_inertial())
    return dataclasses.replace(cfg, imu=dataclasses.replace(cfg.imu, init_time_sec=1.5, max_samples_per_frame=16))


def vi_frames(cam: Camera, cfg: SlamConfig, n_frames: int, dev) -> list[dict]:
    """The visual path's synthetic room sequence with 200 Hz IMU under the
    EuRoC noise model; each frame's raw batch under "imu"."""
    from pli_slam_tpu_torch.utils import synthetic

    frames = list(synthetic.make_sequence(cam, n_frames, dev, fps=cfg.fps, imu_noise=synthetic.ImuNoiseModel.euroc()))
    for fr in frames:
        fr["imu"] = imu_batch(fr)
    return frames


def slice_camera() -> Camera:
    """bench.py's camera: EuRoC-like 752x480 pinhole, fx=435.2, bf=0.11 fx."""
    return Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)


def rgbd_config() -> SlamConfig:
    """scripts/run_tum.py's deployment as published: RGB-D at 640x480 and 30 fps,
    every other setting at its default (loop closing on)."""
    return SlamConfig(sensor="rgbd", width=640, height=480, fps=30.0)


def rgbd_camera() -> Camera:
    """TUM RGB-D freiburg3's intrinsics, the default of scripts/run_tum.py (TUM3.yaml: bf 40.0)."""
    return Camera.pinhole(fx=535.4, fy=539.2, cx=320.1, cy=247.6, bf=40.0, width=640, height=480)


def mono_config() -> SlamConfig:
    """The EuRoC operating point with one camera: SlamConfig.euroc_stereo() with
    sensor "mono", loop closing on (on slice_camera(); its bf is not used)."""
    return SlamConfig.euroc_stereo().replace(sensor="mono")


def sensor_run(sensor: str, dev) -> tuple:
    """(cfg, cam, frames) of chip_smoke.py's phase 7 (`"rgbd"`: N_FRAMES_RGBD
    frames of the room with depth at 30 fps) or phase 8 (`"mono"`:
    N_FRAMES_MONO consecutive frames of the visual path's sequence)."""
    from pli_slam_tpu_torch.utils import synthetic

    if sensor == "rgbd":
        cfg, cam = rgbd_config(), rgbd_camera()
        return cfg, cam, list(synthetic.make_sequence(cam, N_FRAMES_RGBD, dev, fps=cfg.fps, with_depth=True))
    cfg, cam = mono_config(), slice_camera()
    return cfg, cam, list(synthetic.make_sequence(cam, N_FRAMES_MONO, dev, fps=cfg.fps))


# chip_smoke.py's phases 10-12: the fisheye rig, mono-inertial and RGB-D-inertial.
# TUM-VI's 512x512 fisheye rig (ORB-SLAM3's Examples/Stereo-Inertial/TUM-VI.yaml, TUM_512): cam0's
# Kannala-Brandt8 calibration, used for both cameras, and a pure 0.101 m baseline
TUMVI_CAM0 = dict(fx=190.978, fy=190.973, cx=254.932, cy=256.897, k=(0.0034824, 0.00071503, -0.0020532, 0.00020294))
TUMVI_BASELINE = 0.101
N_FRAMES_FISHEYE = 40  # 10a, the fused visual step
N_FRAMES_FISHEYE_VI = 52  # 10b: host-path frames until the IMU initialization, then fused VI frames (as phase 5)
N_FRAMES_MONO_VI = 44  # phase 11: the reference initializes the IMU at frame 30 and loses tracking right after
N_FRAMES_RGBD_VI = 64  # phase 12: the IMU initializes after 1.5 s (frame 45 at 30 fps) and 10 keyframes


def fisheye_camera() -> Camera:
    """TUM-VI's cam0 at 512x512 (KB8), bf = fx x 0.101 m."""
    c = TUMVI_CAM0
    return Camera.kannala_brandt8(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], k=c["k"],
                                  bf=c["fx"] * TUMVI_BASELINE, width=512, height=512)


def fisheye_rig() -> np.ndarray:
    """T_rl of the fisheye rig: the right camera TUMVI_BASELINE along the left one's +x axis."""
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -TUMVI_BASELINE
    return T


def fisheye_config(inertial: bool) -> SlamConfig:
    """The fisheye rig's configuration: slice_config() (stereo) or slice_config_vi()
    (stereo_imu), the EuRoC budget (1200 ORB x 8 levels, 256 lines, stores
    16384 / 4096 / 512, BA window 8) at 512x512."""
    return dataclasses.replace(slice_config_vi() if inertial else slice_config(), width=512, height=512)


def mono_imu_config() -> SlamConfig:
    """Mono-inertial on the EuRoC operating point: slice_config_vi() with
    sensor "mono_imu" (752x480, on slice_camera(); its bf is not used)."""
    return slice_config_vi().replace(sensor="mono_imu")


def rgbd_imu_config() -> SlamConfig:
    """RGB-D-inertial: rgbd_config() (run_tum.py's deployment, 640x480, 30 fps,
    loop closing on) with sensor "rgbd_imu" and slice_config_vi()'s IMU settings."""
    return dataclasses.replace(rgbd_config(), sensor="rgbd_imu", imu=slice_config_vi().imu)


def imu_batch(fr: dict) -> dict:
    """A make_sequence frame's raw IMU batch as `Tracker.process*(imu=)` takes it."""
    return {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}


def tracked_positions(tracker, frames) -> tuple[np.ndarray, np.ndarray]:
    """(estimated positions, ground truth) of the frames the tracker recorded,
    matched by stamp: a stereo map records nothing until it initializes."""
    by_stamp = {round(float(f["t"]), 6): f["p_w"] for f in frames}
    traj = tracker.trajectory
    return (np.stack([p for _, _, p in traj]), np.stack([by_stamp[round(float(s), 6)] for s, _, _ in traj]))


def peek_ate(tracker, frames, with_scale: bool = False) -> float:
    """ATE of the frames recorded so far, the pending trajectory left
    pending (later BA still refines those frames)."""
    from pli_slam_tpu_torch.utils import trajectory as tio

    pend, done = list(tracker._traj_pending), list(tracker._traj_done)
    ate = tio.ate_rmse(*tracked_positions(tracker, frames), with_scale=with_scale)
    tracker._traj_pending, tracker._traj_done = pend, done
    return ate


def path_ratio(est: np.ndarray, gt: np.ndarray, n: int = 20) -> float:
    """Path length of the last `n` estimated positions over the truth's, with
    no alignment (tests/test_mono_inertial_scale.py's metric-scale check)."""
    a, b = est[-n:], gt[len(est) - n:len(est)]
    return float(np.linalg.norm(np.diff(a, axis=0), axis=1).sum() / np.linalg.norm(np.diff(b, axis=0), axis=1).sum())


def slice6_frames(which: str, dev, n_frames: int | None = None) -> tuple:
    """(cfg, cam, frames) of chip_smoke.py's phases 10-12 on the default room
    trajectory, with 200 Hz IMU under ImuNoiseModel.euroc() (each frame's batch
    under "imu"): "fisheye" (10a) and "fisheye_vi" (10b) on fisheye_camera(),
    "mono_vi" (11) on slice_camera(), "rgbd_vi" (12) on rgbd_camera() with depth."""
    from pli_slam_tpu_torch.utils import synthetic

    cfg, cam, n = {
        "fisheye": (fisheye_config(False), fisheye_camera(), N_FRAMES_FISHEYE),
        "fisheye_vi": (fisheye_config(True), fisheye_camera(), N_FRAMES_FISHEYE_VI),
        "mono_vi": (mono_imu_config(), slice_camera(), N_FRAMES_MONO_VI),
        "rgbd_vi": (rgbd_imu_config(), rgbd_camera(), N_FRAMES_RGBD_VI),
    }[which]
    frames = list(synthetic.make_sequence(cam, n if n_frames is None else n_frames, dev, fps=cfg.fps,
                                          with_depth=which == "rgbd_vi", imu_noise=synthetic.ImuNoiseModel.euroc()))
    for fr in frames:
        fr["imu"] = imu_batch(fr)
    return cfg, cam, frames


N_AFTER_LOOP = 6  # frames after the planted closure: the queued GBA chunks run one per non-keyframe frame


def loop_frames(dev):
    """(cfg, cam, traj, frames) of chip_smoke.py's phase 6a: loop_config() on
    slice_camera(), N_FRAMES_LOOP + N_AFTER_LOOP frames of bench.py's
    flagship trajectory, each with its 200 Hz IMU batch under
    ImuNoiseModel.euroc() (under "imu"), as bench.py's flagship run renders
    them: the images do not depend on the IMU, so phase 14 tracks the same
    frames with their IMU."""
    from pli_slam_tpu_torch.utils import synthetic

    cfg, cam = loop_config(), slice_camera()
    traj = synthetic.Trajectory(**FLAGSHIP_TRAJ)
    frames = list(synthetic.make_sequence(cam, N_FRAMES_LOOP + N_AFTER_LOOP, dev, fps=cfg.fps, traj=traj,
                                          imu_noise=synthetic.ImuNoiseModel.euroc()))
    for fr in frames:
        fr["imu"] = imu_batch(fr)
    return cfg, cam, traj, frames


def overlapping_pair(tracker, traj, min_gap: int):
    """The keyframe pair (newer, older), at least `min_gap` slots apart, whose
    ground-truth poses are nearest (`loop_candidates`' cost), from the
    keyframes' stamps: (newer, older, cost)."""
    stamps = tracker.kstore.stamp[:tracker.n_kf].cpu().numpy()
    valid = tracker.kstore.valid[:tracker.n_kf].cpu().numpy()
    best = (np.inf, -1, -1)
    for i in np.nonzero(valid)[0]:
        cands = loop_candidates(stamps, valid, traj, int(i), min_gap)
        if cands:
            best = min(best, (cands[0][1], int(i), cands[0][0]))
    return best[1], best[2], best[0]


def kf_error(tracker, traj) -> float:
    """The largest position error of a valid keyframe against the truth at its stamp (tracker world)."""
    n = tracker.n_kf
    valid = tracker.kstore.valid[:n].cpu().numpy()
    R, t = tracker.kstore.R[:n].cpu().numpy(), tracker.kstore.t[:n].cpu().numpy()
    R0, p0 = traj.pose(0.0)
    gt = np.stack([R0.T @ (traj.pose(float(s))[1] - p0) for s in tracker.kstore.stamp[:n].cpu().numpy()])
    return float(np.linalg.norm(-np.einsum("kji,kj->ki", R, t) - gt, axis=1)[valid].max())


class _ClosureRun:
    """The skeleton that `loop_run` (phase 6a) and `inertial_loop_run`
    (phase 14a) share: a fresh tracker in streaming mode whose rare paths
    SyncSpans times (ordinary frames run unsynchronised), driven frame by
    frame, and the drain of the BA chunks a closure queued ("gba" or
    "fiba": `chunk`). Records the frames that ran a loop verification
    (frame, ms, closed, imu_ready) and the largest keyframe position error
    after each chunk."""

    def __init__(self, cam, cfg, dev, traj, chunk: str, cuda_graphs: bool | None = None):
        from pli_slam_tpu_torch.frontend.tracker import Tracker

        self.tracker = Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
        self.tracker.streaming = True
        self.tracker.span = self.spans = SyncSpans(dev)
        self.t_loop, self.t_chunk = self.spans.ms["loop"], self.spans.ms[chunk]
        self.dev, self.traj = dev, traj
        self.loop_frames, self.kf_errs = [], []

    def frame(self, fr, i: int, imu=None) -> tuple[float, bool]:
        """Tracks frame `i`: (its wall ms, whether it ran neither a loop verification nor a chunk)."""
        tr, lc = self.tracker, self.tracker.loop_closer
        n_chunk, n_loop, n_closed = len(self.t_chunk), len(self.t_loop), lc.n_loops_closed
        f0 = time.perf_counter()
        tr.process(fr["img_l"], fr["img_r"], fr["t"], imu=imu)
        dt = (time.perf_counter() - f0) * 1e3
        if len(self.t_loop) > n_loop:
            self.loop_frames.append((i, round(dt, 2), lc.n_loops_closed > n_closed, tr.imu_ready))
        elif len(self.t_chunk) > n_chunk:
            self.kf_errs.append(kf_error(tr, self.traj))
        return dt, len(self.t_loop) == n_loop and len(self.t_chunk) == n_chunk

    def drain(self, gt: np.ndarray) -> tuple[np.ndarray, float]:
        """The queued chunks one by one, then `finalize`: (positions, ATE against `gt`)."""
        from pli_slam_tpu_torch.utils import synthetic

        tr = self.tracker
        while tr._deferred_ba:
            tr.run_deferred_ba(1)
            self.kf_errs.append(kf_error(tr, self.traj))
        tr.finalize()
        est = tr.positions()
        _sync(self.dev)
        return est, synthetic.ate_rmse(est, gt) if est.shape == gt.shape else float("nan")


def loop_run(cfg, cam, traj, frames, dev) -> dict:
    """Phase 6a on `frames` (from `loop_frames`): a `_ClosureRun` over the
    first N_FRAMES_LOOP frames; then, if the run closed no loop (no
    candidate reaches the closer on this trajectory, in the reference too),
    a closure planted between the keyframes that ground truth says overlap,
    the consistency counter pre-set, and the correction once more, warm (its
    result dropped); then the remaining frames and the queued GBA chunks,
    and `finalize`. Returns what chip_smoke.py logs and guards."""
    from pli_slam_tpu_torch.frontend.loop_closing import apply_loop_correction
    from pli_slam_tpu_torch.utils import synthetic

    cr = _ClosureRun(cam, cfg, dev, traj, "gba")
    tracker, spans, lc = cr.tracker, cr.spans, cr.tracker.loop_closer
    ms_plain = []

    def run(fr, i):
        dt, plain = cr.frame(fr, i)
        if plain and i > 0:
            ms_plain.append(dt)

    wall0 = time.perf_counter()
    for i, fr in enumerate(frames[:N_FRAMES_LOOP]):
        run(fr, i)
    _sync(dev)
    wall = time.perf_counter() - wall0
    gt = np.stack([fr["p_w"] for fr in frames])
    pend, done = list(tracker._traj_pending), list(tracker._traj_done)  # read without consuming
    est_run = tracker.positions()
    ate_run = synthetic.ate_rmse(est_run, gt[:N_FRAMES_LOOP])
    tracker._traj_pending, tracker._traj_done = pend, done
    natural, n_kf_run, planted = lc.n_loops_closed, tracker.n_kf, None
    if natural == 0:
        kf_cur, kf_loop, cost = overlapping_pair(tracker, traj, cfg.loop.min_kf_gap)
        lc._consistency, lc._consistent_with = cfg.loop.consistency_kfs, kf_loop
        kf_before = kf_error(tracker, traj)
        closed = lc.on_keyframe(tracker, kf_cur, [(kf_loop, 1.0)])
        kf_after = kf_error(tracker, traj)
        with spans("correction"):
            apply_loop_correction(tracker.kstore, tracker.pstore, tracker.lstore, kf_cur, kf_loop,
                                  torch.eye(3, device=dev), torch.zeros(3, device=dev), cfg)
        planted = dict(kf_cur=kf_cur, kf_loop=kf_loop, cost=cost, ms=cr.t_loop[-1], closed=closed,
                       kf_before=kf_before, kf_after=kf_after, warm_ms=spans.ms["correction"][0])
    n_queued = len(tracker._deferred_ba)
    for i, fr in enumerate(frames[N_FRAMES_LOOP:], N_FRAMES_LOOP):
        run(fr, i)
    est, ate = cr.drain(gt)
    return dict(tracker=tracker, t_gba=cr.t_chunk, t_loop=cr.t_loop, kf_errs=cr.kf_errs, ms_plain=ms_plain,
                loop_frames=cr.loop_frames, wall=wall, est_run=est_run, ate_run=ate_run, natural=natural,
                n_kf_run=n_kf_run, planted=planted, n_queued=n_queued, est=est, ate=ate)


def nudge_pose(tracker) -> None:
    """One float32 ulp toward zero in every entry of the tracker's pose
    (R, t): a rounding difference that the next frame starts from."""
    tracker.R = torch.nextafter(tracker.R, torch.zeros_like(tracker.R))
    tracker.t = torch.nextafter(tracker.t, torch.zeros_like(tracker.t))


def pre_closure_run(cfg, cam, traj, frames, dev, nudge_after: int | None = None) -> dict:
    """Phase 6a's first N_FRAMES_LOOP frames (`loop_run` up to its planted
    closure) on a fresh tracker, with `nudge_pose` after frame
    `nudge_after`. Returns the positions and the ATE before the closure."""
    from pli_slam_tpu_torch.utils import synthetic

    cr = _ClosureRun(cam, cfg, dev, traj, "gba")
    for i, fr in enumerate(frames[:N_FRAMES_LOOP]):
        cr.frame(fr, i)
        if i == nudge_after:
            nudge_pose(cr.tracker)
    est = cr.tracker.positions()
    _sync(dev)
    gt = np.stack([fr["p_w"] for fr in frames[:N_FRAMES_LOOP]])
    return dict(est=est, ate=synthetic.ate_rmse(est, gt), n_kf=cr.tracker.n_kf)


def flagship_config() -> SlamConfig:
    """bench.py's flagship configuration (bench.py:84-91): the EuRoC
    stereo-inertial operating point with loop closing on, the IMU initialized
    after 1.5 s from 16-sample batches, and the long run's per-keyframe
    creation budget (kf_max_new_points 256)."""
    cfg = SlamConfig.euroc_stereo_inertial()
    return dataclasses.replace(cfg, imu=dataclasses.replace(cfg.imu, init_time_sec=1.5, max_samples_per_frame=16),
                               tracking=dataclasses.replace(cfg.tracking, kf_max_new_points=256))


# chip_smoke.py's phase 14a: fused stereo-inertial frames between the IMU
# initialization and the planted closure (the visual-inertial drift of queue 3
# B1 loses this map some 40 frames after the initialization, in the reference too)
N_FUSED_BEFORE_CLOSURE = 8


def axis_in_cameras(tracker, axis) -> np.ndarray:
    """A world direction in each keyframe's camera frame, R_cw axis / |axis|,
    [n_kf, 3]: with `tracker.gravity_w` every keyframe's roll and pitch; with
    the world z axis what the 4-DoF essential graph keeps (its free rotation
    is about world z: ROADMAP queue 3 B13)."""
    a = torch.as_tensor(axis, dtype=torch.float32, device=tracker.device)
    return torch.einsum("kij,j->ki", tracker.kstore.R[:tracker.n_kf], a / torch.linalg.norm(a)).cpu().numpy().astype(
        np.float64)


def gravity_turn_deg(before: np.ndarray, after: np.ndarray) -> np.ndarray:
    """The angle, in degrees, between two `axis_in_cameras` readings, per keyframe."""
    cos = np.sum(before * after, axis=1) / np.linalg.norm(before, axis=1) / np.linalg.norm(after, axis=1)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def b13_gravity_turn_deg(R_before: np.ndarray, R_after: np.ndarray, gravity_w) -> np.ndarray:
    """The turn of each keyframe's gravity direction in its camera frame that
    a correction rotating the keyframe's world frame about world z alone
    gives (ROADMAP queue 3 B13), from the keyframes' R_cw before and after:
    the correction's world rotation D = R_after^T R_before turns by theta,
    and gravity, alpha off the z axis, turns by 2 asin(sin alpha
    sin(theta / 2)), in degrees, per keyframe."""
    D = np.einsum("kji,kjl->kil", np.asarray(R_after, np.float64), np.asarray(R_before, np.float64))
    half = np.clip(np.linalg.norm(D - np.eye(3), axis=(1, 2)) / (2.0 * np.sqrt(2.0)), 0.0, 1.0)  # sin(theta / 2)
    g = np.asarray(gravity_w, np.float64)
    sin_alpha = np.linalg.norm(np.cross(g, (0.0, 0.0, 1.0))) / np.linalg.norm(g)
    return np.degrees(2.0 * np.arcsin(np.clip(sin_alpha * half, 0.0, 1.0)))


def loop_candidates(stamps: np.ndarray, valid: np.ndarray, traj, kf_cur: int, min_gap: int) -> list[tuple[int, float]]:
    """The valid keyframes at least `min_gap` slots older than `kf_cur` (by
    the keyframes' stamps and validity), the ground-truth-nearest first
    (distance in m plus viewing-direction angle in rad, as `overlapping_pair`):
    [(slot, cost)]."""
    Ri, pi = traj.pose(float(stamps[kf_cur]))
    out = []
    for j in range(kf_cur - min_gap + 1):
        if valid[j]:
            Rj, pj = traj.pose(float(stamps[j]))
            out.append((j, float(np.linalg.norm(pi - pj) + np.arccos(np.clip(Ri[:, 2] @ Rj[:, 2], -1.0, 1.0)))))
    return sorted(out, key=lambda c: c[1])


def inertial_loop_run(cfg, cam, traj, frames, dev, n_before: int = N_FUSED_BEFORE_CLOSURE,
                      n_after: int = N_AFTER_LOOP, min_gap: int | None = None) -> dict:
    """Phase 14a on `frames` (each with its IMU batch under "imu"): a
    `_ClosureRun` through the IMU initialization and `n_before` fused
    stereo-inertial frames; then, if the run closed no loop after the
    initialization, a closure planted at the newest keyframe, its candidates
    the keyframes at least `min_gap` (default `cfg.loop.min_kf_gap`) older,
    the ground-truth-nearest first, the consistency counter pre-set, each
    keyframe's gravity direction and world z axis read before and after (and
    the gravity turn that `b13_gravity_turn_deg` predicts from the
    correction's own rotations); then `n_after` more frames and the rest of
    the queued "fiba" chunks one by one. Returns what chip_smoke.py logs and
    guards."""
    from pli_slam_tpu_torch.frontend.tracker import TrackingState

    cr = _ClosureRun(cam, cfg, dev, traj, "fiba")
    tracker, lc = cr.tracker, cr.tracker.loop_closer
    ms_host, ms_fused = [], []
    init = {}

    def run(fr, i):
        fused = tracker.imu_ready and tracker.gravity_w is not None and tracker.state == TrackingState.OK
        dt, plain = cr.frame(fr, i, imu=fr["imu"])
        if tracker.imu_ready and not init:
            init.update(frame=i, ms=dt, ate=peek_ate(tracker, frames), record=dict(tracker.imu_init_log[-1]))
        elif plain and i > 0:
            (ms_fused if fused else ms_host).append(dt)

    n_run = 0
    for i, fr in enumerate(frames[:len(frames) - n_after]):
        run(fr, i)
        n_run = i + 1
        if init and i >= init["frame"] + n_before:
            break
    natural, planted = lc.n_loops_closed, None
    if init and not any(closed and ready for _, _, closed, ready in cr.loop_frames):
        kf_cur = tracker.n_kf - 1
        stamps = tracker.kstore.stamp[:tracker.n_kf].cpu().numpy()
        valid = tracker.kstore.valid[:tracker.n_kf].cpu().numpy()
        z_axis, g = (0.0, 0.0, 1.0), tracker.gravity_w.cpu().numpy().astype(np.float64)
        g_before, z_before = axis_in_cameras(tracker, g), axis_in_cameras(tracker, z_axis)
        R_before = tracker.kstore.R[:tracker.n_kf].cpu().numpy()
        kf_before = kf_error(tracker, traj)
        cands = loop_candidates(stamps, valid, traj, kf_cur, cfg.loop.min_kf_gap if min_gap is None else min_gap)
        closed, imu_ready = False, tracker.imu_ready
        if cands:
            lc._consistency, lc._consistent_with = cfg.loop.consistency_kfs, cands[0][0]
            closed = lc.on_keyframe(tracker, kf_cur, [(j, 1.0) for j, _ in cands])
        turn = gravity_turn_deg(g_before, axis_in_cameras(tracker, g))
        pred = b13_gravity_turn_deg(R_before, tracker.kstore.R[:tracker.n_kf].cpu().numpy(), g)
        z_turn = gravity_turn_deg(z_before, axis_in_cameras(tracker, z_axis))
        planted = dict(kf_cur=kf_cur, cands=cands, closed=closed, imu_ready=imu_ready,
                       ms=cr.t_loop[-1] if closed else None, kf_before=kf_before, kf_after=kf_error(tracker, traj),
                       gravity_deg=float(turn[valid].max(initial=0.0)),
                       gravity_pred_deg=float(pred[valid].max(initial=0.0)),
                       gravity_excess_deg=float(np.abs(turn - pred)[valid].max(initial=0.0)),
                       z_deg=float(z_turn[valid].max(initial=0.0)),
                       tilt_deg=float(np.degrees(np.arccos(np.clip(-g[2] / np.linalg.norm(g), -1.0, 1.0)))),
                       queued=[kind for kind, _ in tracker._deferred_ba])
    for i, fr in enumerate(frames[n_run:n_run + n_after], n_run):
        run(fr, i)
    n_frames = n_run + n_after
    est, ate = cr.drain(np.stack([fr["p_w"] for fr in frames[:n_frames]]))
    return dict(tracker=tracker, init=init, n_frames=n_frames, natural=natural, planted=planted, t_fiba=cr.t_chunk,
                t_loop=cr.t_loop, kf_errs=cr.kf_errs, ms_host=ms_host, ms_fused=ms_fused, loop_frames=cr.loop_frames,
                est=est, ate=ate)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class SyncSpans:
    """A `Tracker.span` that records each rare path's wall time: `ms[name]`
    gets one entry in ms per call, the device synchronised at both ends so
    that the time is the path's own."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        _sync(self.device)
        t0 = time.perf_counter()
        yield
        _sync(self.device)
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


def union_us(intervals) -> float:
    """Total length of the union of (start, duration) intervals."""
    total, end = 0.0, -float("inf")
    for start, dur in sorted(intervals):
        stop = start + dur
        if start > end:
            total += dur
            end = stop
        elif stop > end:
            total += stop - end
            end = stop
    return total


def trace_busy(trace_path: str) -> tuple[float, int, int, int]:
    """(device busy us, device activities, kernel launches, graph launches)
    of a chrome trace: the host-issued `cudaLaunchKernel*` and
    `cudaGraphLaunch` calls. The kernels a graph launch replays are device
    activities, not host calls."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(e["ts"], e["dur"]) for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    runtime = [e.get("name", "") for e in events if e.get("cat") == "cuda_runtime"]
    launches = sum(1 for n in runtime if n.startswith("cudaLaunchKernel"))
    graph_launches = sum(1 for n in runtime if n == "cudaGraphLaunch")
    return union_us(dev), len(dev), launches, graph_launches


def capture_stats(tracker) -> tuple[float, int]:
    """(capture ms, graph-pool bytes) of a tracker's captured fused steps and
    host-path stages."""
    steps = [s for s in (tracker._step, getattr(tracker, "_step_vi", None)) if s is not None]
    steps += tracker.stage_programs()
    return sum(s.capture_ms for s in steps), sum(s.pool_bytes for s in steps)


def stage_captures(tracker) -> dict[str, float]:
    """Each host-path stage's capture ms (warm-up included) in `tracker`, by stage."""
    return {p.name: round(p.capture_ms, 1) for p in tracker.stage_programs() if p.captures}


def _window(cam, cfg, frames, dev, profiler=None):
    """Fresh tracker (its fused steps as CUDA graphs), warm frames untimed,
    then the window's host wall time (seconds, ending in a device sync),
    inside `profiler` when given. Returns (wall, tracker)."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker

    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    for fr in frames[:N_WARM]:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    torch.cuda.synchronize()
    with profiler if profiler is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for fr in frames[N_WARM:N_WARM + N_WINDOW]:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, tracker


def _stages(cam, cfg, frames, dev, vi: bool = False):
    """Pass 3: per-stage wall time with a device sync around each stage.
    With `vi`, the frames carry IMU batches and the inertial stages are timed too."""
    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.frontend import tracker as tr_mod
    from pli_slam_tpu_torch.ops import imu as imu_mod

    stage_ms = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - s) * 1e3)
            return out
        return wrapper

    saved = ([(step_mod, n, getattr(step_mod, n)) for n in (STAGES_VI if vi else STAGES)]
             + [(tr_mod, "build_frame", tr_mod.build_frame)])
    if vi:
        saved += [(imu_mod, "preintegrate", imu_mod.preintegrate),
                  (tr_mod.Tracker, "_try_imu_init", tr_mod.Tracker._try_imu_init)]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
        # eager: a synchronisation inside a stage would break a graph capture
        tracker = tr_mod.Tracker(cam, cfg, dev, cuda_graphs=False)
        tracker.streaming = True
        frame_ms = []
        for i, fr in enumerate(frames):
            torch.cuda.synchronize()
            s = time.perf_counter()
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr.get("imu"))
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - s) * 1e3)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    if vi:
        return frame_ms, stage_ms, tracker
    return frame_ms, stage_ms


def _traced(tracker, frames, label: str, tag: str = "vi"):
    """Drive `frames` through `tracker` inside one CUDA-only trace (no mark
    and no synchronisation per frame); prints the window's wall time, device
    busy time and launches per frame."""
    acts = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr.get("imu"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = os.path.join("build", "profile_trace.json")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(trace)
    busy_us, n_dev, launches, graph_launches = trace_busy(trace)
    os.remove(trace)
    n = len(frames)
    print(f"profile[{tag}]: {label}: {n} frames traced (CUDA activity only), wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / n:.1f} ms/frame); device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
          f"of the traced window; {launches} kernel launches ({launches / n:.0f} per frame) and {graph_launches} "
          f"graph launches ({graph_launches / n:.1f} per frame) from the host", flush=True)


def _to_fused_vi(tracker, frames, k: int) -> int:
    """Drive `frames` from `k` until the IMU initializes, then three fused
    frames (the first allocate); returns the next frame's index."""
    while not tracker.imu_ready and k < N_FRAMES_VI:
        fr = frames[k]
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
        k += 1
    if not tracker.imu_ready:
        raise SystemExit("profile: IMU initialization did not fire")
    print(f"profile[vi]: IMU initialization fired at frame {k - 1}: {tracker.imu_init_log[-1]}", flush=True)
    for fr in frames[k:k + 3]:  # the first fused frames allocate
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
    return k + 3


def main_vi(dev) -> int:
    """The stereo-inertial path: two traced windows of one tracker, then the stage pass."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker

    cfg, cam = slice_config_vi(), slice_camera()
    frames = vi_frames(cam, cfg, N_FRAMES_VI, dev)
    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    for fr in frames[:N_WARM]:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
    k = N_WARM
    _traced(tracker, frames[k:k + N_WINDOW], f"host path before IMU init, frames {k}-{k + N_WINDOW - 1}")
    k = _to_fused_vi(tracker, frames, k + N_WINDOW)
    _traced(tracker, frames[k:k + N_WINDOW], f"fused stereo-inertial step, frames {k}-{k + N_WINDOW - 1}")

    frame_ms, stage_ms, tr = _stages(cam, cfg, frames, dev, vi=True)
    print(f"stages[vi] (synchronised), frames 0-{N_FRAMES_VI - 1}: frame mean {np.mean(frame_ms):.2f} ms, "
          f"p50 {np.percentile(frame_ms, 50):.2f}, p99 {np.percentile(frame_ms, 99):.2f}; "
          f"IMU init accepted with {tr.imu_init_log[-1]['n_kf']} keyframes", flush=True)
    for name, v in sorted(stage_ms.items(), key=lambda kv: -sum(kv[1])):
        print(f"  {name:20s} calls {len(v):3d} (frames 0-{N_FRAMES_VI - 1})  mean {np.mean(v):8.2f} ms  "
              f"{100 * sum(v) / sum(frame_ms):5.1f}% of all frames' time", flush=True)
    return 0


def main_busy(dev) -> int:
    """The device's busy share over N_WINDOW consecutive fused frames, the
    visual step's and the stereo-inertial step's apart, each window in one
    CUDA-only trace (no mark and no synchronisation per frame) of a fresh
    graph tracker in streaming mode; the trackers' construction times. Runs
    on an earlier tree of the port too (it needs only `Tracker`)."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import synthetic

    for vi in (False, True):
        cfg, cam = (slice_config_vi() if vi else slice_config()), slice_camera()
        frames = vi_frames(cam, cfg, N_FRAMES_VI, dev) if vi else list(
            synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker = Tracker(cam, cfg, dev)
        torch.cuda.synchronize()
        print(f"profile[busy]: {'stereo-inertial' if vi else 'visual'} Tracker constructed in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({getattr(tracker, 'fused_warmup_ms', None)} ms of it "
              f"the fused step's and the first frames' captures)", flush=True)
        tracker.streaming = True
        for fr in frames[:N_WARM]:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr.get("imu"))
        k = _to_fused_vi(tracker, frames, N_WARM) if vi else N_WARM
        _traced(tracker, frames[k:k + N_WINDOW], f"fused {'stereo-inertial' if vi else 'visual'} step, frames "
                f"{k}-{k + N_WINDOW - 1}", tag="busy")
        cap_ms, pool = capture_stats(tracker)
        print(f"profile[busy]: captures {cap_ms:.1f} ms, graph pools {pool / 2**20:.1f} MiB", flush=True)
    return 0


def main_ba_cost(dev) -> int:
    """Windowed BA's device time on the visual path: phase 4's frames
    (`slice_config()`, N_FRAMES) in an eager tracker, the inputs of each
    `step.local_ba` call kept, then, for the last and fullest window, that
    call (the window's problem, `ba.solve_ba`, the prune and the write-back:
    the fused step's windowed-BA body) and `ba.solve_ba` alone, each
    captured in a CUDA graph and replayed between CUDA events
    (`kernel_bench.graph_ms`). Runs on an earlier tree of the port too."""
    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.solve import ba as ba_mod
    from pli_slam_tpu_torch.solve import vi_ba as vib
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.kernel_bench import graph_ms

    cfg, cam = slice_config(), slice_camera()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
    calls, orig = [], step_mod.local_ba

    def local_ba(cam_, cfg_, kstore, pstore, lstore, window, fixed, iters=None):
        calls.append((cam_, cfg_, kstore, pstore, lstore, window.clone(), fixed.clone(), iters))
        return orig(cam_, cfg_, kstore, pstore, lstore, window, fixed, iters)

    step_mod.local_ba = local_ba
    try:
        tracker = Tracker(cam, cfg, dev, cuda_graphs=False)
        for fr in frames:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"])
    finally:
        step_mod.local_ba = orig
    _sync(dev)
    cam_, cfg_, kstore, pstore, lstore, window, fixed, iters = calls[-1]
    prob = step_mod.window_problem(kstore, pstore, lstore, window, fixed, pt_cap=cfg_.opt.ba_pt_cap,
                                   ln_cap=cfg_.opt.ba_ln_cap)[0]
    n_iter = cfg_.opt.local_ba_iters if iters is None else iters
    body_ms = graph_ms(lambda: orig(cam_, cfg_, kstore, pstore, lstore, window, fixed, iters), launches=5,
                       replays=10)
    solve_ms = graph_ms(lambda: ba_mod.solve_ba(cam_, prob, cfg_.opt, iters=n_iter), launches=5, replays=10)
    print(f"profile[ba-cost]: {len(calls)} windowed BAs over {N_FRAMES} frames; the last: window "
          f"{int(prob.R.shape[0])} keyframes ({int((~prob.fixed_mask & prob.pose_mask).sum())} free), "
          f"{int(prob.pt_mask.sum())} of {prob.pts.shape[0]} points, {int(prob.ln_mask.sum())} of "
          f"{prob.lns.shape[0]} lines, {int(prob.po_mask.sum())} point and {int(prob.lo_mask.sum())} line "
          f"observations, {n_iter} iterations a stage; device ms a call (CUDA graph, events): local_ba "
          f"{body_ms:.4f}, solve_ba {solve_ms:.4f}", flush=True)
    if hasattr(vib, "reduced_system"):  # an earlier tree's VI BA has one precision
        vi_ba_cost(dev)
    return 0


def vi_ba_cost(dev) -> None:
    """The visual-inertial BA's device time with its reduced system in
    float32 (the reference's) and in float64 (the port's on CUDA): phase 5's
    frames (`slice_config_vi()`, N_FRAMES_VI) in an eager tracker, then, on
    its final map, `step.vi_ba_window` (the chain gathered, `local_inertial_ba`:
    the window's problem, `solve_vi_ba`, the write-back) over the fused
    step's window (the newest `local_ba_window` keyframes) and over the
    widest full-inertial-BA window (`Tracker._FIBA_CAPS[-1]` slots, padded
    with the newest keyframe as `_fiba_schedule` pads a smaller map), each
    captured in a CUDA graph and replayed between CUDA events, the two
    precisions in turns (32, 64, 64, 32)."""
    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import rounding
    from pli_slam_tpu_torch.utils.kernel_bench import graph_ms

    cfg, cam = slice_config_vi(), slice_camera()
    frames = vi_frames(cam, cfg, N_FRAMES_VI, dev)
    tracker = Tracker(cam, cfg, dev, cuda_graphs=False)
    for fr in frames:
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
    _sync(dev)
    n, W, cap = tracker.n_kf, cfg.opt.local_ba_window, Tracker._FIBA_CAPS[-1]
    fused = np.minimum(max(n - W, 0) + np.arange(W), n - 1)  # as the fused step pads a short map
    full = np.clip(np.arange(cap), 0, n - 1)  # as _fiba_schedule pads a map of at most `cap` keyframes
    windows = {f"fused step's window ({W} slots)": (fused, (np.arange(W) < max(cfg.opt.local_ba_fixed, 1))
                                                     | np.r_[False, fused[1:] <= fused[:-1]]),
               f"full inertial BA window ({cap} slots over {n} keyframes)": (full, np.r_[True, full[1:] <= full[:-1]])}
    for name, (window, fixed) in windows.items():
        args = (cam, cfg, tracker.kstore, tracker.pstore, tracker.lstore, tracker._pints,
                torch.as_tensor(window, dtype=torch.int32, device=dev), torch.as_tensor(fixed, device=dev),
                tracker.gravity_w, tracker.ext)
        ms = {torch.float32: [], torch.float64: []}
        for dt in (torch.float32, torch.float64, torch.float64, torch.float32):
            with rounding.vi_precision(dt):
                ms[dt].append(graph_ms(lambda: step_mod.vi_ba_window(*args), launches=5, replays=10))
        print(f"profile[ba-cost]: VI BA over the {name}, {cfg.opt.local_ba_iters} iterations, on phase 5's map "
              f"after {N_FRAMES_VI} frames; device ms a call (CUDA graph, events), in turns: float32 "
              f"{ms[torch.float32][0]:.4f} / {ms[torch.float32][1]:.4f}, float64 {ms[torch.float64][0]:.4f} / "
              f"{ms[torch.float64][1]:.4f}", flush=True)


def main_vi_drift(dev, n_frames: int) -> int:
    """How the stereo-inertial run drifts after the IMU initialization: per
    frame the state, inliers, keyframes, the velocity's and the accelerometer
    bias's distance from the truth and the ATE of the positions as reported
    up to that frame, for two runs
    over the same `n_frames` frames (they differ from the first keyframe
    after the initialization on: float atomics, amplified by visual-inertial
    BA). Relocalization and a new map, where a run reaches them, are
    reported like any other frame."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import synthetic

    cfg, cam = slice_config_vi(), slice_camera()
    frames = vi_frames(cam, cfg, n_frames, dev)
    ba_true = np.asarray(synthetic.ImuNoiseModel.euroc().ba0)
    for rep in range(2):
        tracker = Tracker(cam, cfg, dev)
        gt = []
        for i, fr in enumerate(frames):
            info = tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
            gt.append(fr["p_w"])
            if not tracker.imu_ready:
                continue
            ate = synthetic.ate_rmse(tracker.positions(), np.stack(gt))
            v_err = float(np.linalg.norm(tracker.v_w.cpu().numpy() - fr["v_w"]))
            ba_err = float(np.linalg.norm(tracker.ba.cpu().numpy() - ba_true))
            print(f"drift[{rep}]: frame {i} {info['state']} inliers {info['n_inliers']} n_kf {info['n_kf']} "
                  f"|v - v_true| {v_err:.3f} m/s |ba - ba_true| {ba_err:.3f} m/s^2 ATE {ate:.4f} m", flush=True)
    return 0


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float32).tobytes()).hexdigest()[:16]


def main_spread(dev, which: str, n_runs: int = N_SPREAD) -> int:
    """`n_runs` runs of chip_smoke.py's phase 7 (`rgbd`), 8 (`mono`), 6a
    (`loop`) or 14a (`flagship`) on the same rendered frames, each on a fresh tracker: do the
    card's runs of one build give the same bits? Per run: ATE (mono: after a
    Sim(3) alignment), keyframes, the largest position error, a digest of
    the trajectory; `loop` also the closure's and the warm-up's wall time
    (the first run's closure is the first in this process). Ends with one
    line saying whether every run's trajectory was bit-identical."""
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import trajectory as tio

    digests = []
    if which == "flagship":
        _, cam, traj, frames = loop_frames(dev)
        for rep in range(n_runs):
            r = inertial_loop_run(flagship_config(), cam, traj, frames, dev)
            digests.append(_digest(r["est"]))
            pl = r["planted"] or {}
            print(f"spread[flagship {rep}]: IMU init at frame {r['init'].get('frame')}, ATE to it "
                  f"{r['init'].get('ate')} m; closure {pl.get('kf_cur')} -> {pl.get('cands', [None])[:1]} closed "
                  f"{pl.get('closed')}, gravity turned {pl.get('gravity_deg')} deg (B13 predicts "
                  f"{pl.get('gravity_pred_deg')} deg, largest difference {pl.get('gravity_excess_deg')} deg), "
                  f"world z {pl.get('z_deg')} deg; "
                  f"ATE {r['ate']:.6f} m over {r['n_frames']} frames, {r['tracker'].n_kf} keyframes, trajectory "
                  f"digest {digests[-1]}", flush=True)
    elif which == "loop":
        cfg, cam, traj, frames = loop_frames(dev)
        closures = []
        for rep in range(n_runs):
            r = loop_run(cfg, cam, traj, frames, dev)
            digests.append(_digest(r["est"]))
            pl = r["planted"] or {}
            closures.append(pl.get("ms", r["t_loop"][0] if r["t_loop"] else float("nan")))
            warm = r["tracker"].loop_warmup_ms
            print(f"spread[loop {rep}]: ATE {r['ate_run']:.6f} m before the closure, {r['ate']:.6f} m after it, "
                  f"{r['tracker'].n_kf} keyframes, closure {closures[-1]:.2f} ms (warm-up at construction "
                  f"{'none' if warm is None else f'{warm:.2f} ms'}), GBA chunks {[round(t, 2) for t in r['t_gba']]} ms, "
                  f"trajectory digest {digests[-1]}", flush=True)
        print(f"spread[loop]: first closure in this process {closures[0]:.2f} ms, later ones "
              f"{[round(c, 2) for c in closures[1:]]} ms: {closures[0] / np.median(closures[1:]):.2f}x the warm median",
              flush=True)
    else:
        cfg, cam, frames = sensor_run(which, dev)
        gt = np.stack([fr["p_w"] for fr in frames])
        for rep in range(n_runs):
            sysm = System(cam, cfg, device=dev)
            sysm.tracker.streaming = which == "rgbd"
            states = []
            for fr in frames:
                info = (sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"]) if which == "rgbd"
                        else sysm.track_monocular(fr["img_l"], fr["t"]))
                states.append(info["state"])
            sysm.shutdown()
            est = np.stack([p for _, _, p in sysm.tracker.trajectory])
            mono = which == "mono"
            s, R, t = tio.align_umeyama(est, gt, with_scale=mono)
            err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
            digests.append(_digest(est))
            print(f"spread[{which} {rep}]: ATE {tio.ate_rmse(est, gt, with_scale=mono):.6f} m, "
                  f"{sysm.tracker.n_kf} keyframes, states OK {sum(x == 'OK' for x in states)}/{len(states)} (first at "
                  f"frame {states.index('OK') if 'OK' in states else None}), largest aligned error {err.max():.4f} m at "
                  f"frame {int(err.argmax())}, trajectory digest {digests[-1]}", flush=True)
    print(f"spread[{which}]: {n_runs} runs, bit-identical trajectories: {len(set(digests)) == 1}", flush=True)
    return 0


class NondetSites(TorchDispatchMode):
    """Records, by the port's call site, every op whose result on CUDA can
    depend on thread timing with this run's data: a float scatter-add
    (`index_add`, `scatter_add`, `index_put` with accumulate, a sum or mean
    `scatter_reduce`) with a repeated destination, and an `index_put` or
    `scatter` writing different values to one destination. Checks on every
    call (it syncs), so it is a diagnostic only; it runs on the CPU too,
    since the data decide."""

    def __init__(self):
        super().__init__()
        self.sites: dict = defaultdict(int)

    @staticmethod
    def _site() -> str:
        for fr in reversed(traceback.extract_stack()):
            if "pli_slam_tpu_torch" in fr.filename and not fr.filename.endswith("profile.py"):
                return f"{fr.filename.split('pli_slam_tpu_torch/')[-1]}:{fr.lineno}"
        return "?"

    @staticmethod
    def _clash(lin, vals=None) -> bool:
        """A repeated destination in `lin` (with `vals` rows: one whose values differ)."""
        lin = lin.reshape(-1)
        if lin.numel() < 2:
            return False
        order = torch.argsort(lin, stable=True)
        dup = lin[order][1:] == lin[order][:-1]
        if vals is not None:
            v = vals.reshape(lin.numel(), -1)[order]
            dup = dup & ((v[1:] != v[:-1]) & ~(torch.isnan(v[1:]) & torch.isnan(v[:-1]))).any(1)
        return bool(dup.any())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in ("index_add", "index_add_"):
            if args[0].is_floating_point() and self._clash(args[2]):
                self.sites[(name, self._site())] += 1
        elif name in ("index_put", "index_put_", "_index_put_impl_"):
            dst, indices, values = args[:3]
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
            idx = list(indices)
            if idx and all(i is not None and i.dtype != torch.bool for i in idx):
                b = torch.broadcast_tensors(*idx)
                lin = torch.zeros_like(b[0], dtype=torch.int64)
                for k, i in enumerate(b):
                    lin = lin * dst.shape[k] + i.long() % dst.shape[k]
                if acc and dst.is_floating_point() and self._clash(lin):
                    self.sites[(name + " accumulate", self._site())] += 1
                elif not acc and values.numel() > 1:
                    vals = values.expand(tuple(b[0].shape) + tuple(dst.shape[len(idx):]))
                    if self._clash(lin, vals):
                        self.sites[(name + " with clashing duplicates", self._site())] += 1
        elif name in ("scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_", "scatter", "scatter_"):
            dst, dim, index = args[:3]
            src = args[3] if len(args) > 3 else kwargs.get("src")
            reduce = args[4] if len(args) > 4 else kwargs.get("reduce")
            coords = list(torch.meshgrid(*[torch.arange(n, device=index.device) for n in index.shape], indexing="ij"))
            coords[dim] = index.long()
            lin = torch.zeros_like(index, dtype=torch.int64)
            for k, c in enumerate(coords):
                lin = lin * dst.shape[k] + c
            if name.startswith("scatter_add") or reduce in ("sum", "mean"):
                if dst.is_floating_point() and self._clash(lin):
                    self.sites[(name, self._site())] += 1
            elif reduce is None and isinstance(src, torch.Tensor) and src.numel() > 1:
                if self._clash(lin, src[tuple(slice(0, n) for n in index.shape)].reshape(-1, 1)):
                    self.sites[(name + " with clashing duplicates", self._site())] += 1
        return out


def main_nondet(dev, sensor: str) -> int:
    """One eager run (no CUDA graphs: the scan reads every scatter's
    indices) of chip_smoke.py's phase 7, 8 or 14a (`flagship`) under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, which warns
    once for every op that has no deterministic CUDA path, and under
    `NondetSites`; prints both lists. The switches are restored after the run."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker

    Tracker.default_cuda_graphs = False
    try:
        return _nondet_run(dev, sensor)
    finally:
        Tracker.default_cuda_graphs = True


def _nondet_run(dev, sensor: str) -> int:
    from pli_slam_tpu_torch.system import System

    if sensor == "flagship":
        _, cam, traj, frames = loop_frames(dev)

        def drive():
            inertial_loop_run(flagship_config(), cam, traj, frames, dev)
    else:
        cfg, cam, frames = sensor_run(sensor, dev)
        sysm = System(cam, cfg, device=dev)
        sysm.tracker.streaming = sensor == "rgbd"

        def drive():
            for fr in frames:
                if sensor == "rgbd":
                    sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"])
                else:
                    sysm.track_monocular(fr["img_l"], fr["t"])
    mode = NondetSites()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, mode:
            warnings.simplefilter("always")
            drive()
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught if "deterministic" in str(w.message)})
    print(f"nondet[{sensor}]: ops without a deterministic CUDA path ({len(ops)}): {ops}", flush=True)
    for (op, site), n in sorted(mode.sites.items(), key=lambda kv: kv[0][1]):
        print(f"nondet[{sensor}]: {site}: {op}, {n} calls", flush=True)
    if not mode.sites:
        print(f"nondet[{sensor}]: no order-dependent scatter on this run's data", flush=True)
    return 0


def main_init_split(dev) -> int:
    """`--init-split` (see the module docstring)."""
    import importlib

    from pli_slam_tpu_torch.frontend import graphs
    from pli_slam_tpu_torch.frontend import tracker as tr_mod

    split: dict = {}

    def timed(name, fn):
        def wrap(*args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize(dev)
            split[name] = split.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrap

    # the parts that exist on this tree: its methods, the stages, and where the tracker still runs the MAP
    # problem eagerly (no "imu_init" stage: a synchronise cannot sit inside a stage's capture) its functions
    parts = [("pli_slam_tpu_torch.frontend.tracker", "Tracker._full_inertial_ba", "full_inertial_ba"),
             ("pli_slam_tpu_torch.frontend.tracker", "Tracker._try_imu_init", "try_imu_init")]
    if not hasattr(tr_mod.Tracker, "_imu_init_stage"):
        parts += [("pli_slam_tpu_torch.solve.inertial", "estimate_gyro_bias", "gyro_bias"),
                  ("pli_slam_tpu_torch.solve.imu_init", "gravity_dir_seed", "gravity_seed"),
                  ("pli_slam_tpu_torch.solve.imu_init", "velocity_seed", "velocity_seed"),
                  ("pli_slam_tpu_torch.solve.imu_init", "inertial_optimization", "map"),
                  ("pli_slam_tpu_torch.frontend.tracker", "Tracker._kf_chain", "kf_chain")]
    for mod_name, attr, label in parts:
        owner = importlib.import_module(mod_name)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        if hasattr(owner, name):
            setattr(owner, name, timed(label, getattr(owner, name)))
    stage_call = graphs.StageProgram.__call__

    def stage(self, *args):
        if self.name not in ("imu_init", "vi_ba"):
            return stage_call(self, *args)
        return timed(f"stage {self.name}", stage_call)(self, *args)

    graphs.StageProgram.__call__ = stage
    cfg, cam = slice_config_vi(), slice_camera()
    frames = vi_frames(cam, cfg, N_FRAMES_VI, dev)
    for cuda_graphs in (True, False):
        t0 = time.perf_counter()
        tracker = tr_mod.Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
        torch.cuda.synchronize(dev)
        built_ms = (time.perf_counter() - t0) * 1e3
        tracker.streaming = True
        for i, fr in enumerate(frames):
            split.clear()
            caps = {p.name: p.capture_ms for p in tracker.stage_programs()}
            was = tracker.imu_ready
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            if tracker.imu_ready and not was:
                cap = {p.name: round(p.capture_ms - caps.get(p.name, 0.0), 1) for p in tracker.stage_programs()
                       if p.capture_ms > caps.get(p.name, 0.0)}
                print(f"init-split[graphs={cuda_graphs}]: the tracker built in {built_ms:.1f} ms (its warm-ups "
                      f"{getattr(tracker, 'init_warmup_ms', None)} ms); IMU init at frame {i} "
                      f"({tracker.imu_init_log[-1]['n_kf']} keyframes): the frame {ms:.1f} ms; split (ms, "
                      f"synchronised) {({k: round(v, 1) for k, v in split.items()})}; captures during the frame "
                      f"(ms) {cap}", flush=True)
                break
    graphs.StageProgram.__call__ = stage_call
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile", help="directory for the op tables")
    ap.add_argument("--vi", action="store_true", help="profile the stereo-inertial path instead of the visual one")
    ap.add_argument("--vi-drift", type=int, metavar="N", default=0,
                    help="instead: N frames of the stereo-inertial path, twice, printing the drift per frame")
    ap.add_argument("--spread", choices=("rgbd", "mono", "loop", "flagship"),
                    help="instead: chip_smoke.py's RGB-D, mono, loop-closing (6a) or inertial-closure (14a) phase, "
                         "N_SPREAD times, printing "
                         "each run's accuracy and whether the runs were bit-identical")
    ap.add_argument("--first-closure", action="store_true",
                    help="instead: phase 6a twice in this fresh process: the warm-up at construction, the first "
                         "closure's wall time and the second's")
    ap.add_argument("--stages", action="store_true", help="instead: only the synchronised stage pass (pass 3)")
    ap.add_argument("--nondet", choices=("rgbd", "mono", "flagship"),
                    help="instead: one run of phase 7, 8 or 14a listing the ops that can make the card's runs differ")
    ap.add_argument("--init-split", action="store_true",
                    help="instead: the stereo-inertial path's IMU-init frame split into its parts, graphs and eager")
    ap.add_argument("--busy", action="store_true",
                    help="instead: the busy share of a window of fused visual and of fused stereo-inertial frames")
    ap.add_argument("--ba-cost", action="store_true",
                    help="instead: the device time of the visual path's windowed BA (local_ba, solve_ba) and "
                         "of the visual-inertial BA in float32 and float64")
    ap.add_argument("--rounding", choices=("loop", "mono-vi", "one-ulp", "vi"),
                    help="instead: the rounding tracer (utils/rounding.py): phase 6a's frames under this tree's "
                         "rot3 and each of --variants, or phase 11's under both two-view routes, or (one-ulp) "
                         "phases 5, 7, 12 and 14b under graphs plain and one ulp off, or (vi) phases 5, 12 and "
                         "14b so eagerly, recorded stage by stage, and where the runs part")
    ap.add_argument("--variants", metavar="DIR", help="with --rounding loop: a directory of rot3 sources (*.cu)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    hamming.build()
    if args.vi_drift:
        return main_vi_drift(dev, args.vi_drift)
    if args.spread:
        return main_spread(dev, args.spread)
    if args.first_closure:
        return main_spread(dev, "loop", n_runs=2)
    if args.nondet:
        return main_nondet(dev, args.nondet)
    if args.init_split:
        return main_init_split(dev)
    if args.busy:
        return main_busy(dev)
    if args.ba_cost:
        return main_ba_cost(dev)
    if args.rounding:
        from pli_slam_tpu_torch.utils import rounding

        return rounding.main(dev, args.rounding, args.variants)
    if args.vi:
        return main_vi(dev)
    cfg, cam = slice_config(), slice_camera()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
    if args.stages:
        return main_stages(cam, cfg, frames, dev)
    acts = torch.profiler.ProfilerActivity

    wall0, _ = _window(cam, cfg, frames, dev)
    prof1 = torch.profiler.profile(activities=[acts.CUDA])
    wall1, tracker1 = _window(cam, cfg, frames, dev, prof1)
    trace = os.path.join("build", "profile_trace.json")
    os.makedirs("build", exist_ok=True)
    prof1.export_chrome_trace(trace)
    busy_us, n_dev, launches, graph_launches = trace_busy(trace)
    cap_ms, pool = capture_stats(tracker1)
    os.remove(trace)
    print(f"profile: window of {N_WINDOW} frames (frames {N_WARM}-{N_WARM + N_WINDOW - 1}); "
          f"untraced wall {wall0 * 1e3:.1f} ms ({wall0 * 1e3 / N_WINDOW:.1f} ms/frame); "
          f"traced (CUDA activity only) wall {wall1 * 1e3:.1f} ms ({wall1 / wall0:.2f}x the untraced)", flush=True)
    print(f"profile: device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall1:.1f}% of the traced window; "
          f"over the untraced window's wall time (derived estimate) {100 * busy_us / 1e6 / wall0:.1f}%; "
          f"{n_dev} device activities; from the host {launches} kernel launches ({launches / N_WINDOW:.0f} per "
          f"frame) and {graph_launches} graph launches ({graph_launches / N_WINDOW:.1f} per frame); the fused step "
          f"captured in {cap_ms:.1f} ms (warm-up included), graph pool {pool / 2**20:.1f} MiB", flush=True)

    prof2 = torch.profiler.profile(activities=[acts.CPU, acts.CUDA])
    wall2, _ = _window(cam, cfg, frames, dev, prof2)
    ka = prof2.key_averages()
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(ka.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=70) + "\n")
        f.write(ka.table(sort_by="count", row_limit=40, max_name_column_width=70) + "\n")
    top = sorted(ka, key=lambda e: -e.self_device_time_total)[:8]
    print(f"ops (CPU+CUDA traced window, wall {wall2 * 1e3:.1f} ms): top by device time: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top), flush=True)
    top = sorted((e for e in ka if e.key.startswith("aten::")), key=lambda e: -e.count)[:8]
    print("ops: top aten ops by calls: " + "; ".join(f"{e.key} x{e.count}" for e in top), flush=True)

    return main_stages(cam, cfg, frames, dev)


def main_stages(cam, cfg, frames, dev) -> int:
    """Pass 3 alone: the synchronised stage times of the visual path."""
    frame_ms, stage_ms = _stages(cam, cfg, frames, dev)
    steady = frame_ms[N_WARM:]
    print(f"stages (synchronised), frames {N_WARM}-{N_FRAMES - 1}: frame mean {np.mean(steady):.2f} ms, "
          f"p50 {np.percentile(steady, 50):.2f}, p99 {np.percentile(steady, 99):.2f}", flush=True)
    for name, v in sorted(stage_ms.items(), key=lambda kv: -sum(kv[1])):
        print(f"  {name:18s} calls {len(v):3d} (frames 0-{N_FRAMES - 1})  mean {np.mean(v):8.2f} ms  "
              f"{100 * sum(v) / sum(frame_ms):5.1f}% of all frames' time", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
