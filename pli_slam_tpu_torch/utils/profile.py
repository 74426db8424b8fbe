"""Where the port's main paths spend their time on one GPU.

Run from the repository root:
  python3 -m pli_slam_tpu_torch.utils.profile [--out DIR] [--vi | --vi-drift N | --spread rgbd|mono|loop
                                              | --first-closure | --nondet rgbd|mono | --stages]

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
   Launches are the trace's `cudaLaunchKernel` calls.
2. ops: torch.profiler with CPU and CUDA activity: the top ops by device
   time and by call count (written to DIR/ops.txt).
3. stages: all 40 frames with `torch.cuda.synchronize()` around each stage
   (build_frame and the step's stages), which makes the stage times exclusive
   and inflates the frame.

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
`--spread rgbd|mono|loop` runs chip_smoke.py's RGB-D, mono or loop-closing
(6a) phase N_SPREAD times on the same frames and prints each run's
accuracy, a digest of its trajectory, and whether all runs were
bit-identical. `--first-closure` runs phase 6a twice in a fresh process:
the closure warm-up's time at Tracker construction, the first closure's
wall time and the second's. `--nondet rgbd|mono` runs phase 7 or 8 once
under `torch.use_deterministic_algorithms(True, warn_only=True)` (a
diagnostic switched off again after the run) and `NondetSites`, and lists
the ops that can make two runs differ. `--stages` runs only pass 3 (the
synchronised stage times), which `python3 -m
pli_slam_tpu_torch.scripts.profile_stages` also runs.

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
    flagship trajectory."""
    from pli_slam_tpu_torch.utils import synthetic

    cfg, cam = loop_config(), slice_camera()
    traj = synthetic.Trajectory(**FLAGSHIP_TRAJ)
    return cfg, cam, traj, list(synthetic.make_sequence(cam, N_FRAMES_LOOP + N_AFTER_LOOP, dev, fps=cfg.fps,
                                                        traj=traj))


def overlapping_pair(tracker, traj, min_gap: int):
    """The keyframe pair (newer, older), at least `min_gap` slots apart, whose
    ground-truth poses are nearest (distance in m plus viewing-direction
    angle in rad), from the keyframes' stamps: (newer, older, cost)."""
    n = tracker.n_kf
    stamps = tracker.kstore.stamp[:n].cpu().numpy()
    valid = tracker.kstore.valid[:n].cpu().numpy()
    poses = [traj.pose(float(t)) for t in stamps]
    best = (np.inf, -1, -1)
    for i in range(n):
        for j in range(i - min_gap + 1):
            if not (valid[i] and valid[j]):
                continue
            (Ri, pi), (Rj, pj) = poses[i], poses[j]
            cost = np.linalg.norm(pi - pj) + np.arccos(np.clip(Ri[:, 2] @ Rj[:, 2], -1.0, 1.0))
            best = min(best, (cost, i, j))
    return best[1], best[2], best[0]


def kf_error(tracker, traj) -> float:
    """The largest position error of a valid keyframe against the truth at its stamp (tracker world)."""
    n = tracker.n_kf
    valid = tracker.kstore.valid[:n].cpu().numpy()
    R, t = tracker.kstore.R[:n].cpu().numpy(), tracker.kstore.t[:n].cpu().numpy()
    R0, p0 = traj.pose(0.0)
    gt = np.stack([R0.T @ (traj.pose(float(s))[1] - p0) for s in tracker.kstore.stamp[:n].cpu().numpy()])
    return float(np.linalg.norm(-np.einsum("kji,kj->ki", R, t) - gt, axis=1)[valid].max())


def loop_run(cfg, cam, traj, frames, dev) -> dict:
    """Phase 6a on `frames` (from `loop_frames`): a fresh tracker in streaming
    mode, its rare paths timed by SyncSpans, over the first N_FRAMES_LOOP
    frames; then, if the run closed no loop (no candidate reaches the closer
    on this trajectory, in the reference too), a closure planted between the
    keyframes that ground truth says overlap, the consistency counter
    pre-set, and the correction once more, warm (its result dropped); then
    the remaining frames and the queued GBA chunks, and `finalize`.
    Returns what chip_smoke.py logs and guards."""
    from pli_slam_tpu_torch.frontend.loop_closing import apply_loop_correction
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import synthetic

    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    tracker.span = spans = SyncSpans(dev)  # times the rare paths only: ordinary frames run unsynchronised
    t_loop, t_gba = spans.ms["loop"], spans.ms["gba"]
    lc = tracker.loop_closer
    kf_errs, ms_plain, loop_frames_ = [], [], []  # kf_errs: the largest keyframe error after each GBA chunk

    def run(fr, i):
        n_gba, n_loop, n_closed = len(t_gba), len(t_loop), lc.n_loops_closed
        f0 = time.perf_counter()
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        dt = (time.perf_counter() - f0) * 1e3
        if len(t_loop) > n_loop:  # a loop verification ran in this frame
            loop_frames_.append((i, round(dt, 2), lc.n_loops_closed > n_closed))
        elif len(t_gba) > n_gba:
            kf_errs.append(kf_error(tracker, traj))
        elif i > 0:
            ms_plain.append(dt)

    wall0 = time.perf_counter()
    for i, fr in enumerate(frames[:N_FRAMES_LOOP]):
        run(fr, i)
    _sync(dev)
    wall = time.perf_counter() - wall0
    gt = np.stack([fr["p_w"] for fr in frames])
    pend, done = list(tracker._traj_pending), list(tracker._traj_done)  # read without consuming
    ate_run = synthetic.ate_rmse(tracker.positions(), gt[:N_FRAMES_LOOP])
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
        planted = dict(kf_cur=kf_cur, kf_loop=kf_loop, cost=cost, ms=t_loop[-1], closed=closed,
                       kf_before=kf_before, kf_after=kf_after, warm_ms=spans.ms["correction"][0])
    n_queued = len(tracker._deferred_ba)
    for i, fr in enumerate(frames[N_FRAMES_LOOP:], N_FRAMES_LOOP):
        run(fr, i)
    while tracker._deferred_ba:
        tracker.run_deferred_ba(1)
        kf_errs.append(kf_error(tracker, traj))
    tracker.finalize()
    est = tracker.positions()
    _sync(dev)
    ate = synthetic.ate_rmse(est, gt) if est.shape == gt.shape else float("nan")
    return dict(tracker=tracker, t_gba=t_gba, t_loop=t_loop, kf_errs=kf_errs, ms_plain=ms_plain,
                loop_frames=loop_frames_, wall=wall, ate_run=ate_run, natural=natural, n_kf_run=n_kf_run,
                planted=planted, n_queued=n_queued, est=est, ate=ate)


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


def trace_busy(trace_path: str) -> tuple[float, int, int]:
    """(device busy us, device activities, cudaLaunchKernel calls) of a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [(e["ts"], e["dur"]) for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launches = sum(1 for e in events if e.get("cat") == "cuda_runtime" and e.get("name") == "cudaLaunchKernel")
    return union_us(dev), len(dev), launches


def _window(cam, cfg, frames, dev, profiler=None) -> float:
    """Fresh tracker, warm frames untimed, then the window's host wall time
    (seconds, ending in a device sync), inside `profiler` when given."""
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
    return wall


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
        tracker = tr_mod.Tracker(cam, cfg, dev)
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


def _traced(tracker, frames, label: str):
    """Drive `frames` through `tracker` inside a CUDA-only trace; prints the
    window's wall time, device busy time and launches per frame."""
    acts = torch.profiler.ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[acts.CUDA]) as prof:
        t0 = time.perf_counter()
        for fr in frames:
            tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    trace = os.path.join("build", "profile_trace.json")
    os.makedirs("build", exist_ok=True)
    prof.export_chrome_trace(trace)
    busy_us, n_dev, launches = trace_busy(trace)
    os.remove(trace)
    n = len(frames)
    print(f"profile[vi]: {label}: {n} frames traced (CUDA activity only), wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / n:.1f} ms/frame); device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
          f"of the traced window; {launches} cudaLaunchKernel calls ({launches / n:.0f} per frame)", flush=True)


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
    k += N_WINDOW
    while not tracker.imu_ready and k < N_FRAMES_VI:
        fr = frames[k]
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
        k += 1
    if not tracker.imu_ready:
        raise SystemExit("profile: IMU initialization did not fire")
    print(f"profile[vi]: IMU initialization fired at frame {k - 1}: {tracker.imu_init_log[-1]}", flush=True)
    for fr in frames[k:k + 3]:  # the first fused frames allocate
        tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
    k += 3
    _traced(tracker, frames[k:k + N_WINDOW], f"fused stereo-inertial step, frames {k}-{k + N_WINDOW - 1}")

    frame_ms, stage_ms, tr = _stages(cam, cfg, frames, dev, vi=True)
    print(f"stages[vi] (synchronised), frames 0-{N_FRAMES_VI - 1}: frame mean {np.mean(frame_ms):.2f} ms, "
          f"p50 {np.percentile(frame_ms, 50):.2f}, p99 {np.percentile(frame_ms, 99):.2f}; "
          f"IMU init accepted with {tr.imu_init_log[-1]['n_kf']} keyframes", flush=True)
    for name, v in sorted(stage_ms.items(), key=lambda kv: -sum(kv[1])):
        print(f"  {name:20s} calls {len(v):3d} (frames 0-{N_FRAMES_VI - 1})  mean {np.mean(v):8.2f} ms  "
              f"{100 * sum(v) / sum(frame_ms):5.1f}% of all frames' time", flush=True)
    return 0


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
    """`n_runs` runs of chip_smoke.py's phase 7 (`rgbd`), 8 (`mono`) or 6a
    (`loop`) on the same rendered frames, each on a fresh tracker: do the
    card's runs of one build give the same bits? Per run: ATE (mono: after a
    Sim(3) alignment), keyframes, the largest position error, a digest of
    the trajectory; `loop` also the closure's and the warm-up's wall time
    (the first run's closure is the first in this process). Ends with one
    line saying whether every run's trajectory was bit-identical."""
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import trajectory as tio

    digests = []
    if which == "loop":
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
    """One run of chip_smoke.py's phase 7 (or 8) under
    `torch.use_deterministic_algorithms(True, warn_only=True)`, which warns
    once for every op that has no deterministic CUDA path, and under
    `NondetSites`; prints both lists. The switch is restored after the run."""
    from pli_slam_tpu_torch.system import System

    cfg, cam, frames = sensor_run(sensor, dev)
    sysm = System(cam, cfg, device=dev)
    sysm.tracker.streaming = sensor == "rgbd"
    mode = NondetSites()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught, mode:
            warnings.simplefilter("always")
            for fr in frames:
                if sensor == "rgbd":
                    sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"])
                else:
                    sysm.track_monocular(fr["img_l"], fr["t"])
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split("\n")[0][:160] for w in caught if "deterministic" in str(w.message)})
    print(f"nondet[{sensor}]: ops without a deterministic CUDA path ({len(ops)}): {ops}", flush=True)
    for (op, site), n in sorted(mode.sites.items(), key=lambda kv: kv[0][1]):
        print(f"nondet[{sensor}]: {site}: {op}, {n} calls", flush=True)
    if not mode.sites:
        print(f"nondet[{sensor}]: no order-dependent scatter on this run's data", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile", help="directory for the op tables")
    ap.add_argument("--vi", action="store_true", help="profile the stereo-inertial path instead of the visual one")
    ap.add_argument("--vi-drift", type=int, metavar="N", default=0,
                    help="instead: N frames of the stereo-inertial path, twice, printing the drift per frame")
    ap.add_argument("--spread", choices=("rgbd", "mono", "loop"),
                    help="instead: chip_smoke.py's RGB-D, mono or loop-closing (6a) phase, N_SPREAD times, printing "
                         "each run's accuracy and whether the runs were bit-identical")
    ap.add_argument("--first-closure", action="store_true",
                    help="instead: phase 6a twice in this fresh process: the warm-up at construction, the first "
                         "closure's wall time and the second's")
    ap.add_argument("--stages", action="store_true", help="instead: only the synchronised stage pass (pass 3)")
    ap.add_argument("--nondet", choices=("rgbd", "mono"),
                    help="instead: one run of phase 7 or 8 listing the ops that can make the card's runs differ")
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
    if args.vi:
        return main_vi(dev)
    cfg, cam = slice_config(), slice_camera()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
    if args.stages:
        return main_stages(cam, cfg, frames, dev)
    acts = torch.profiler.ProfilerActivity

    wall0 = _window(cam, cfg, frames, dev)
    prof1 = torch.profiler.profile(activities=[acts.CUDA])
    wall1 = _window(cam, cfg, frames, dev, prof1)
    trace = os.path.join("build", "profile_trace.json")
    os.makedirs("build", exist_ok=True)
    prof1.export_chrome_trace(trace)
    busy_us, n_dev, launches = trace_busy(trace)
    os.remove(trace)
    print(f"profile: window of {N_WINDOW} frames (frames {N_WARM}-{N_WARM + N_WINDOW - 1}); "
          f"untraced wall {wall0 * 1e3:.1f} ms ({wall0 * 1e3 / N_WINDOW:.1f} ms/frame); "
          f"traced (CUDA activity only) wall {wall1 * 1e3:.1f} ms ({wall1 / wall0:.2f}x the untraced)", flush=True)
    print(f"profile: device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall1:.1f}% of the traced window; "
          f"over the untraced window's wall time (derived estimate) {100 * busy_us / 1e6 / wall0:.1f}%; "
          f"{n_dev} device activities, {launches} cudaLaunchKernel calls "
          f"({launches / N_WINDOW:.0f} per frame)", flush=True)

    prof2 = torch.profiler.profile(activities=[acts.CPU, acts.CUDA])
    wall2 = _window(cam, cfg, frames, dev, prof2)
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
