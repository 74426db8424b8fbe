"""Where the port's main paths spend their time on one GPU.

Run from the repository root:
  python3 -m pli_slam_tpu_torch.utils.profile [--out DIR] [--vi | --vi-drift N | --spread rgbd|mono]

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
drifted from the truth, up to the frame where a run reaches an unported path.
`--spread rgbd|mono` runs chip_smoke.py's RGB-D or mono phase N_SPREAD times
on the same frames and prints each run's accuracy (the card's runs are not
bit-reproducible).

Needs a CUDA device. The chrome trace of pass 1 is written under `build/`
and deleted once read (it runs to ~100 MB).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

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
        fr["imu"] = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
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


class SyncSpans:
    """A `Tracker.span` that records each rare path's wall time: `ms[name]`
    gets one entry in ms per call, the device synchronised at both ends so
    that the time is the path's own."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.ms: dict[str, list[float]] = defaultdict(list)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
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
            try:
                info = tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
            except NotImplementedError as e:
                print(f"drift[{rep}]: frame {i}: the run ends here: {e}", flush=True)
                break
            gt.append(fr["p_w"])
            if not tracker.imu_ready:
                continue
            ate = synthetic.ate_rmse(tracker.positions(), np.stack(gt))
            v_err = float(np.linalg.norm(tracker.v_w.cpu().numpy() - fr["v_w"]))
            ba_err = float(np.linalg.norm(tracker.ba.cpu().numpy() - ba_true))
            print(f"drift[{rep}]: frame {i} {info['state']} inliers {info['n_inliers']} n_kf {info['n_kf']} "
                  f"|v - v_true| {v_err:.3f} m/s |ba - ba_true| {ba_err:.3f} m/s^2 ATE {ate:.4f} m", flush=True)
    return 0


def main_spread(dev, sensor: str) -> int:
    """N_SPREAD runs of chip_smoke.py's phase 7 or 8 through `System` on the
    same rendered frames: how far the card's runs of one build spread (its
    scatter-adds use float atomics, so runs differ from the first rounding
    on). Per run: ATE (mono: after a Sim(3) alignment), keyframes, frames
    tracked, the first tracked frame and the largest position error."""
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import trajectory as tio

    cfg, cam, frames = sensor_run(sensor, dev)
    gt = np.stack([fr["p_w"] for fr in frames])
    for rep in range(N_SPREAD):
        sysm = System(cam, cfg, device=dev)
        sysm.tracker.streaming = sensor == "rgbd"
        states = []
        for fr in frames:
            info = (sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"]) if sensor == "rgbd"
                    else sysm.track_monocular(fr["img_l"], fr["t"]))
            states.append(info["state"])
        sysm.shutdown()
        est = np.stack([p for _, _, p in sysm.tracker.trajectory])
        s, R, t = tio.align_umeyama(est, gt, with_scale=sensor == "mono")
        err = np.linalg.norm(s * est @ R.T + t - gt, axis=1)
        print(f"spread[{sensor} {rep}]: ATE {tio.ate_rmse(est, gt, with_scale=sensor == 'mono'):.4f} m, "
              f"{sysm.tracker.n_kf} keyframes, states OK {sum(x == 'OK' for x in states)}/{len(states)} (first at "
              f"frame {states.index('OK') if 'OK' in states else None}), largest aligned error {err.max():.4f} m at "
              f"frame {int(err.argmax())}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile", help="directory for the op tables")
    ap.add_argument("--vi", action="store_true", help="profile the stereo-inertial path instead of the visual one")
    ap.add_argument("--vi-drift", type=int, metavar="N", default=0,
                    help="instead: N frames of the stereo-inertial path, twice, printing the drift per frame")
    ap.add_argument("--spread", choices=("rgbd", "mono"),
                    help="instead: chip_smoke.py's RGB-D or mono phase, N_SPREAD times, printing each run's accuracy")
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
    if args.vi:
        return main_vi(dev)
    cfg, cam = slice_config(), slice_camera()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
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
