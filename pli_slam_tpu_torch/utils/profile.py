"""Where the port's main path spends its time on one GPU.

Run from the repository root:  python3 -m pli_slam_tpu_torch.utils.profile [--out DIR]

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

from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.ops.camera import Camera

N_FRAMES = 40
N_WARM = 12  # frames before the timed window, as bench.py's run_visual
N_WINDOW = 10
STAGES = ("track_step", "insert_keyframe", "local_ba", "far_point_depths", "_local_map_ids")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def loop_off(cfg: SlamConfig) -> SlamConfig:
    """`cfg` with loop closing off (loop closing is not ported yet)."""
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=False))


def slice_config() -> SlamConfig:
    """The ported slice's configuration: the EuRoC operating point at its
    published widths with loop closing off."""
    return loop_off(SlamConfig.euroc_stereo())


def slice_camera() -> Camera:
    """bench.py's camera: EuRoC-like 752x480 pinhole, fx=435.2, bf=0.11 fx."""
    return Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)


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


def _stages(cam, cfg, frames, dev):
    """Pass 3: per-stage wall time with a device sync around each stage."""
    from pli_slam_tpu_torch.frontend import step as step_mod
    from pli_slam_tpu_torch.frontend import tracker as tr_mod

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

    saved = [(step_mod, n, getattr(step_mod, n)) for n in STAGES] + [(tr_mod, "build_frame", tr_mod.build_frame)]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
        tracker = tr_mod.Tracker(cam, cfg, dev)
        tracker.streaming = True
        frame_ms = []
        for i, fr in enumerate(frames):
            torch.cuda.synchronize()
            s = time.perf_counter()
            tracker.process(fr["img_l"], fr["img_r"], fr["t"])
            torch.cuda.synchronize()
            frame_ms.append((time.perf_counter() - s) * 1e3)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return frame_ms, stage_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile", help="directory for the op tables")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic

    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    hamming.build()
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
