"""What the drivers share: the device choice, the per-frame stage timer and
the report each run ends with."""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from pli_slam_tpu_torch.utils import log, viewer
from pli_slam_tpu_torch.utils.trajectory import ate_rmse


def pick_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else the first GPU; no GPU and no `--cpu` is an error."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device found: pass --cpu to run on the CPU")
    return torch.device("cuda", 0)


def add_common_args(ap) -> None:
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--no-plots", action="store_true", help="write no PNG plots (matplotlib is then not needed)")


def stage_timer(device) -> log.StageTimer:
    """`ingest` (reading and decoding the frame) and `track` (the System
    call), the device synchronised at both ends of each."""
    return log.StageTimer(["ingest", "track"], device=device)


def finish(out_dir: str, sysm, timer: log.StageTimer, stamps: list[float], gt, no_plots: bool,
           **extra) -> dict:
    """Write track_times.csv, ate.txt (with ground truth), the plots and
    summary.json; print the rates and the ATE. Returns the summary."""
    timer.save_csv(os.path.join(out_dir, "track_times.csv"))
    means = timer.means_ms()
    frame_ms = np.asarray([sum(r.values()) for r in timer.rows]) * 1e3
    steady = frame_ms[1:] if len(frame_ms) > 1 else frame_ms
    summary = {"frames": len(stamps), "n_kf": int(sysm.tracker.n_kf),
               "fps": float(1e3 / steady.mean()) if len(steady) else 0.0,
               "p50_ms": float(np.percentile(steady, 50)) if len(steady) else 0.0,
               "p99_ms": float(np.percentile(steady, 99)) if len(steady) else 0.0,
               "ingest_ms": means.get("ingest", 0.0), "track_ms": means.get("track", 0.0), "ate": None, **extra}
    print(f"done: {len(stamps)} frames, {summary['fps']:.2f} fps over frames 1-{len(stamps) - 1} (p50 "
          f"{summary['p50_ms']:.1f} ms, p99 {summary['p99_ms']:.1f} ms); per-stage ms (mean): "
          f"{ {k: round(v, 2) for k, v in means.items()} }", flush=True)
    if not no_plots:
        viewer.draw_map(sysm.tracker, os.path.join(out_dir, "map.png"))
    if gt is not None and len(stamps):
        est = sysm.tracker.positions()
        summary["ate"] = ate = float(ate_rmse(est, np.asarray(gt)[:len(est)]))
        print(f"ATE RMSE vs ground truth: {ate:.4f} m", flush=True)
        with open(os.path.join(out_dir, "ate.txt"), "w") as f:
            f.write(f"{ate:.6f}\n")
        if not no_plots:
            viewer.draw_trajectory_comparison(est, np.asarray(gt)[:len(est)], os.path.join(out_dir, "trajectory.png"),
                                              ate)
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    return summary


def progress(i: int, info: dict) -> None:
    if i % 50 == 0:
        print(f"frame {i:5d} {info['state']:>15s} inliers={info['n_inliers']:4d} kf={info['n_kf']:4d}", flush=True)
