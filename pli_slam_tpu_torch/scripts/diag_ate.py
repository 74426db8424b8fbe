"""Frame against keyframe ATE on the bench scene: is the trajectory readout stale?

  python3 -m pli_slam_tpu_torch.scripts.diag_ate [--tiny] [--cpu]
  (environment: BENCH_FRAMES (40), DIAG_STREAMING (1), DIAG_TIMING (0))

Runs bench.py's visual operating point (SlamConfig.euroc_stereo() on the
752x480 camera) and prints, on stderr, each frame's error after an SE(3)
alignment of the whole trajectory and each keyframe's (the keyframe poses
as BA left them); then one JSON line with both ATEs. If the keyframe ATE is
far below the frame ATE, BA's refinements are not reaching the recorded
frames. With DIAG_TIMING=1 each frame ends in a device sync and its wall
time is printed. `--tiny` runs run_synthetic's tiny scene instead (SlamConfig.tiny_test()
on a 128x96 camera in the small room).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true", help="the 128x96 scene of run_synthetic --tiny")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)

    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.config import SlamConfig
    from pli_slam_tpu_torch.utils.trajectory import align_umeyama

    if args.tiny:
        cfg = SlamConfig.tiny_test()
        cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
        scene = dict(traj=synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25),
                     room_half=2.55)
    else:
        cfg = SlamConfig.euroc_stereo()
        cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
        scene = {}
    n_frames = int(os.environ.get("BENCH_FRAMES", "40"))
    frames = list(synthetic.make_sequence(cam, n_frames, dev, fps=cfg.fps, **scene))
    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = os.environ.get("DIAG_STREAMING", "1") == "1"
    timing = os.environ.get("DIAG_TIMING", "0") == "1"
    for fr in frames:
        t0 = time.perf_counter()
        info = tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        if timing and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"f={fr['t'] * cfg.fps:3.0f} inl={info['n_inliers']:4d} kf={info['n_kf']:2d} pts={info['n_points']:5d} "
              f"lns={info['n_lines']:4d} new={info['new_landmarks']:4d} state={info['state']}"
              + (f" ms={ms:7.1f}" if timing else ""), file=sys.stderr)

    def aligned_err(est, gt):
        s, R, t = align_umeyama(est, gt)
        return np.linalg.norm(s * np.asarray(est, np.float64) @ R.T + t - gt, axis=1)

    gt = np.stack([fr["p_w"] for fr in frames]).astype(np.float64)
    err = aligned_err(tracker.positions(), gt)
    for k in range(n_frames):
        print(f"frame {k:3d}  err={err[k] * 1000:7.1f} mm", file=sys.stderr)
    n_kf = int(tracker.n_kf)
    Rk, tk = tracker.kstore.R[:n_kf].cpu().numpy(), tracker.kstore.t[:n_kf].cpu().numpy()
    stamps = tracker.kstore.stamp[:n_kf].cpu().numpy()
    pk = -np.einsum("kji,kj->ki", Rk, tk)
    gt_kf = np.stack([frames[int(round(s * cfg.fps))]["p_w"] for s in stamps]).astype(np.float64)
    err_k = aligned_err(pk, gt_kf)
    for i in range(n_kf):
        print(f"KF {i:2d} stamp={stamps[i]:5.2f} err={err_k[i] * 1000:7.1f} mm", file=sys.stderr)
    print(json.dumps({"ate_frames_m": round(float(np.sqrt(np.mean(err ** 2))), 4),
                      "ate_kf_m": round(float(np.sqrt(np.mean(err_k ** 2))), 4), "n_kf": n_kf}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
