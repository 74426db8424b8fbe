"""End-to-end synthetic run: the port's tracker over the rendered room, with its ATE.

  python3 -m pli_slam_tpu_torch.scripts.run_synthetic [n_frames] [--tiny] [--cpu]

`--tiny` runs SlamConfig.tiny_test() on a 128x96 camera in the small room;
otherwise SlamConfig.euroc_stereo() at 752x480 (bench.py's camera).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=40)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)

    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.config import SlamConfig

    if args.tiny:
        cfg = SlamConfig.tiny_test()
        cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
        traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
        room_half = 2.55  # a small room keeps the tiny camera's disparities useful
    else:
        cfg = SlamConfig.euroc_stereo()
        cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=0.11 * 435.2, width=752, height=480)
        traj = synthetic.Trajectory()
        room_half = synthetic.ROOM_HALF

    tracker = Tracker(cam, cfg, dev)
    gt, times = [], []
    t_start = time.time()
    n = args.n_frames
    for i, fr in enumerate(synthetic.make_sequence(cam, n, dev, fps=cfg.fps, traj=traj, room_half=room_half)):
        t0 = time.time()
        info = tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        dt = time.time() - t0
        times.append(dt)
        gt.append(fr["p_w"])
        if i % 10 == 0 or i == n - 1:
            print(f"frame {i:4d} {info['state']:>15s} inliers={info['n_inliers']:4d} kf={info['n_kf']:3d} "
                  f"pts={info['n_points']:5d} lines={info['n_lines']:4d} {dt * 1e3:7.1f}ms", flush=True)
    gt = np.stack(gt)
    ate = synthetic.ate_rmse(tracker.positions(), gt)
    steady = np.median(times[5:]) if len(times) > 10 else np.median(times)
    print(f"\nATE RMSE: {ate:.4f} m over {n} frames ({np.linalg.norm(np.diff(gt, axis=0), axis=1).sum():.2f} m path)")
    print(f"median frame time: {steady * 1e3:.1f} ms ({1.0 / steady:.1f} fps), total {time.time() - t_start:.1f}s")
    return ate


if __name__ == "__main__":
    main()
