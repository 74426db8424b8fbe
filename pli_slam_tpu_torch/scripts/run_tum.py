"""TUM RGB-D replay: a sequence through the port's System (RGB-D path).

  python3 -m pli_slam_tpu_torch.scripts.run_tum <sequence_dir> [--frames N] [--out DIR]
      [--freiburg 1|2|3] [--cpu] [--no-plots]

rgb.txt / depth.txt are associated inline (or associations.txt is read);
SlamConfig(sensor="rgbd", 640x480, 30 fps) on the freiburg intrinsics.
Writes trajectory_tum.txt, keyframes_tum.txt, track_times.csv,
summary.json, and with ground truth ate.txt; plots unless `--no-plots`.
"""

from __future__ import annotations

import argparse
import os

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequence_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default="results_tum")
    ap.add_argument("--freiburg", type=int, default=3, choices=(1, 2, 3))
    common.add_common_args(ap)
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    os.makedirs(args.out, exist_ok=True)

    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils.config import SlamConfig
    from pli_slam_tpu_torch.utils.datasets import TumCalib, TumRgbdSequence

    calib = TumCalib.freiburg(args.freiburg)
    seq = TumRgbdSequence(args.sequence_dir, calib)
    cam = Camera.pinhole(fx=calib.fx, fy=calib.fy, cx=calib.cx, cy=calib.cy, bf=calib.bf,
                         width=calib.width, height=calib.height)
    cfg = SlamConfig(sensor="rgbd", width=calib.width, height=calib.height, fps=30.0)
    sysm = System(cam, cfg, device=dev)
    sysm.tracker.streaming = True
    print(f"sequence: {len(seq)} associated frames; running {args.frames or len(seq)} on {dev}", flush=True)

    frame_iter = seq.frames(stop=args.frames)
    timer = common.stage_timer(dev)
    stamps = []
    while True:
        with timer.stage("ingest"):
            fr = next(frame_iter, None)
        if fr is None:
            break
        with timer.stage("track"):
            info = sysm.track_rgbd(fr["img"], fr["depth"], fr["t"])
        timer.end_frame()
        common.progress(len(stamps), info)
        stamps.append(fr["t"])
    sysm.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    sysm.save_keyframe_trajectory_tum(os.path.join(args.out, "keyframes_tum.txt"))
    common.finish(args.out, sysm, timer, stamps, seq.gt_positions_at(stamps), args.no_plots)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
