"""KITTI odometry replay: a stereo sequence through the port's System.

  python3 -m pli_slam_tpu_torch.scripts.run_kitti <sequence_dir> [--frames N] [--out DIR]
      [--poses poses.txt] [--no-lines] [--cpu] [--no-plots]

times.txt, image_0/ image_1/ and calib.txt (P0 / P1); KITTI's operating
point: 2000 ORB features, 10 fps, the raster of the first image. Writes
trajectory_kitti.txt, trajectory_tum.txt, track_times.csv, summary.json,
and with poses ate.txt; plots unless `--no-plots`.
"""

from __future__ import annotations

import argparse
import os

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequence_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default="results_kitti")
    ap.add_argument("--poses", default=None)
    ap.add_argument("--no-lines", action="store_true")
    common.add_common_args(ap)
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    os.makedirs(args.out, exist_ok=True)

    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils.config import OrbConfig, SlamConfig
    from pli_slam_tpu_torch.utils.datasets import KittiSequence

    seq = KittiSequence(args.sequence_dir, poses_txt=args.poses)
    c = seq.calib
    h, w = next(seq.frames(stop=1))["img_l"].shape  # sequences differ: 1241 / 1226 wide
    cam = Camera.pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=w, height=h)
    cfg = SlamConfig(sensor="stereo", width=w, height=h, fps=10.0, orb=OrbConfig(n_features=2000),
                     use_lines=not args.no_lines)
    sysm = System(cam, cfg, device=dev)
    sysm.tracker.streaming = True
    print(f"sequence: {len(seq)} frames at {w}x{h}; running {args.frames or len(seq)} on {dev}", flush=True)

    frame_iter = seq.frames(stop=args.frames)
    timer = common.stage_timer(dev)
    stamps = []
    while True:
        with timer.stage("ingest"):
            fr = next(frame_iter, None)
        if fr is None:
            break
        with timer.stage("track"):
            info = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"])
        timer.end_frame()
        common.progress(len(stamps), info)
        stamps.append(fr["t"])
    sysm.save_trajectory_kitti(os.path.join(args.out, "trajectory_kitti.txt"))
    sysm.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    common.finish(args.out, sysm, timer, stamps, seq.gt_positions_at(stamps), args.no_plots)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
