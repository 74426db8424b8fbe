"""EuRoC replay: an ASL-format sequence through the port's System.

  python3 -m pli_slam_tpu_torch.scripts.run_euroc <sequence_dir> [--stereo | --stereo-imu]
      [--frames N] [--out DIR] [--native-loader] [--config YAML] [--no-rectify] [--cpu] [--no-plots]

Without `--config` it runs SlamConfig.euroc_stereo(_inertial)() on the
EuRoC camera (`EurocCalib`) with the EuRoC rectifier; with `--config` a
reference-style YAML sets the camera, rectification, Tbc, IMU noise and
ORB budgets (`load_yaml_full`). `--native-loader` decodes the PNGs ahead
on C++ worker threads. Writes trajectory_tum.txt, trajectory_euroc.csv,
keyframes_tum.txt, track_times.csv, summary.json, and with ground truth
ate.txt; plots unless `--no-plots`. (`--mono-imu` is accepted, as by the
reference, and runs stereo.)
"""

from __future__ import annotations

import argparse
import os

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequence_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default="results")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--stereo-imu", action="store_true")
    ap.add_argument("--mono-imu", action="store_true")
    ap.add_argument("--native-loader", action="store_true")
    ap.add_argument("--config", help="reference-style YAML (camera, rectification, Tbc, IMU, ORB)")
    ap.add_argument("--no-rectify", action="store_true")
    common.add_common_args(ap)
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    os.makedirs(args.out, exist_ok=True)

    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.ops.rectify import StereoRectifier, euroc_rectifier
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils.config import SlamConfig, load_yaml_full
    from pli_slam_tpu_torch.utils.euroc import EurocCalib, EurocSequence

    sensor = "stereo_imu" if args.stereo_imu else "stereo"
    rectifier = None
    if args.config:
        cfg, cam, kdrp = load_yaml_full(args.config)
        cfg = cfg.replace(sensor=sensor)
        if kdrp is not None and not args.no_rectify:
            rectifier = StereoRectifier.from_kdrp(*(kdrp[f"{side}.{m}"] for side in ("LEFT", "RIGHT")
                                                    for m in ("K", "D", "R", "P")), cfg.width, cfg.height, dev)
    else:
        cfg = SlamConfig.euroc_stereo_inertial() if sensor == "stereo_imu" else SlamConfig.euroc_stereo()
        c = EurocCalib()
        cam = Camera.pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=c.width, height=c.height)
        rectifier = None if args.no_rectify else euroc_rectifier(dev)
    seq = EurocSequence(args.sequence_dir)
    sysm = System(cam, cfg, rectifier=rectifier, device=dev)
    sysm.tracker.streaming = True  # real-time replay: the stats are read one frame late
    print(f"sequence: {len(seq)} frames; running {args.frames or len(seq)} on {dev}", flush=True)

    frame_iter = seq.frames_native(stop=args.frames) if args.native_loader else seq.frames(stop=args.frames)
    timer = common.stage_timer(dev)
    stamps, imu_init_frame = [], None
    while True:
        with timer.stage("ingest"):
            fr = next(frame_iter, None)
        if fr is None:
            break
        imu = None
        if sensor == "stereo_imu":
            imu = {"gyro": fr["imu_gyro"], "acc": fr["imu_acc"], "stamps": fr["imu_stamps"]}
        with timer.stage("track"):
            info = sysm.track_stereo(fr["img_l"], fr["img_r"], fr["t"], imu_batch=imu)
        timer.end_frame()
        if imu_init_frame is None and sysm.tracker.imu_ready:
            imu_init_frame = len(stamps)
        common.progress(len(stamps), info)
        stamps.append(fr["t"])
    sysm.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    sysm.save_trajectory_euroc(os.path.join(args.out, "trajectory_euroc.csv"))
    sysm.save_keyframe_trajectory_tum(os.path.join(args.out, "keyframes_tum.txt"))
    common.finish(args.out, sysm, timer, stamps, seq.gt_positions_at(stamps), args.no_plots,
                  imu_init_frame=imu_init_frame)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
