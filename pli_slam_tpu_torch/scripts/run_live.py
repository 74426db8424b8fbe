"""Live stereo-inertial run: an EuRoC folder pushed at camera rate by a
producer thread through the live-feed synchronizer into the port's System.

  python3 -m pli_slam_tpu_torch.scripts.run_live <euroc_sequence_dir> [--frames N] [--rate HZ]
      [--config YAML] [--out DIR] [--cpu]

The producer thread stands in for the sensor subscriptions: it pushes each
frame's IMU samples and images, then sleeps 1 / rate. The tracking loop
takes synchronized frames as fast as it tracks them; the image queues are
bounded (8 frames), so when tracking is slower than the camera the oldest
frames are dropped, and the frames still queued when the feed stops are
not tracked. Prints frames pushed, delivered, dropped and left; writes
trajectory_live_tum.txt into `--out` (default: the working directory) and
summary.json. Without `--config`: SlamConfig.euroc_stereo_inertial() on the
EuRoC camera and rectifier, as the reference; `--config` as in run_euroc.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sequence_dir")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--config", help="reference-style YAML, as run_euroc's")
    ap.add_argument("--out", default=".")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    os.makedirs(args.out, exist_ok=True)

    from pli_slam_tpu_torch.frontend.tracker import TrackingState
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.ops.rectify import StereoRectifier, euroc_rectifier
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils.config import SlamConfig, load_yaml_full
    from pli_slam_tpu_torch.utils.euroc import EurocCalib, EurocSequence
    from pli_slam_tpu_torch.utils.livefeed import StereoInertialSync

    rectifier = None
    if args.config:
        cfg, cam, kdrp = load_yaml_full(args.config)
        cfg = cfg.replace(sensor="stereo_imu")
        if kdrp is not None:
            rectifier = StereoRectifier.from_kdrp(*(kdrp[f"{side}.{m}"] for side in ("LEFT", "RIGHT")
                                                    for m in ("K", "D", "R", "P")), cfg.width, cfg.height, dev)
    else:
        c = EurocCalib()
        cam = Camera.pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=c.width, height=c.height)
        cfg = SlamConfig.euroc_stereo_inertial()
        rectifier = euroc_rectifier(dev)
    sysm = System(cam, cfg, rectifier=rectifier, device=dev)
    sysm.tracker.streaming = True
    sync = StereoInertialSync(use_imu=True)
    seq = EurocSequence(args.sequence_dir)
    frames = list(seq.frames(stop=args.frames))  # read up front: the producer pushes at the camera's rate

    def producer():
        for fr in frames:
            for s, g, a in zip(fr["imu_stamps"], fr["imu_gyro"], fr["imu_acc"]):
                sync.imu.push(s, g, a)
            sync.left.push(fr["t"], fr["img_l"])
            sync.right.push(fr["t"], fr["img_r"])
            time.sleep(1.0 / args.rate)
        sync.stop()

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    n, states, t0 = 0, {}, time.time()
    while True:
        item = sync.next_frame(timeout=2.0)
        if item is None:
            break
        info = sysm.track_stereo(item["img_l"], item["img_r"], item["t"], imu_batch=item["imu"])
        states[info["state"]] = states.get(info["state"], 0) + 1
        n += 1
        if n % 50 == 0:
            print(f"frame {n:5d} {info['state']:>15s} kf={info['n_kf']:4d}", flush=True)
    worker.join()
    elapsed = time.time() - t0
    pushed, dropped = sync.left.pushed, sync.left.dropped
    left = pushed - n - dropped
    print(f"live run done: {n} frames in {elapsed:.1f}s ({n / max(elapsed, 1e-9):.2f} fps); frames pushed {pushed} "
          f"at {args.rate:g} Hz, delivered {n}, dropped by the bounded queue {dropped}, still queued when the feed "
          f"stopped {left}; states {states}", flush=True)
    sysm.save_trajectory_tum(os.path.join(args.out, "trajectory_live_tum.txt"))
    summary = {"pushed": pushed, "delivered": n, "dropped": dropped, "left": left, "seconds": elapsed, "states": states,
               "n_kf": int(sysm.tracker.n_kf), "lost": sum(v for k, v in states.items() if k != TrackingState.OK)}
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
