"""The port's counterpart of the repository's bench.py: the flagship
stereo-inertial run with loop closing on, and the visual run, measured on
one GPU, printed as bench.py's one JSON line.

  python3 -m pli_slam_tpu_torch.scripts.bench [--cpu] [--no-graphs]

BENCH_FRAMES (default 220) and BENCH_FRAMES_VISUAL (default 40) set the
depths, as in bench.py. The line has bench.py's keys and nothing else:
  {"metric": "stereo_inertial_tracking_fps_752x480", "value": <fps>,
   "unit": "fps", "vs_baseline": <fps / 20.0>, "extra": {"p99_ms", "p50_ms",
   "worst_ms", "ate_m_synthetic", "loops_closed", "imu_ready", "frames",
   "n_keyframes", "n_points", "n_lines", "visual_fps", "visual_ate_m"}}
The card's name and power limit (nvidia-smi), the progress, and the
captures' time, graph-pool size and peak memory go to stderr.

`run_flagship` is bench.py's north-star configuration:
SlamConfig.euroc_stereo_inertial() with loop closing on, the IMU
initialized after 1.5 s from 16-sample batches, kf_max_new_points 256, on
bench.py's 752x480 camera (fx 435.2, bf 0.11 fx), over the period-7 s
Lissajous trajectory (utils.profile.FLAGSHIP_TRAJ) with 200 Hz IMU under
ImuNoiseModel.euroc(); streaming mode, 3 untimed frames, then every
frame's host wall time, `finalize` (the queued BA chunks) inside the timed
region. `run_visual` is bench.py's visual run: SlamConfig.euroc_stereo()
with loop closing on, 12 untimed frames. Every frame is rendered on the
host before the run, so the card tracks a CPU's pixels. On a GPU the fused
steps run as CUDA graphs (frontend.graphs), captured inside the timed
frames; `--no-graphs` runs them eagerly.

Not ported: bench.py's persistent XLA compile cache and its whole warm pass
over the sequence with the tracker reset after it (PASS 1); both exist so
that no XLA program compiles inside the timed pass. The port's first-use
costs lie elsewhere:
- the gated-match kernel's build: `hamming.build()`, before anything is timed;
- the loop closer's solvers: `LoopCloser.warm_up` at `Tracker` construction
  on a GPU, before the first frame;
- whatever else a process meets first inside the timed frames: the first
  IMU initialization, the first full-inertial-BA window at each capacity,
  the first relocalization. These land in `worst_ms` and `p99_ms` as they
  come out.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pli_slam_tpu_torch.frontend.step import ST_KF_CREATED
from pli_slam_tpu_torch.scripts import common
from pli_slam_tpu_torch.utils import profile
from pli_slam_tpu_torch.utils.config import SlamConfig

N_WARM_FLAGSHIP = 3  # bench.py: buffer-allocation jitter only
N_WARM_VISUAL = 12
REALTIME_FPS = 20.0  # the reference's real-time contract at EuRoC's 20 fps


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


class _SpanNames:
    """A `Tracker.span` that only notes which rare paths ran (no sync)."""

    def __init__(self):
        self.names: list[str] = []

    def __call__(self, name: str):
        self.names.append(name)
        return contextlib.nullcontext()


def frame_kind(tracker, run):
    """What one `tracker.process` call was, from the tracker's state before
    it (`run` = (fused, n_kf before it -- None before a streaming fused
    frame --, the rare paths' names so far)): "fused" or "host" (host-orchestrated), "+kf" when it made a
    keyframe, "+reloc" when it tried a relocalization, "+rare" for a loop
    closure or a BA chunk. A streaming fused frame's keyframe is known from
    its own stats, still on their way to the host: the kind then comes
    back as (kind, the frame's stats), for `resolve_kind` after the run
    (reading the keyframe count now would make the host wait for the frame
    just launched)."""
    fused, n_kf, n_names = run
    kind = "fused" if fused else "host"
    names = tracker.span.names[n_names:]
    rest = ("+reloc" if "reloc" in names else "") + ("+rare" if any(n != "reloc" for n in names) else "")
    if n_kf is None:
        pending = tracker._pending_stats
        return (kind, rest, pending[1] if pending is not None else None)
    if tracker.n_kf > n_kf:
        kind += "+kf"
    return kind + rest


def resolve_kind(kind) -> str:
    """A `frame_kind` once the frames' stats are read."""
    if isinstance(kind, str):
        return kind
    base, rest, stats = kind
    made = stats is not None and stats.read()[ST_KF_CREATED] > 0
    return base + ("+kf" if made else "") + rest


def frame_split(kinds: list[str], times_ms) -> dict:
    """{kind: (frames, total s, p50 ms, p99 ms)} over the timed frames."""
    out = {}
    for kind in sorted(set(kinds)):
        ms = np.asarray([t for k, t in zip(kinds, times_ms) if k == kind])
        out[kind] = (len(ms), round(float(ms.sum()) / 1e3, 3), round(float(np.percentile(ms, 50)), 1),
                     round(float(np.percentile(ms, 99)), 1))
    return out


def run_flagship(n_frames: int, cam=None, cfg=None, device=None, frames=None, cuda_graphs: bool = True) -> dict:
    """Stereo-inertial tracking with loop closing on, over the revisiting
    Lissajous path (bench.py:78-176 without its warm pass). `cam` and `cfg`
    default to bench.py's camera (752x480, fx 435.2, bf 0.11 fx) and
    configuration (bench.py:84-91). `frames`: the sequence already rendered on
    `device` (`utils.profile.loop_frames`' form), of which the first
    `n_frames` are run. `cuda_graphs=False` runs the fused steps eagerly
    (for comparison). The returned dict also holds the `tracker`."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import synthetic

    cam = profile.slice_camera() if cam is None else cam
    cfg = profile.flagship_config() if cfg is None else cfg
    dev = _device(device)
    if frames is None:
        log(f"bench[flagship]: rendering {n_frames} frames")
        frames = synthetic.make_sequence(cam, n_frames, dev, fps=cfg.fps,
                                         traj=synthetic.Trajectory(**profile.FLAGSHIP_TRAJ),
                                         imu_noise=synthetic.ImuNoiseModel.euroc())
    frames = [(fr["img_l"], fr["img_r"], fr["t"], fr["p_w"], profile.imu_batch(fr)) for fr in frames][:n_frames]
    tracker = Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
    tracker.streaming = True
    tracker.span = _SpanNames()
    log(f"bench[flagship]: rendering done; measuring (loop warm-up at construction: {tracker.loop_warmup_ms} ms)")
    for img_l, img_r, t, _, imu in frames[:N_WARM_FLAGSHIP]:
        tracker.process(img_l, img_r, t, imu=imu)
    times, kinds = [], []
    t0 = time.time()
    for i, (img_l, img_r, t, _, imu) in enumerate(frames[N_WARM_FLAGSHIP:]):
        fused = tracker.imu_ready and tracker.gravity_w is not None and tracker.state == "OK"
        run = (fused, None if fused and tracker.streaming else tracker.n_kf, len(tracker.span.names))
        f0 = time.perf_counter()
        tracker.process(img_l, img_r, t, imu=imu)
        times.append(time.perf_counter() - f0)
        kinds.append(frame_kind(tracker, run))
        if i % 40 == 0:
            log(f"bench[flagship]: frame {i}")
    tracker.finalize()  # drain the queued BA chunks inside the timed region
    tracker.positions()
    elapsed = time.time() - t0
    fps = (n_frames - N_WARM_FLAGSHIP) / elapsed

    gt = np.stack([p for _, _, _, p, _ in frames])
    ate = synthetic.ate_rmse(tracker.positions(), gt)
    times_ms = np.asarray(times) * 1e3
    split = frame_split([resolve_kind(k) for k in kinds], times_ms)
    log(f"bench[flagship]: timed frames by kind (frames, s, p50 ms, p99 ms): {split}")
    return {
        "fps": round(fps, 2),
        "p99_ms": round(float(np.percentile(times_ms, 99)), 1),
        "p50_ms": round(float(np.percentile(times_ms, 50)), 1),
        "worst_ms": round(float(times_ms.max()), 1),
        "ate_m": round(float(ate), 4),
        "loops_closed": int(tracker.loop_closer.n_loops_closed) if tracker.loop_closer else 0,
        "imu_ready": bool(tracker.imu_ready),
        "n_keyframes": int(tracker.n_kf),
        "n_points": int(tracker.pstore.valid.sum()),
        "n_lines": int(tracker.lstore.valid.sum()),
        "frames": n_frames,
        "split": split,
        "tracker": tracker,
    }


def run_visual(n_frames: int, cam=None, cfg=None, device=None, frames=None, cuda_graphs: bool = True) -> dict:
    """The visual-only run (bench.py:178-212): `cfg` defaults to
    SlamConfig.euroc_stereo() (bench.py:184), `cam` and `frames` as in
    `run_flagship` (the room sequence of `synthetic.make_sequence`'s default
    trajectory), as is `cuda_graphs`."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import synthetic

    cam = profile.slice_camera() if cam is None else cam
    cfg = SlamConfig.euroc_stereo() if cfg is None else cfg
    dev = _device(device)
    if frames is None:
        log(f"bench[visual]: rendering {n_frames} frames")
        frames = synthetic.make_sequence(cam, n_frames, dev, fps=cfg.fps)
    frames = [(fr["img_l"], fr["img_r"], fr["t"], fr["p_w"]) for fr in frames][:n_frames]
    n_warm = min(N_WARM_VISUAL, n_frames // 3)
    tracker = Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
    tracker.streaming = True
    for img_l, img_r, t, _ in frames[:n_warm]:
        tracker.process(img_l, img_r, t)
    tracker.positions()
    log("bench[visual]: warmup done; measuring")
    t0 = time.time()
    for img_l, img_r, t, _ in frames[n_warm:]:
        tracker.process(img_l, img_r, t)
    tracker.finalize()
    tracker.positions()
    elapsed = time.time() - t0
    fps = (n_frames - n_warm) / elapsed
    gt = np.stack([p for _, _, _, p in frames])
    ate = synthetic.ate_rmse(tracker.positions(), gt)
    return {"fps": round(fps, 2), "ate_m": round(float(ate), 4), "tracker": tracker}


def result_line(flag: dict, vis: dict) -> dict:
    """bench.py's JSON line (bench.py:219-238)."""
    return {
        "metric": "stereo_inertial_tracking_fps_752x480",
        "value": flag["fps"],
        "unit": "fps",
        "vs_baseline": round(flag["fps"] / REALTIME_FPS, 3),
        "extra": {
            "p99_ms": flag["p99_ms"],
            "p50_ms": flag["p50_ms"],
            "worst_ms": flag["worst_ms"],
            "ate_m_synthetic": flag["ate_m"],
            "loops_closed": flag["loops_closed"],
            "imu_ready": flag["imu_ready"],
            "frames": flag["frames"],
            "n_keyframes": flag["n_keyframes"],
            "n_points": flag["n_points"],
            "n_lines": flag["n_lines"],
            "visual_fps": vis["fps"],
            "visual_ate_m": vis["ate_m"],
        },
    }


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--no-graphs", action="store_true", help="run the fused steps eagerly instead of as CUDA graphs")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    n_flag = int(os.environ.get("BENCH_FRAMES", "220"))
    n_vis = int(os.environ.get("BENCH_FRAMES_VISUAL", "40"))
    if dev.type == "cuda":
        from pli_slam_tpu_torch.ops.kernels import hamming

        log(f"bench: {torch.cuda.get_device_name(dev)}; nvidia-smi: {_nvidia_smi()}; torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        log(f"bench: gated_match built and loaded in {hamming.build():.2f} s")
    graphs = not args.no_graphs
    flag = run_flagship(n_flag, device=dev, cuda_graphs=graphs)
    vis = run_visual(n_vis, device=dev, cuda_graphs=graphs)
    if dev.type == "cuda":
        caps = [profile.capture_stats(r["tracker"]) for r in (flag, vis)]
        log(f"bench: fused steps {'as CUDA graphs' if graphs else 'eager'}; captures {sum(c for c, _ in caps):.1f} ms, "
            f"graph pools {sum(p for _, p in caps) / 2**20:.1f} MiB, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**20:.1f} MiB")
    result = result_line(flag, vis)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
