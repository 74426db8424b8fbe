#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  -- a CUDA device must exist; prints nvidia-smi's name and power limit;
  2. build   -- compiles every kernel of the main path from `pli_slam_tpu_torch/csrc/`;
  3. kernels -- each kernel against its plain PyTorch version on the card at
               the main path's shapes (planted matches, duplicate rows, radius
               boundary, ragged store), exact equality required, both timed
               with CUDA events;
  4. main path -- first its stages on a 128x96 input (build_frame, keyframe
               insertion, one tracking step) on the card against the CPU,
               where every kernel runs its plain version; then
               the port's `Tracker.process` in streaming mode over the
               40-frame synthetic stereo sequence of bench.py's visual run,
               at SlamConfig.euroc_stereo() with loop closing off (752x480,
               1200 ORB x 8 levels, 256 lines, 16384/4096/512 stores), and a
               check that the main path launched every kernel.
Then one JSON line describing the kernels, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TPU_KERNEL = "pli_slam_tpu/ops/pallas/hamming.py:28"
KERNEL_SRC = "pli_slam_tpu_torch/csrc/gated_match.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 3: gated-match kernel vs its plain version
# ---------------------------------------------------------------------------


def _match_case(rng, n, p, radius, n_dup=64, n_edge=16):
    """Frame/store inputs like the main path's: planted noisy copies of the
    frame descriptors near the frame uv, exact duplicate store rows (ties),
    store points exactly on the radius, invalid rows on both sides."""
    import numpy as np

    fdesc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    sdesc = rng.choice(np.array([-1, 1], np.int8), size=(p, 256))
    fuv = rng.uniform(0, 752, size=(n, 2)).astype(np.float32)
    suv = rng.uniform(0, 752, size=(p, 2)).astype(np.float32)
    perm = rng.permutation(p)[:n]
    noisy = fdesc.copy()
    for i in range(n):
        noisy[i, rng.choice(256, size=int(rng.integers(0, 40)), replace=False)] *= -1
    sdesc[perm] = noisy
    suv[perm] = fuv + rng.normal(size=(n, 2)).astype(np.float32) * (radius / 3)
    src = perm[:n_dup]
    dst = rng.choice(np.setdiff1d(np.arange(p), perm), size=n_dup, replace=False)
    sdesc[dst] = sdesc[src]
    suv[dst] = suv[src]
    fuv[:n_edge] = np.round(fuv[:n_edge])
    edge_rows = perm[:n_edge]
    suv[edge_rows] = fuv[:n_edge] + np.float32(radius) * np.array([0.6, 0.8], np.float32)
    fvalid = rng.random(n) > 0.05
    svalid = rng.random(p) > 0.1
    return fdesc, fuv, fvalid, sdesc, suv, svalid


def _time_ms(fn, iters=50):
    import torch

    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernels(dev):
    import numpy as np
    import torch

    from pli_slam_tpu_torch.ops.kernels import hamming

    cases = [  # (label, N, P, radius, max_dist, ratio): the main path's calls
        ("track_r15", 1200, 4096, 15.0, 100.0, 0.9),
        ("track_wide_r45", 1200, 4096, 45.0, 100.0, 0.9),
        ("track_r6", 1200, 4096, 6.0, 100.0, 0.9),
        ("fuse", 1200, 16384, float(np.float32(0.05) * np.float32(435.2)), 64.0, 1.0),
        ("ragged_store", 1200, 4096 + 77, 15.0, 100.0, 0.9),
    ]
    rng = np.random.default_rng(0)
    max_err = 0.0
    times = {}
    for label, n, p, radius, max_dist, ratio in cases:
        arrays = _match_case(rng, n, p, radius)
        fdesc, fuv, fvalid, sdesc, suv, svalid = (torch.as_tensor(a, device=dev) for a in arrays)
        r_dev = torch.tensor(radius, dtype=torch.float32, device=dev)
        k_idx, k_best, k_second = hamming.gated_match_cuda(fdesc, fuv, fvalid, sdesc, suv, svalid, r_dev)
        p_idx, p_best, p_second = hamming.gated_match_reference(fdesc, fuv, fvalid, sdesc, suv, svalid, r_dev)
        torch.cuda.synchronize()
        if not torch.equal(k_idx, p_idx):
            raise AssertionError(f"{label}: idx differs in {(k_idx != p_idx).sum().item()} rows")
        err = max((k_best - p_best).abs().max().item(), (k_second - p_second).abs().max().item())
        if err != 0.0:
            raise AssertionError(f"{label}: best/second differ by up to {err}")
        k_ok = hamming.gated_match(fdesc, fuv, fvalid, sdesc, suv, svalid, r_dev, max_dist, ratio)[2]
        ok_ref = fvalid & (p_best <= max_dist) & (p_idx >= 0)
        if ratio < 1.0:
            ok_ref = ok_ref & (p_best < ratio * p_second)
        if not torch.equal(k_ok, ok_ref):
            raise AssertionError(f"{label}: ok differs")
        n_tie = int((k_second == k_best).sum().item())
        n_match = int((k_idx >= 0).sum().item())
        max_err = max(max_err, err)
        if label in ("track_r15", "fuse"):
            args = (fdesc, fuv, fvalid, sdesc, suv, svalid, r_dev)
            t_plain_a = _time_ms(lambda: hamming.gated_match_reference(*args))
            t_kern_a = _time_ms(lambda: hamming.gated_match_cuda(*args))
            t_kern_b = _time_ms(lambda: hamming.gated_match_cuda(*args))
            t_plain_b = _time_ms(lambda: hamming.gated_match_reference(*args))
            times[label] = (0.5 * (t_kern_a + t_kern_b), 0.5 * (t_plain_a + t_plain_b))
            log(f"kernels: {label} N={n} P={p} kernel {times[label][0]:.4f} ms, plain {times[label][1]:.4f} ms")
        log(f"kernels: {label} N={n} P={p} r={radius:.3f}: idx/best/second/ok exactly equal "
            f"({n_match} matched rows, {n_tie} rows with second == best)")
    return max_err, times


# ---------------------------------------------------------------------------
# Phase 4: the port's main path
# ---------------------------------------------------------------------------


def _to(x, dev):
    """A dataclass tree of tensors moved to `dev`."""
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _to(getattr(x, f.name), dev) for f in dataclasses.fields(x)})
    return x.to(dev)


def phase_small_reference(dev):
    """The main path's stages on a small input, on the card against the CPU
    (where every kernel runs its plain version), each from identical input:
    build_frame on a 128x96 stereo pair, keyframe insertion, and one
    tracking step. Whole runs are not compared: at this size the tracker's
    later frames are chaotic (a one-line difference can flip a pose
    between two solutions), while each stage is not. Tolerances: 99% of
    keypoints and 99.5% of their descriptor bits identical (float32 sums
    run in another order on the card), stores and poses within 1e-4."""
    import torch

    from pli_slam_tpu_torch import SlamConfig
    from pli_slam_tpu_torch.frontend import step
    from pli_slam_tpu_torch.frontend.frame import build_frame
    from pli_slam_tpu_torch.ops.camera import Camera
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import loop_off
    from pli_slam_tpu_torch.worldmap import stores

    cfg = loop_off(SlamConfig.tiny_test())
    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    seq = list(synthetic.make_sequence(cam, 2, "cpu", fps=cfg.fps, traj=traj, room_half=2.55))
    frames = [build_frame(cam, cfg, f["img_l"], f["img_r"]) for f in seq]
    f0c = frames[0]
    f0g = build_frame(cam, cfg, seq[0]["img_l"].to(dev), seq[0]["img_r"].to(dev))
    same = (f0g.feats.uv.cpu() == f0c.feats.uv).all(-1) & (f0g.feats.valid.cpu() == f0c.feats.valid)
    bits = (f0g.feats.desc.cpu() == f0c.feats.desc)[same & f0c.feats.valid].float().mean().item()
    if same.float().mean().item() < 0.99 or bits < 0.995:
        raise AssertionError(f"build_frame: {same.float().mean().item():.4f} keypoints, {bits:.4f} bits agree")

    def insert(device):
        f = _to(frames[0], device)
        n, nl = f.feats.uv.shape[0], f.lines.angle.shape[0]
        m = cfg.map
        return step.insert_keyframe(
            cam, cfg, f, torch.eye(3, device=device), torch.zeros(3, device=device), 0.0,
            torch.full((n,), -1, dtype=torch.int32, device=device), torch.zeros(n, dtype=torch.bool, device=device),
            torch.full((nl,), -1, dtype=torch.int32, device=device), torch.zeros(nl, dtype=torch.bool, device=device),
            0, stores.PointStore.empty(m.max_points, device=device), stores.LineStore.empty(m.max_lines, device=device),
            stores.KeyFrameStore.empty(m.max_keyframes, cfg.orb.n_features, cfg.lines.n_lines, device))

    (ps, ls, ks, n_new), out_g = insert("cpu"), insert(dev)
    if (int(n_new) != int(out_g[3]) or not torch.equal(out_g[0].valid.cpu(), ps.valid)
            or (out_g[0].x.cpu() - ps.x).abs().max().item() > 1e-4):
        raise AssertionError("insert_keyframe: card and CPU stores differ")

    local = step._local_map_ids(cfg, ks, ps, 0)
    eye, zero, wide = torch.eye(3), torch.zeros(3), torch.tensor(True)
    rc = step.track_step(cam, cfg, frames[1], eye, zero, ps, ls, wide, local)
    rg = step.track_step(cam, cfg, _to(frames[1], dev), eye.to(dev), zero.to(dev), _to(ps, dev), _to(ls, dev),
                         wide.to(dev), local.to(dev))
    err = max((rg[0].cpu() - rc[0]).abs().max().item(), (rg[1].cpu() - rc[1]).abs().max().item())
    if err > 1e-4 or int(rg[6]) != int(rc[6]) or not torch.equal(rg[2].cpu(), rc[2]):
        raise AssertionError(f"track_step: pose diff {err}, inliers {int(rg[6])} vs {int(rc[6])}")
    log(f"reference: 128x96 input, card vs CPU plain path: {same.float().mean().item():.4f} of keypoints and "
        f"{bits:.4f} of descriptor bits equal, keyframe stores equal, tracking pose diff {err:.2e}, "
        f"{int(rc[6])} inliers on both")


def phase_main_path(dev, smi):
    import numpy as np
    import torch

    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils import synthetic
    from pli_slam_tpu_torch.utils.profile import N_FRAMES, N_WARM, slice_camera, slice_config

    cfg = slice_config()
    cam = slice_camera()
    t0 = time.perf_counter()
    frames = list(synthetic.make_sequence(cam, N_FRAMES, dev, fps=cfg.fps))
    torch.cuda.synchronize()
    log(f"main path: rendered {N_FRAMES} frames {cam.width}x{cam.height} in {time.perf_counter() - t0:.2f} s")

    tracker = Tracker(cam, cfg, dev)
    tracker.streaming = True
    hamming.reset_launches()
    times = []
    t_start = None
    for i, fr in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        f0 = time.perf_counter()
        tracker.process(fr["img_l"], fr["img_r"], fr["t"])
        if i >= N_WARM:
            times.append(time.perf_counter() - f0)
    tracker.finalize()
    est = tracker.positions()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t_start
    launches = hamming.launches

    fps = (N_FRAMES - N_WARM) / elapsed
    ms = np.asarray(times) * 1e3
    gt = np.stack([fr["p_w"] for fr in frames])
    if est.shape != gt.shape or not np.all(np.isfinite(est)):
        raise AssertionError(f"trajectory shape {est.shape} / finite {np.all(np.isfinite(est))}")
    ate = synthetic.ate_rmse(est, gt)
    # streaming stats lag one frame: stats[1] is the first fused frame's
    # placeholder, and the last frame's stats are still pending
    from pli_slam_tpu_torch.frontend.step import ST_OK

    consumed = [tracker.stats[0]] + tracker.stats[2:]
    last_ok = float(tracker._pending_stats[1][ST_OK].item()) > 0
    ok_frames = sum(1 for s in consumed if s["state"] == TrackingState.OK) + int(last_ok)
    n_fused = N_FRAMES - 1
    n_kf = tracker.n_kf
    log(f"main path: fps {fps:.3f}, p50 {np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms, "
        f"ATE {ate:.4f} m, n_kf {n_kf}, ok frames {ok_frames}/{N_FRAMES}, gated_match launches {launches} "
        f"over {n_fused} fused frames [{smi}]")
    if ok_frames < 0.9 * N_FRAMES:
        raise AssertionError(f"only {ok_frames}/{N_FRAMES} frames tracked")
    if n_kf < 3:
        raise AssertionError(f"only {n_kf} keyframes")
    if not ate < 0.10:
        raise AssertionError(f"ATE {ate} m >= 0.10 m (divergence guard)")
    if launches < 2 * n_fused:
        raise AssertionError(f"gated_match launched {launches} times for {n_fused} fused frames")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "pli_slam_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (pli_slam_tpu_torch/ missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)

    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, count {torch.cuda.device_count()}")

    from pli_slam_tpu_torch.ops.kernels import hamming

    t_build = hamming.build()
    log(f"build: gated_match ({KERNEL_SRC}) built and loaded in {t_build:.2f} s")

    max_err, times = phase_kernels(dev)
    phase_small_reference(dev)
    launches = phase_main_path(dev, smi)

    k_ms, p_ms = times["track_r15"]
    kf_ms, pf_ms = times["fuse"]
    log(json.dumps({"kernels": [{
        "name": "gated_match", "route": "cuda", "source": KERNEL_SRC, "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms,
        "shape": "N=1200 x P=4096", "ms_fuse": kf_ms, "plain_ms_fuse": pf_ms, "shape_fuse": "N=1200 x P=16384",
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
