#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device  -- a CUDA device must exist; prints nvidia-smi's name and power limit;
  2. build   -- compiles every kernel of the main path from `pli_slam_tpu_torch/csrc/`;
  3. kernels -- each kernel against its plain PyTorch version on the card at
               the main path's shapes (planted matches, duplicate rows, radius
               boundary, ragged store) and at shapes that stress its tiling
               (a store below one tile, one row past a chunk, 37 frame rows,
               a store gated out entirely, arbitrary int8 and zero rows, an
               exact duplicate in another tile and chunk), idx, best, second
               and ok exactly equal at both of the main path's acceptance
               settings; the kernel's device time per launch (50 launches in
               one CUDA graph), the whole call and the plain version timed
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


def _special_cases(rng):
    """Inputs that stress the kernel's tiling rather than the main path's
    shapes: (label, arrays, radius, what must hold besides equality)."""
    import numpy as np

    from pli_slam_tpu_torch.utils.kernel_bench import match_case

    out = [
        ("small_store", match_case(rng, 1200, 100, 15.0, n_dup=0), 15.0, None),  # a store smaller than one tile
        # one row past a chunk boundary: the kernel cuts 4096 rows into 16 chunks of 256, 256 rows into 2 of 128
        ("past_chunk", match_case(rng, 1200, 4097, 15.0), 15.0, None),
        ("past_small_chunk", match_case(rng, 130, 257, 15.0, n_dup=0), 15.0, None),
        ("small_n", match_case(rng, 37, 4096, 15.0, n_dup=16), 15.0, None),  # fewer frame rows than one tile
    ]
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 15.0)
    out.append(("all_gated", (fdesc, fuv, fvalid, sdesc, suv + np.float32(5000.0), svalid), 15.0, "none"))
    # arbitrary int8 values and rows of zeros on both sides: distances negative and half-integer
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 45.0)
    fdesc = rng.integers(-128, 128, size=fdesc.shape).astype(np.int8)
    sdesc = rng.integers(-128, 128, size=sdesc.shape).astype(np.int8)
    fdesc[::7], sdesc[::5] = 0, 0
    out.append(("any_int8", (fdesc, fuv, fvalid, sdesc, suv, svalid), 45.0, None))
    # every feature's exact copy at store row i and again 8 tiles of 128 rows on: another tile and another chunk
    fdesc, fuv, fvalid, sdesc, suv, svalid = match_case(rng, 1200, 4096, 15.0, n_dup=0)
    far = 8 * 128 * -(-1200 // (8 * 128))
    sdesc[:1200], sdesc[far:far + 1200] = fdesc, fdesc
    suv[:1200], suv[far:far + 1200] = fuv, fuv
    svalid[:1200], svalid[far:far + 1200] = True, True
    out.append(("far_duplicate", (fdesc, fuv, fvalid, sdesc, suv, svalid), 15.0, "lowest"))
    return out


def phase_kernels(dev):
    import numpy as np
    import torch

    from pli_slam_tpu_torch.ops.kernels import hamming
    from pli_slam_tpu_torch.utils.kernel_bench import eager_ms, graph_ms, match_case

    main_cases = [  # (label, N, P, radius): the main path's calls
        ("track_r15", 1200, 4096, 15.0),
        ("track_wide_r45", 1200, 4096, 45.0),
        ("track_r6", 1200, 4096, 6.0),
        ("fuse", 1200, 16384, float(np.float32(0.05) * np.float32(435.2))),
        ("ragged_store", 1200, 4096 + 77, 15.0),
    ]
    rng = np.random.default_rng(0)
    cases = [(label, match_case(rng, n, p, radius), radius, None) for label, n, p, radius in main_cases]
    cases += _special_cases(rng)
    max_err = 0.0
    times = {}
    for label, arrays, radius, expect in cases:
        fdesc, fuv, fvalid, sdesc, suv, svalid = args = tuple(torch.as_tensor(a, device=dev) for a in arrays)
        n, p = fdesc.shape[0], sdesc.shape[0]
        r_dev = torch.tensor(radius, dtype=torch.float32, device=dev)
        p_idx, p_best, p_second = hamming.gated_match_reference(*args, r_dev)
        # the main path's two settings: tracking (100, 0.9) and the fuse (64, no ratio test)
        for max_dist, ratio in ((100.0, 0.9), (64.0, 1.0)):
            k_idx, k_best, k_second, k_ok = hamming.gated_match_cuda(*args, r_dev, max_dist, ratio)
            w_idx, w_best, w_ok = hamming.gated_match(*args, radius, max_dist, ratio)  # a Python-float radius
            torch.cuda.synchronize()
            if not (torch.equal(k_idx, p_idx) and torch.equal(w_idx, p_idx)):
                raise AssertionError(f"{label}: idx differs in {(k_idx != p_idx).sum().item()} rows")
            err = max((k_best - p_best).abs().max().item(), (k_second - p_second).abs().max().item(),
                      (w_best - p_best).abs().max().item())
            if err != 0.0:
                raise AssertionError(f"{label}: best/second differ by up to {err}")
            ok_ref = hamming.accept_reference(fvalid, p_idx, p_best, p_second, max_dist, ratio)
            if not (torch.equal(k_ok, ok_ref) and torch.equal(w_ok, ok_ref)):
                raise AssertionError(f"{label}: ok differs at max_dist {max_dist}, ratio {ratio}")
            max_err = max(max_err, err)
        n_tie = int((k_second == k_best).sum().item())
        n_match = int((k_idx >= 0).sum().item())
        if expect == "none" and (n_match or not bool(((k_best == 1e9) & (k_second == 1e9)).all())):
            raise AssertionError(f"{label}: {n_match} rows matched in a store gated out entirely")
        if expect == "lowest":
            rows = torch.arange(n, device=dev, dtype=torch.int32)
            if not (torch.equal(k_idx[fvalid], rows[fvalid]) and bool((k_second[fvalid] == 0).all())):
                raise AssertionError(f"{label}: the lower of two exact copies must win with second == best == 0")
        if label in ("track_r15", "fuse"):
            max_dist, ratio = (100.0, 0.9) if label == "track_r15" else (64.0, 1.0)
            t_plain_a = eager_ms(lambda: hamming.gated_match_reference(*args, r_dev))
            t_kern_a = graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio))
            t_call = eager_ms(lambda: hamming.gated_match(*args, r_dev, max_dist, ratio))
            t_kern_b = graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio))
            t_plain_b = eager_ms(lambda: hamming.gated_match_reference(*args, r_dev))
            times[label] = (0.5 * (t_kern_a + t_kern_b), 0.5 * (t_plain_a + t_plain_b), t_call)
            log(f"kernels: {label} N={n} P={p} kernel {times[label][0]:.4f} ms per launch (50 launches in a CUDA "
                f"graph), whole call {t_call:.4f} ms (eager), plain {times[label][1]:.4f} ms")
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
    return launches, N_FRAMES


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
    launches, n_frames = phase_main_path(dev, smi)

    from pli_slam_tpu_torch.utils.kernel_bench import bound_ms

    k_ms, p_ms, c_ms = times["track_r15"]
    kf_ms, pf_ms, cf_ms = times["fuse"]
    (b_ms, b_by), (bf_ms, _) = bound_ms(1200, 4096), bound_ms(1200, 16384)
    log(json.dumps({"kernels": [{
        "name": "gated_match", "route": "cuda", "source": KERNEL_SRC, "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "call_ms": c_ms, "shape": "N=1200 x P=4096",
        "ms_fuse": kf_ms, "plain_ms_fuse": pf_ms, "bound_ms_fuse": bf_ms, "call_ms_fuse": cf_ms,
        "shape_fuse": "N=1200 x P=16384", "launches_per_frame": launches / (n_frames - 1),
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
