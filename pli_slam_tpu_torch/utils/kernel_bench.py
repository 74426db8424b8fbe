"""Time the gated-match kernel on the card, alone and as the whole call.

    python3 -m pli_slam_tpu_torch.utils.kernel_bench [--baseline OLD.cu] [--variants]

At the main path's two shapes (N=1200 x P=4096, a tracking call; N=1200 x
P=16384, a keyframe fuse) it checks the kernel against its plain version
(exact) and prints, per shape:
- `graph_ms`: device time per launch, 50 launches replayed from one CUDA
  graph, so the host's launch rate is out of the picture;
- `eager_ms`: CUDA events around a loop of 50 eager `gated_match_cuda` calls
  (the larger of device time and the host's time per call);
- `call_ms`: the same around the whole `gated_match` call;
- `host_us`: host clock per eager call, the queue never full.
`--baseline` names the source of an earlier version of the kernel with the
first version's C interface (`gated_match_launch` with a squared radius
on the device, separate partial and output arrays, a second merge kernel
and the acceptance flag in PyTorch); it is built and timed in turns with
the current one (old, new, new, old) in the same process, on the same
inputs. `--variants` rebuilds the current source with other tile
constants, with the chunks' merge as a second kernel and with the epilogue
compiled out, and times each.
Results go to stdout and to `chiprun_out/kernel_bench.json`. Needs a CUDA
device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pli_slam_tpu_torch.ops.kernels import hamming

SHAPES = {  # label: (N, P, radius, max_dist, ratio), as frontend/step.py calls the matcher
    "track": (1200, 4096, 15.0, 100.0, 0.9),
    "fuse": (1200, 16384, float(np.float32(0.05) * np.float32(435.2)), 64.0, 1.0),
}
VARIANTS = [  # compiler flags: the merge as a second kernel, no gate and fold at all (timing only: wrong results),
    # ring depth, warpgroups per block, fixed tiles per block
    (), ("-DGM_TWO_PASS",), ("-DGM_NO_EPILOGUE",), ("-DGM_STAGES=3",), ("-DGM_STAGES=1",), ("-DGM_WARPGROUPS=1",),
    ("-DGM_WARPGROUPS=1", "-DGM_STAGES=3"), ("-DGM_CHUNK_TILES=2",), ("-DGM_CHUNK_TILES=3",), ("-DGM_CHUNK_TILES=4",),
    ("-DGM_CHUNK_TILES=5",), ("-DGM_CHUNK_TILES=8",), ("-DGM_CHUNK_TILES=10",),
]
H100_INT8_OPS = 1979e12  # dense int8 tensor-core rate of an H100 SXM, operations per second
H100_BYTES = 3.35e12  # HBM3 bytes per second


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound_ms(n: int, p: int) -> tuple[float, str]:
    """The least time an H100 could take for one call: the larger of the
    product's 2*N*P*256 int8 operations at the tensor cores' peak and of every
    input read once and every output written once at the memory's peak."""
    ops = 2.0 * n * p * hamming.N_BITS
    nbytes = (n + p) * (hamming.N_BITS + 8 + 1) + 4 + n * (4 + 4 + 4 + 1)
    t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def match_case(rng, n, p, radius, n_dup=64, n_edge=16):
    """Frame/store inputs like the main path's: planted noisy copies of the
    frame descriptors near the frame uv, exact duplicate store rows (ties),
    store points exactly on the radius, invalid rows on both sides."""
    fdesc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    sdesc = rng.choice(np.array([-1, 1], np.int8), size=(p, 256))
    fuv = rng.uniform(0, 752, size=(n, 2)).astype(np.float32)
    suv = rng.uniform(0, 752, size=(p, 2)).astype(np.float32)
    k = min(n, p)  # features with a planted copy
    perm = rng.permutation(p)[:k]
    noisy = fdesc[:k].copy()
    for i in range(k):
        noisy[i, rng.choice(256, size=int(rng.integers(0, 40)), replace=False)] *= -1
    sdesc[perm] = noisy
    suv[perm] = fuv[:k] + rng.normal(size=(k, 2)).astype(np.float32) * (radius / 3)
    n_dup, n_edge = min(n_dup, k, p - k), min(n_edge, k)
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


def eager_ms(fn, iters=50):
    """CUDA events around `iters` eager calls, after a warm-up."""
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


def graph_ms(fn, launches=50, replays=20):
    """Device time per call of `fn`: `launches` calls captured into one CUDA
    graph, the graph replayed `replays` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(launches):
                fn()
    torch.cuda.synchronize()
    return eager_ms(graph.replay, iters=replays) / launches


def host_us(fn, iters=200):
    """Host clock per call, the device drained every 20 calls so that the launch queue never fills."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters // 20):
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (iters // 20 * 20) * 1e6


class FirstVersion:
    """An earlier kernel source with the first version's C interface, and that version's wrapper."""

    def __init__(self, src: Path):
        self.lib = hamming.compile_library(src)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib.gated_match_launch.argtypes = [vp] * 7 + [ci, ci] + [vp] * 7
        self.lib.gated_match_launch.restype = ci
        self.lib.gated_match_chunk_rows.restype = ci

    def kernel(self, fdesc, fuv, fvalid, sdesc, suv, svalid, r2):
        dev, n, p = fdesc.device, fdesc.shape[0], sdesc.shape[0]
        n_chunks = -(-p // self.lib.gated_match_chunk_rows())
        pbest = torch.empty((max(n_chunks, 1), n), dtype=torch.float32, device=dev)
        psecond = torch.empty_like(pbest)
        pidx = torch.empty((max(n_chunks, 1), n), dtype=torch.int32, device=dev)
        best = torch.empty(n, dtype=torch.float32, device=dev)
        second = torch.empty_like(best)
        idx = torch.empty(n, dtype=torch.int32, device=dev)
        err = self.lib.gated_match_launch(
            fdesc.data_ptr(), fuv.data_ptr(), fvalid.data_ptr(), sdesc.data_ptr(), suv.data_ptr(),
            svalid.data_ptr(), r2.data_ptr(), n, p, pbest.data_ptr(), psecond.data_ptr(), pidx.data_ptr(),
            best.data_ptr(), second.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline kernel launch failed: cudaError {err}")
        return idx, best, second

    def call(self, fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist, ratio):
        r = radius.reshape(1)
        idx, best, second = self.kernel(fdesc, fuv, fvalid, sdesc, suv, svalid, r * r)
        return idx, best, hamming.accept_reference(fvalid, idx, best, second, max_dist, ratio)


def check_exact(label, got, args, radius, max_dist, ratio):
    idx, best, second = hamming.gated_match_reference(*args, radius)
    want = (idx, best, second, hamming.accept_reference(args[2], idx, best, second, max_dist, ratio))
    for name, a, b in zip(("idx", "best", "second", "ok"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from the plain version in {(a != b).sum().item()} rows")


def time_current(label, args, r_dev, max_dist, ratio):
    check_exact(label, hamming.gated_match_cuda(*args, r_dev, max_dist, ratio), args, r_dev, max_dist, ratio)
    return {
        "graph_ms": graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio)),
        "eager_ms": eager_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio)),
        "call_ms": eager_ms(lambda: hamming.gated_match(*args, r_dev, max_dist, ratio)),
        "host_us": host_us(lambda: hamming.gated_match(*args, r_dev, max_dist, ratio)),
    }


def time_baseline(label, old, args, r_dev, max_dist, ratio):
    r2 = r_dev.reshape(1) * r_dev.reshape(1)
    idx, best, second = old.kernel(*args, r2)
    check_exact(label, (idx, best, second, old.call(*args, r_dev, max_dist, ratio)[2]), args, r_dev, max_dist, ratio)
    return {
        "graph_ms": graph_ms(lambda: old.kernel(*args, r2)),
        "eager_ms": eager_ms(lambda: old.kernel(*args, r2)),
        "call_ms": eager_ms(lambda: old.call(*args, r_dev, max_dist, ratio)),
        "host_us": host_us(lambda: old.call(*args, r_dev, max_dist, ratio)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="source of an earlier kernel with the first version's C interface")
    ap.add_argument("--variants", action="store_true", help="also time the current source under other tile constants")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/kernel_bench.json"))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device; the kernel runs only on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    result = {"card": smi, "device": torch.cuda.get_device_name(0), "shapes": {}, "variants": {}}
    hamming.build()
    old = FirstVersion(opt.baseline) if opt.baseline else None
    rng = np.random.default_rng(0)
    cases = {}
    for label, (n, p, radius, max_dist, ratio) in SHAPES.items():
        args = tuple(torch.as_tensor(a, device=dev) for a in match_case(rng, n, p, radius))
        cases[label] = (args, torch.tensor(radius, dtype=torch.float32, device=dev), max_dist, ratio)
        b_ms, b_by = bound_ms(n, p)
        entry = {"n": n, "p": p, "bound_ms": b_ms, "bound_by": b_by}
        runs = []
        if old:
            runs.append(("baseline", time_baseline(label, old, *cases[label])))
        runs.append(("current", time_current(label, *cases[label])))
        runs.append(("current", time_current(label, *cases[label])))
        if old:
            runs.append(("baseline", time_baseline(label, old, *cases[label])))
        for key in ("baseline", "current"):
            mine = [r for k, r in runs if k == key]
            if mine:
                entry[key] = {m: [r[m] for r in mine] for m in mine[0]}
        if old:
            entry["speedup_graph"] = float(np.mean(entry["baseline"]["graph_ms"]) / np.mean(entry["current"]["graph_ms"]))
            entry["speedup_call"] = float(np.mean(entry["baseline"]["call_ms"]) / np.mean(entry["current"]["call_ms"]))
        entry["share_of_bound"] = b_ms / float(np.mean(entry["current"]["graph_ms"]))
        result["shapes"][label] = entry
        print(f"{label}: {json.dumps(entry)} [{smi}]", flush=True)

    if opt.variants:
        shipped = hamming._lib
        for flags in VARIANTS:
            name = "shipped" if not flags else " ".join(f[5:].lower() for f in flags)
            hamming.use_library(hamming.bind(hamming.compile_library(flags=flags)))
            row = {}
            for label, (args, r_dev, max_dist, ratio) in cases.items():
                if "-DGM_NO_EPILOGUE" not in flags:
                    check_exact(f"{name} {label}", hamming.gated_match_cuda(*args, r_dev, max_dist, ratio), args,
                                r_dev, max_dist, ratio)
                row[label] = [graph_ms(lambda: hamming.gated_match_cuda(*args, r_dev, max_dist, ratio)) for _ in range(2)]
            result["variants"][name] = row
            print(f"variant {name}: {json.dumps(row)} [{smi}]", flush=True)
        hamming.use_library(shipped)

    opt.out.parent.mkdir(parents=True, exist_ok=True)
    opt.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
