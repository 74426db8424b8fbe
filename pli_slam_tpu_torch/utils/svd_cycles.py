"""Time builds of the small-SVD kernel side by side on the card, and split
its slowest warp's cycles by the parts of a Jacobi step.

    python3 -m pli_slam_tpu_torch.utils.svd_cycles [--source OTHER.cu ...]

On the matrices of `chip_smoke.py` phase 3d (the mono PnP's DLT systems
[256,12,12] and rotation blocks [256,3,3] that `ransac_pnp_dlt` forms on the
card, general [256,12,12]) it prints, for pli_slam_tpu_torch/csrc/svd_small.cu
and for each `--source` (another version of it with the same C entry, e.g.
`git show REV:pli_slam_tpu_torch/csrc/svd_small.cu > build/old.cu`):
- what `-Xptxas -v` reports for `svd_small_kernel` (the most registers,
  stack frame and spills of its instances);
- the device time per launch, 50 launches replayed from one CUDA graph, in
  turns (each source, then each again in reverse order), and the sweeps;
- the null vector's largest error against float64 where the smallest
  singular value is simple.
Then it builds a copy of the repository's source with `clock64` reads
around the parts of a step (loads and partial sums, the butterfly, the
rotation, the rotated stores and the warp's sync) and after the sweeps and
the tail, and prints the slowest warp's cycles per step by part, its tail's
cycles, and the medians over the warps. The reads cost a few percent of the
time. Results go to stdout and to `build/svd_cycles/svd_cycles.json`.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from pli_slam_tpu_torch.ops.kernels import hamming, svd_small
from pli_slam_tpu_torch.utils.kernel_bench import graph_ms, nvidia_smi

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "svd_cycles"
PARTS = ("loads and partial sums", "butterfly", "rotation", "stores and sync")
# (anchor line of csrc/svd_small.cu, the line put after it)
PROBES = (
    ("  __syncwarp();\n  const Layout l = layout(N);\n", "  const long long t0 = clock64();\n  long long acc[4] = {0, 0, 0, 0};\n"),
    ("      double sums[3] = {0.0, 0.0, 0.0};\n", "      const long long c0 = clock64();\n"),
    ("        partials(l, sub, x, sums);\n      }\n", "      const long long c1 = clock64();\n"),
    ("        for (int i = 0; i < 3; ++i) sums[i] += __shfl_xor_sync(kAll, sums[i], off);\n      }\n",
     "      const long long c2 = clock64();\n"),
    ("      rotated |= rotation(sums, tol2, &cs, &sn) && live;\n", "      const long long c3 = clock64();\n"),
    ("      if (live) apply(w, l, p, q, sub, x, cs, sn);\n      __syncwarp();\n",
     "      acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2; acc[3] += clock64() - c3;\n"),
    ("    if (!__any_sync(kAll, rotated)) break;\n  }\n", "  const long long t1 = clock64();\n"),
    ("  if (sweeps != nullptr && lane == 0) sweeps[m] = sw;\n",
     "  __syncwarp();\n  if (lane == 0) {\n    for (int i = 0; i < 4; ++i) svd_cycles[8 * m + i] = acc[i];\n"
     "    svd_cycles[8 * m + 4] = t1 - t0;\n    svd_cycles[8 * m + 5] = clock64() - t1;\n    svd_cycles[8 * m + 6] = sw;\n  }\n"),
)
MAX_COUNT = 4096


def instrumented(src: str) -> str:
    for anchor, probe in PROBES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/svd_small.cu no longer has the probe's anchor {anchor!r}")
        src = src.replace(anchor, anchor + probe)
    return (src.replace("namespace {\n", f"__device__ long long svd_cycles[8 * {MAX_COUNT}];\nnamespace {{\n", 1)
            + '\nextern "C" int svd_cycles_read(void* out, int count) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, svd_cycles, 64 * count);\n}\n")


def build(text: str, name: str) -> tuple[ctypes.CDLL, dict]:
    """`text` built and bound as `svd_small.build` binds the repository's
    source, and the most registers, stack frame and spills ptxas reported
    for any of its kernels."""
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    lib = hamming.compile_library(path, hamming.PTXAS_FLAGS)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.svd_small_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp, vp]
    lib.svd_small_launch.restype = ci
    found = hamming.ptxas_usage(lib.nvcc_output, "svd_small_kernel").values()
    return lib, {key: max(f[key] for f in found) for key in ("registers", "stack_frame", "spill_stores", "spill_loads")}


def launch(lib, A, sweeps=None):
    """`svd_small.svd_cuda` through the build `lib`."""
    svd_small._lib = lib
    return svd_small.svd_cuda(A, sweeps)


def cycles(lib, A) -> dict:
    """The instrumented build's counters for A: the slowest warp (sweeps plus
    tail) by part, and the medians."""
    sweeps = torch.zeros(A.shape[0], dtype=torch.int32, device=A.device)
    launch(lib, A, sweeps)
    torch.cuda.synchronize()
    lib.svd_cycles_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = np.zeros((A.shape[0], 8), np.int64)
    if lib.svd_cycles_read(out.ctypes.data, A.shape[0]) != 0:
        raise RuntimeError("reading the cycle counters failed")
    n = A.shape[-1]
    steps = np.minimum(out[:, 6] + 1, 30) * (n - 1 + n % 2)  # the sweeps run, the last included (kSweeps 30)
    i = int(np.argmax(out[:, 4] + out[:, 5]))
    return {"slowest_sweeps": int(out[i, 6]), "slowest_steps": int(steps[i]),
            "slowest_cycles_a_step": float(out[i, 4] / steps[i]),
            "slowest_by_part": {p: float(out[i, k] / steps[i]) for k, p in enumerate(PARTS)},
            "slowest_tail_cycles": int(out[i, 5]), "median_cycles_a_step": float(np.median(out[:, 4] / steps)),
            "median_tail_cycles": float(np.median(out[:, 5]))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", action="append", default=[], help="another version of csrc/svd_small.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("svd_cycles: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"svd_cycles on {torch.cuda.get_device_name(0)} ({smi})", flush=True)
    names = ["current"] + [Path(p).stem for p in args.source]
    texts = [svd_small._SRC.read_text()] + [Path(p).read_text() for p in args.source]
    libs, ptxas = {}, {}
    for name, text in zip(names, texts):
        libs[name], ptxas[name] = build(text, name)
        print(f"{name}: ptxas {ptxas[name]}", flush=True)
    probe, _ = build(instrumented(texts[0]), "current_cycles")
    cases = chip_smoke.dlt_cases(dev, torch.Generator().manual_seed(13))
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": ptxas, "cases": {}}
    for label, A in cases:
        A = A.contiguous()
        _, s64, vt64 = torch.linalg.svd(A.double().cpu())
        simple = (s64[:, -2] - s64[:, -1]) > chip_smoke.SIMPLE_GAP * s64[:, 0].clamp(min=1e-30)
        row = {}
        for name in names + names[::-1]:
            ms = graph_ms(lambda: launch(libs[name], A))
            if name in row:
                row[name]["ms"] = 0.5 * (row[name]["ms"] + ms)
                continue
            sweeps = torch.zeros(A.shape[0], dtype=torch.int32, device=dev)
            vt = launch(libs[name], A, sweeps)[2]
            err = chip_smoke._sign_free(vt[:, -1].double().cpu(), vt64[:, -1])
            row[name] = {"ms": ms, "sweeps": int(sweeps.sum()), "max_sweeps": int(sweeps.max()),
                         "null_vector_err": float(err[simple].max()) if bool(simple.any()) else None}
        row["current"]["cycles"] = cycles(probe, A)
        result["cases"][label] = row
        for name in names:
            print(f"{label} {tuple(A.shape)} {name}: {row[name]}", flush=True)
    (OUT / "svd_cycles.json").write_text(json.dumps(result, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
