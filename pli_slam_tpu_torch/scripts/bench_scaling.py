"""Strong scaling of the distributed solvers over world sizes 1/2/4.

  python3 -m pli_slam_tpu_torch.scripts.bench_scaling [--cpu] [--backend gloo|nccl]
      [--world-sizes 1,2,4] [--out DIR]

One problem at production shapes (W=32 poses, 16384 points, 1024 lines,
~124k observations; a 256-node pose graph with loop edges), run through
`utils.production.dryrun_multichip` (its convergence checks included) for
each world size (1/2/4 on the GPU, 1/2/4/8 with `--cpu`), size n on ranks
0..n-1 of one group of the largest size, the other ranks waiting.
Per world size it prints the landmarks, observation rows and edges per
shard; the slowest rank's time of a whole distributed Schur solve of 6
iterations (after a warm-up) divided by 6, and of a warm 12-iteration PGO
divided by 12, the device synchronised at both ends (the Schur figure
includes the solver's cost evaluations, its outlier prune and its index
preparation); and the bytes of one iteration's all-reduces (S, rhs and the
cost; H and g) with the time of the same all-reduces on the same shapes
issued on their own after a barrier, synchronised on each side, so without
the wait for the slowest rank that they carry inside a solve. With `--out`
it writes `scaling.json` there; it writes nothing else.

Under gloo every rank shares one device: the rows then measure the per-shard
work and gloo's host-staged all-reduce, not the scaling across cards.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from pli_slam_tpu_torch.scripts import common


def scaling_rows(sizes, backend: str, device, W: int = 32, P: int = 16384, L: int = 1024, K: int = 256,
                 timeout: float = 600.0) -> list[tuple[dict, dict]]:
    """(row, dry run's full output) for each world size in `sizes`, all from
    one group of max(sizes) ranks (`utils.production.dryrun_sizes`)."""
    from pli_slam_tpu_torch.utils import production

    out = []
    for o in production.dryrun_sizes(sizes, backend, device, W=W, P=P, L=L, K=K, timeout=timeout):
        n, ms = o["world_size"], o["ms_max"]
        row = {"world": n, "backend": backend, "device": str(device),
               **{k: o[k] for k in ("landmarks_per_shard", "obs_rows_per_shard", "edges_per_shard",
                                    "ba_allreduce_bytes", "pgo_allreduce_bytes")},
               "ba_ms_per_iter": ms["ba"] / production.ITERS["ba"],
               "pgo_ms_per_iter": ms["pgo"] / production.ITERS["pgo"],
               "ba_allreduce_ms": ms["ba_allreduce"], "pgo_allreduce_ms": ms["pgo_allreduce"],
               "cost": o["cost1"]}
        out.append((row, o))
    return out


def format_row(row: dict) -> str:
    return (f"world={row['world']}: {row['landmarks_per_shard']} landmarks / {row['obs_rows_per_shard']} observation "
            f"rows / {row['edges_per_shard']} edges per shard; Schur solve_ba(6 iterations) / 6 = "
            f"{row['ba_ms_per_iter']:.3f} ms, PGO optimize(12) / 12 = {row['pgo_ms_per_iter']:.3f} ms; one "
            f"iteration's all-reduces issued alone: BA S + rhs + cost {row['ba_allreduce_bytes']} B in "
            f"{row['ba_allreduce_ms']:.3f} ms, PGO H + g {row['pgo_allreduce_bytes']} B in "
            f"{row['pgo_allreduce_ms']:.3f} ms; final BA cost {row['cost']:.6f}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--world-sizes", default=None, help="comma-separated (default 1,2,4; 1,2,4,8 with --cpu)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the group of ranks")
    ap.add_argument("--out", default=None, help="directory for scaling.json")
    args = ap.parse_args(argv)
    dev = common.pick_device(args.cpu)
    sizes = [int(s) for s in (args.world_sizes or ("1,2,4,8" if args.cpu else "1,2,4")).split(",")]
    where = f"{args.backend} ranks on {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
    print(f"bench_scaling: W=32 P=16384 L=1024, PGO 256 nodes, {where}", flush=True)
    rows = []
    for row, _ in scaling_rows(sizes, args.backend, dev, timeout=args.timeout):
        rows.append(row)
        print(format_row(row), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "scaling.json"), "w") as f:
            json.dump({"rows": rows, "where": where}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
