"""One rank of a distributed bundle adjustment, started as its own process.

  python3 -m pli_slam_tpu_torch.scripts.run_multihost_ba --init-method file:///tmp/rdv \
      --world-size 2 --rank 0 [--backend gloo|nccl] [--cpu]

Start one process per rank with the same `--init-method` (a `file://` path
or `tcp://host:port`, every rank the same) and `--world-size`. Each builds
the same problem (W=4 poses, 512 points, 64 lines, every pose seeing every
landmark), keeps its landmark shard, runs 5 iterations of
`parallel.dist_ba.solve_ba_distributed` with the other ranks, and prints
`MULTIHOST rank=<r> world=<n> cost=<final cost>`: every rank must print the
same cost. Under gloo the ranks share the GPU (or the CPU with `--cpu`);
under nccl rank r takes card r.
"""

from __future__ import annotations

import argparse
import datetime

import torch
import torch.distributed as dist

from pli_slam_tpu_torch.scripts import common


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-method", required=True, help="rendezvous shared by every rank (file:// or tcp://)")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds a collective may wait for the others")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    from pli_slam_tpu_torch.parallel import dist_ba, launch
    from pli_slam_tpu_torch.utils import convert, production
    from pli_slam_tpu_torch.utils.config import OptimizerConfig

    dev = launch.rank_device(args.backend, common.pick_device(args.cpu), args.rank, args.world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(args.backend, init_method=args.init_method, rank=args.rank, world_size=args.world_size,
                            timeout=datetime.timedelta(seconds=args.timeout))
    try:
        W = 4
        cam, prob = production.build_scaling_problem(W=W, P=512, L=64)
        local = convert.ba_problem(dist_ba.shard_of(dist_ba.partition_observations(prob, args.world_size), args.rank),
                                   dev)
        out = dist_ba.solve_ba_distributed(cam, local, OptimizerConfig(local_ba_window=W), dist.group.WORLD, iters=5)
        cost = float(out.cost)
    finally:
        dist.destroy_process_group()
    print(f"MULTIHOST rank={args.rank} world={args.world_size} cost={cost:.6f}", flush=True)
    return cost


if __name__ == "__main__":
    main()
