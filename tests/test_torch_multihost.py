"""Ranks as separate processes: two `run_multihost_ba` processes joined over
a `file://` rendezvous (the port's counterpart of test_multihost_dist.py,
whose XLA compiles make it slow; these take seconds), and what
`parallel.launch.run_ranks` does when a rank fails, hangs or cannot be
placed."""

import os
import subprocess
import sys
import time

import pytest
import torch

from pli_slam_tpu_torch.ops.collective import psum
from pli_slam_tpu_torch.parallel import launch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds each wait may take: about three times the longest measured under the whole suite (4-6 s), and no
# less than 30 s for a wait that starts Python processes (each imports torch)
LIMIT = 30.0
# a child's own limit on its collectives, counted from its process group's start: below LIMIT, counted from its
# start, so that a hung collective ends the child, which then names it, before the wait for the child ends
RANK_LIMIT = 20.0


def test_two_process_distributed_ba_converges(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "pli_slam_tpu_torch.scripts.run_multihost_ba", "--init-method",
           f"file://{tmp_path / 'rdv'}", "--world-size", "2", "--cpu", "--timeout", f"{RANK_LIMIT:.0f}"]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True, cwd=REPO) for r in range(2)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=LIMIT)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                pytest.fail(f"rank {r} of the two run_multihost_ba processes did not exit within {LIMIT:.0f} s; "
                            f"its output:\n{p.communicate()[0][-3000:]}")
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    costs = []
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST")]
        assert line and line[0].startswith(f"MULTIHOST rank={r} world=2 cost="), out[-2000:]
        costs.append(float(line[0].split("cost=")[1]))
    assert costs[0] == costs[1], costs  # both ranks hold the same bits of the replicated cost
    assert costs[0] < 1.0, costs


def test_driver_needs_a_gpu_or_cpu_flag(tmp_path):
    """Without --cpu the driver runs on the GPU, and with none it exits with an error."""
    from pli_slam_tpu_torch.scripts import run_multihost_ba

    with pytest.raises(SystemExit, match="no CUDA device"):
        run_multihost_ba.main(["--init-method", f"file://{tmp_path / 'rdv'}", "--world-size", "1", "--rank", "0"])


def _sum_rank(rank, group, device, scale):
    return float(psum(torch.tensor(float(rank + 1) * scale, device=device), group))


def _failing_rank(rank, group, device):
    if rank == 1:
        raise ValueError("rank 1 gives up")
    torch.distributed.barrier(group)  # rank 0 would wait here for ever


def _sleeping_rank(rank, group, device):
    time.sleep(600)


def test_run_ranks_returns_in_rank_order():
    assert launch.run_ranks(_sum_rank, 3, "gloo", torch.device("cpu"), LIMIT, args=(2.0,)) == [12.0, 12.0, 12.0]


def test_a_failed_rank_fails_the_caller():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        launch.run_ranks(_failing_rank, 2, "gloo", torch.device("cpu"), LIMIT)
    assert time.monotonic() - t0 < 25.0  # the waiting rank is killed, not waited for


def test_a_hung_group_times_out():
    with pytest.raises(TimeoutError):
        launch.run_ranks(_sleeping_rank, 2, "gloo", torch.device("cpu"), 8.0)


def test_backends_refuse_what_they_cannot_do():
    with pytest.raises(ValueError, match="unknown backend"):
        launch.run_ranks(_sum_rank, 2, "mpi", torch.device("cpu"), 10.0, args=(1.0,))
    with pytest.raises(ValueError, match="nccl"):  # NCCL off CUDA
        launch.run_ranks(_sum_rank, 2, "nccl", torch.device("cpu"), 10.0, args=(1.0,))
    with pytest.raises(ValueError, match="its own card"):  # more NCCL ranks than cards: never gloo in its place
        launch.rank_device("nccl", torch.device("cuda", 0), 0, torch.cuda.device_count() + 1)
