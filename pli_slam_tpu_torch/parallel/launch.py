"""Start a `torch.distributed` group of ranks and collect what each returns.

`run_ranks(fn, world_size, backend, device, timeout, args)` spawns one
process per rank (start method `spawn`: CUDA cannot be forked), joins them
into one process group through a `file://` rendezvous in a fresh temporary
directory (no TCP port to race for), calls `fn(rank, group, device, *args)`
in each and returns the ranks' results in rank order. `fn` must be a
module-level function (it is pickled by name) and its result picklable
(numpy arrays and numbers).

Nothing is passed over: a rank that raises or exits non-zero, or a group
that outlives `timeout` seconds, kills every rank and raises in the caller.

Backends: "gloo" puts every rank on `device` (the CPU, or one card that the
ranks share; gloo's `all_reduce` stages CUDA tensors through the host);
"nccl" puts rank r on card r and refuses more ranks than cards.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def rank_device(backend: str, device, rank: int, world_size: int) -> torch.device:
    """The device rank `rank` computes on: `device` under gloo, card `rank`
    under NCCL (which cannot put two ranks on one card). Raises ValueError for
    an unknown backend, NCCL off CUDA, or more NCCL ranks than cards."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if backend == "gloo":
        return device
    if device.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; use gloo for CPU ranks")
    n_cards = torch.cuda.device_count()
    if world_size > n_cards:
        raise ValueError(f"nccl puts each rank on its own card: {world_size} ranks, {n_cards} cards "
                         "(gloo lets ranks share a card)")
    return torch.device("cuda", rank)


def _worker(rank, world_size, backend, device, init_method, timeout, fn, args, out):
    try:
        torch.set_num_threads(1)
        dev = rank_device(backend, device, rank, world_size)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, dist.group.WORLD, dev, *args)
        finally:
            dist.destroy_process_group()
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    out.put((rank, True, result))


def run_ranks(fn, world_size: int, backend: str, device, timeout: float = 120.0, args: tuple = ()) -> list:
    """Run `fn(rank, group, device, *args)` on `world_size` spawned ranks of
    one `backend` group; return the results in rank order. Raises RuntimeError
    when a rank fails and TimeoutError when the group outlives `timeout`
    seconds; either way every rank is killed first."""
    if world_size < 1:
        raise ValueError(f"world_size must be positive, got {world_size}")
    rank_device(backend, device, world_size - 1, world_size)  # refuse before starting anything
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: dict[int, object] = {}
    with tempfile.TemporaryDirectory(prefix="pli_rdv_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rdv")
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(r, world_size, backend, str(device), init_method, timeout, fn, args, out))
                 for r in range(world_size)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(results) < world_size:
                try:
                    rank, ok, value = out.get(timeout=0.2)
                except queue.Empty:
                    failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if failed:
                        _raise_failed(out, failed)
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} {backend} ranks did not finish within {timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
            codes = [p.exitcode for p in procs]
            if any(c != 0 for c in codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=10.0)
            out.close()
    return [results[r] for r in range(world_size)]


def _raise_failed(out, failed):
    """A rank exited non-zero: raise with its traceback if it sent one."""
    try:
        while True:
            rank, ok, value = out.get(timeout=1.0)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
    except queue.Empty:
        pass
    raise RuntimeError(f"rank {failed[0][0]} exited with code {failed[0][1]} without a result")
