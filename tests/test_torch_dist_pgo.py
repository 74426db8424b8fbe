"""Edge-sharded pose-graph optimization on `torch.distributed` (gloo ranks
on the CPU) against the JAX package's `shard_map` version on the virtual CPU
mesh, at the same shard count, on `test_pgo_4dof_gba`'s drifted loop.

Tolerances are `test_dist_pgo.py`'s: rotations 3e-4, translations 3e-3;
the partition exact. Replicated nodes must be the same bits on every rank.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.parallel import dist_pgo as jdist
from pli_slam_tpu_torch.parallel import dist_pgo, launch
from pli_slam_tpu_torch.utils import convert
from test_pgo_4dof_gba import _graph_with_loop, _make_drifted_loop, _pose_err

torch.set_num_threads(1)
TIMEOUT = 80.0  # about three times the longest of these tests under the whole suite with a cold cache (26 s)


def _graphs():
    R_est, t_est, R_gt, t_gt = _make_drifted_loop(K=12)
    g = _graph_with_loop(R_est, t_est, R_gt, t_gt)  # 12 edges
    return g, convert.pose_graph(jax.tree_util.tree_map(np.asarray, g)), R_gt, t_gt


def test_partition_edges_pads_and_shards():
    jg, tg, _, _ = _graphs()
    stacked = dist_pgo.partition_edges(tg, 8)  # pads 12 -> 16, 2 per shard
    assert stacked.e_i.shape == (8, 2)
    assert stacked.R.shape == tg.R.shape  # nodes replicated
    assert int(stacked.e_mask.sum()) == 12
    ref = jax.tree_util.tree_map(np.asarray, jdist.partition_edges(jg, 8))
    for f in dataclasses.fields(stacked):
        np.testing.assert_array_equal(getattr(stacked, f.name).numpy(), getattr(ref, f.name), err_msg=f.name)
    one = dist_pgo.shard_edges(stacked, 7)  # the last block: the four padded edges are in shards 6 and 7
    assert not bool(one.e_mask.any()) and torch.equal(one.e_R, torch.eye(3).expand(2, 3, 3))


def _optimize_rank(rank, group, device, stacked, iters, mode):
    out = dist_pgo.optimize_distributed(convert.pose_graph(dist_pgo.shard_edges(stacked, rank), device), group,
                                        iters, mode)
    return {"R": out.R.numpy(), "t": out.t.numpy(), "s": out.s.numpy()}


@pytest.mark.parametrize("mode,n", [("se3", 2), ("se3", 4), ("sim3", 4), ("4dof", 2), ("4dof", 4)])
def test_distributed_pgo_matches_reference(mode, n):
    jg, tg, R_gt, t_gt = _graphs()
    ref = jdist.optimize_distributed(jdist.partition_edges(jg, n), jdist.make_mesh(n), iters=10, mode=mode)
    stacked = convert.to_host(dist_pgo.partition_edges(tg, n))
    outs = launch.run_ranks(_optimize_rank, n, "gloo", torch.device("cpu"), TIMEOUT, args=(stacked, 10, mode))
    for o in outs[1:]:
        for k in ("R", "t", "s"):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)
    np.testing.assert_allclose(outs[0]["R"], np.asarray(ref.R), atol=3e-4)
    np.testing.assert_allclose(outs[0]["t"], np.asarray(ref.t), atol=3e-3)
    np.testing.assert_allclose(outs[0]["s"], np.asarray(ref.s), atol=3e-4)
    if mode == "se3":  # and it corrects the drift
        err0 = _pose_err(jg, R_gt, t_gt)
        err1 = _pose_err(dataclasses.replace(tg, R=outs[0]["R"], t=outs[0]["t"]), R_gt, t_gt)
        assert err1 < 0.2 * err0, (err0, err1)


def test_unknown_mode_raises():
    _, tg, _, _ = _graphs()
    with pytest.raises(ValueError):
        dist_pgo.optimize_distributed(tg, None, iters=1, mode="affine")
