"""The port's production-shape problems against `__graft_entry__`'s and
`scripts/bench_scaling.py`'s, and the multi-rank dry run on CPU ranks.

The builders are held at a reduced size (W=4, P=512, L=64; K=32 nodes).
Everything drawn from the seed, every index and mask is exactly equal. The
fields computed through a camera projection or a rotation product
(po_uvr; the circle's and the chain's t, e_R, e_t) agree to 1e-6, relative
and absolute (a few float32 ulps): torch divides a scalar by a tensor as a
reciprocal times the scalar, and XLA sums its small dot products in another
order.
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from pli_slam_tpu_torch.solve import pgo as tpgo
from pli_slam_tpu_torch.utils import convert, production

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
_CACHE = jax.config.jax_compilation_cache_dir
import bench_scaling  # noqa: E402  (the JAX package's scaling script; it points the compile cache elsewhere)

jax.config.update("jax_compilation_cache_dir", _CACHE)

torch.set_num_threads(1)
ROUNDED = {"po_uvr", "t", "e_R", "e_t"}
LIMIT = 50.0  # seconds a group of ranks may take: about three times the longest of these tests under the whole
#              suite with a cold cache (16 s)


def _ulps(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def _same(got, ref, where):
    ref = jax.tree_util.tree_map(np.asarray, ref)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), getattr(ref, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, f.name, a.dtype, b.dtype, a.shape, b.shape)
        if f.name in ROUNDED:
            _ulps(a, b)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{where}.{f.name}")


def test_production_ba_problem_matches_reference():
    cam_j, prob_j, t_j = ge.build_production_ba_problem(4, W=4, P=512, L=64)
    cam_t, prob_t, t_t = production.build_production_ba_problem(4, W=4, P=512, L=64)
    assert cam_t == convert.camera(jax.tree_util.tree_map(np.asarray, cam_j))
    _same(prob_t, prob_j, "ba")
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    with pytest.raises(ValueError):
        production.build_production_ba_problem(3, W=4, P=512, L=64)


def test_production_pgo_matches_reference():
    g_j, t_gt_j, drift_j = ge.build_production_pgo(K=32)
    g_t, t_gt_t, drift_t = production.build_production_pgo(K=32)
    _same(g_t, g_j, "pgo")
    _ulps(t_gt_t.numpy(), np.asarray(t_gt_j))
    np.testing.assert_array_equal(drift_t.numpy(), np.asarray(drift_j))


def test_scaling_builders_match_reference():
    cam_j, prob_j = bench_scaling.build_problem(W=4, P=512, L=64)
    cam_t, prob_t = production.build_scaling_problem(W=4, P=512, L=64)
    assert cam_t == convert.camera(jax.tree_util.tree_map(np.asarray, cam_j))
    _same(prob_t, prob_j, "scaling")
    _same(_scaling_pgo_graph(K=16), bench_scaling.build_pgo_graph(K=16), "scaling_pgo")


def _scaling_pgo_graph(K: int, seed: int = 0):
    """`bench_scaling.build_pgo_graph` in the port's terms: a straight K-node
    chain 0.3 m apart with its odometry edges from the truth and the
    translations 0.1 m off (node 0 fixed). The port's scaling driver measures
    on the production graph, so only this parity check builds it."""
    rng = np.random.default_rng(seed)
    t_true = torch.from_numpy(np.stack([[-0.3 * k, 0.0, 0.0] for k in range(K)]).astype(np.float32))
    R_true = torch.eye(3).repeat(K, 1, 1)
    valid = torch.ones(K, dtype=torch.bool)
    ci, cj, cR, ct, cs, cmask = tpgo.chain_edges(R_true, t_true, torch.ones(K), valid)
    noise = (rng.normal(size=(K, 3)) * 0.1).astype(np.float32)
    noise[0] = 0.0
    return tpgo.PoseGraph(
        R=R_true, t=t_true + torch.from_numpy(noise), s=torch.ones(K), node_mask=valid,
        fixed_mask=torch.arange(K) < 1, e_i=ci, e_j=cj, e_R=cR, e_t=ct, e_s=cs, e_weight=torch.ones(ci.shape[0]),
        e_mask=cmask)


def test_dryrun_multichip_two_cpu_ranks():
    """The dry run's three checks and the ranks' identical poses (it raises
    otherwise), at the reduced size on two gloo ranks."""
    out = production.dryrun_multichip(2, "gloo", torch.device("cpu"), W=4, P=512, L=64, K=32, timeout=LIMIT)
    assert out["cost1"] < 0.5 * out["cost0"] and out["gcost"] < 0.6 * out["c_init"]
    assert out["t_err1"] < 0.3 * out["t_err0"]
    assert out["n_obs"] == 4 * 512 + 4 * 64 and out["n_edges"] == 32


def test_one_rank_group_is_one_process():
    """`dryrun_sizes` runs every world size in one group of ranks. Its 1-rank
    group solves as one process does, to the bit, on the exact and on the
    noisy problem; on the noisy problem 2 ranks stay within chip_smoke.py's
    13a limits of one process, while a solve that loses a shard does not."""
    from pli_slam_tpu_torch.solve import ba
    from pli_slam_tpu_torch.utils.config import OptimizerConfig

    one, two = production.dryrun_sizes([1, 2], "gloo", torch.device("cpu"), W=4, P=512, L=64, K=32, timeout=LIMIT)
    assert (one["world_size"], two["world_size"]) == (1, 2)
    cam, prob, _ = production.build_production_ba_problem(2, W=4, P=512, L=64)
    cfg = OptimizerConfig(local_ba_window=4)
    noisy = production.with_point_noise(prob)
    for p, key in ((prob, "ba"), (noisy, "noisy")):
        res = ba.solve_ba(cam, p, cfg, iters=6)
        np.testing.assert_array_equal(res.R.numpy(), one[key + "_R"])
        np.testing.assert_array_equal(res.t.numpy(), one[key + "_t"])
        assert float(res.cost) == one["cost1" if key == "ba" else "noisy_cost"]
    np.testing.assert_allclose(two["noisy_R"], res.R.numpy(), rtol=0, atol=5e-6)
    np.testing.assert_allclose(two["noisy_t"], res.t.numpy(), rtol=0, atol=3e-5)
    np.testing.assert_allclose(two["noisy_cost"], float(res.cost), rtol=1e-5)
    lost = ba.solve_ba(cam, dataclasses.replace(noisy, po_mask=noisy.po_mask & (noisy.po_pt % 2 == 0),
                                                lo_mask=noisy.lo_mask & (noisy.lo_ln % 2 == 0)), cfg, iters=6)
    assert abs(float(lost.cost) - float(res.cost)) > 10 * 1e-5 * float(res.cost)
    assert np.abs(lost.t.numpy() - res.t.numpy()).max() > 10 * 3e-5


def test_bench_scaling_driver_on_cpu(tmp_path, monkeypatch):
    """The scaling driver with its rows made at a reduced size: one dry run
    per world size, its rows and nothing written but `--out`'s scaling.json."""
    import functools
    import json

    from pli_slam_tpu_torch.scripts import bench_scaling as tbench

    monkeypatch.setattr(tbench, "scaling_rows", functools.partial(tbench.scaling_rows, W=4, P=512, L=64, K=32))
    rows = tbench.main(["--cpu", "--world-sizes", "1,2", "--timeout", f"{LIMIT:.0f}", "--out", str(tmp_path)])
    assert [r["world"] for r in rows] == [1, 2]
    assert [r["obs_rows_per_shard"] for r in rows] == [4 * 512 + 4 * 64, (4 * 512 + 4 * 64) // 2]
    assert rows[1]["ba_allreduce_bytes"] == 4 * (4 * 4 * 36 + 4 * 6 + 1)  # S, rhs and the cost
    assert rows[1]["pgo_allreduce_bytes"] == 4 * (32 * 32 * 49 + 32 * 7)  # H and g
    assert json.loads((tmp_path / "scaling.json").read_text())["rows"] == rows
    assert [p.name for p in tmp_path.iterdir()] == ["scaling.json"]
