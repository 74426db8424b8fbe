"""Distributed bundle adjustment on `torch.distributed` (gloo ranks on the
CPU) against the JAX package's `shard_map` solver on the 8-device virtual
CPU mesh, at the same shard count.

Same numpy problem (`test_ba.build_problem`, W=4, P=64, L=16) into both
packages. Tolerances are `test_dist_ba.py`'s: rotations 2e-4, translations
and points 2e-3; partitions exact. Replicated poses must be the same bits on
every rank. Every group runs under `launch.run_ranks`' timeout.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.parallel import dist_ba as jdist
from pli_slam_tpu.utils.config import OptimizerConfig, SlamConfig
from pli_slam_tpu_torch.parallel import dist_ba, launch
from pli_slam_tpu_torch.solve import ba as tba
from pli_slam_tpu_torch.utils import convert
from test_ba import build_problem

torch.set_num_threads(1)
TIMEOUT = 80.0  # about three times the longest of these tests under the whole suite with a cold cache (26 s)
CFG = OptimizerConfig()
TCFG = convert.config_from_reference(dataclasses.asdict(SlamConfig(opt=CFG))).opt
JC = JCamera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=47.9)
TC = convert.camera(jax.tree_util.tree_map(np.asarray, JC))


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _problem(seed=42, **kw):
    prob, R_true, t_true, *_ = build_problem(np.random.default_rng(seed), JC, W=4, P=64, L=16, **kw)
    return prob, convert.ba_problem(_np(prob)), np.asarray(R_true), np.asarray(t_true)


def _run(n, tprob, solver="schur", iters=5):
    stacked = convert.to_host(dist_ba.partition_observations(tprob, n))
    outs = launch.run_ranks(dist_ba.solve_shard, n, "gloo", torch.device("cpu"), TIMEOUT,
                            args=(TC, stacked, TCFG, iters, solver))
    for o in outs[1:]:  # the replicated state is the same bits on every rank
        for k in ("R", "t", "cost"):
            np.testing.assert_array_equal(getattr(o, k), getattr(outs[0], k), err_msg=k)
    return outs


@pytest.mark.parametrize("compact", [True, False])
def test_partition_matches_reference(compact):
    jprob, tprob, _, _ = _problem()
    ref = _np(jdist.partition_observations(jprob, 8, compact=compact))
    got = dist_ba.partition_observations(tprob, 8, compact=compact)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name).numpy(), getattr(ref, f.name)
        assert a.shape == b.shape, (f.name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    mask = got.po_mask.numpy()
    if not compact:  # global rows: each observation owned by exactly one shard
        np.testing.assert_array_equal(mask.sum(0), tprob.po_mask.numpy().astype(int))
        return
    pairs = np.concatenate([np.stack([got.po_pose[s].numpy()[mask[s]], got.po_pt[s].numpy()[mask[s]] * 8 + s], 1)
                            for s in range(8)])
    live = tprob.po_mask.numpy()
    want = np.stack([tprob.po_pose.numpy()[live], tprob.po_pt.numpy()[live]], 1)
    assert len(pairs) == len(want)
    assert {tuple(r) for r in pairs.tolist()} == {tuple(r) for r in want.tolist()}


def test_shard_and_gather_round_trip():
    _, tprob, _, _ = _problem()
    stacked = dist_ba.partition_observations(tprob, 4)
    torch.testing.assert_close(dist_ba.gather_landmarks(stacked.pts), tprob.pts, rtol=0, atol=0)
    one = dist_ba.shard_of(stacked, 2)
    assert torch.equal(one.pts, tprob.pts[2::4]) and torch.equal(one.R, tprob.R)


@pytest.mark.parametrize("n", [2, 4])
def test_solve_ba_distributed_matches_reference(n):
    jprob, tprob, _, _ = _problem()
    ref = jdist.solve_ba_distributed(JC, jdist.partition_observations(jprob, n), CFG, jdist.make_mesh(n), iters=5)
    outs = _run(n, tprob)
    np.testing.assert_allclose(outs[0].R, np.asarray(ref.R), atol=2e-4)
    np.testing.assert_allclose(outs[0].t, np.asarray(ref.t), atol=2e-3)
    pts = dist_ba.gather_landmarks(torch.from_numpy(np.stack([o.pts for o in outs]))).numpy()
    np.testing.assert_allclose(pts, np.asarray(ref.pts).transpose(1, 0, 2).reshape(-1, 3), atol=2e-3)
    np.testing.assert_allclose(outs[0].cost, np.asarray(ref.cost), rtol=1e-2)


@pytest.mark.parametrize("n", [2, 4])
def test_solve_gba_distributed_matches_reference(n):
    jprob, tprob, _, _ = _problem()
    ref = jdist.solve_gba_distributed(JC, jdist.partition_observations(jprob, n), CFG, jdist.make_mesh(n), iters=6)
    outs = _run(n, tprob, solver="gba", iters=6)
    np.testing.assert_allclose(outs[0].R, np.asarray(ref.R), atol=2e-4)
    np.testing.assert_allclose(outs[0].t, np.asarray(ref.t), atol=2e-3)
    pts = dist_ba.gather_landmarks(torch.from_numpy(np.stack([o.pts for o in outs]))).numpy()
    np.testing.assert_allclose(pts, np.asarray(ref.pts).transpose(1, 0, 2).reshape(-1, 3), atol=2e-3)
    np.testing.assert_allclose(outs[0].cost, np.asarray(ref.cost), rtol=1e-2)


def test_distributed_converges():
    """`test_dist_ba.test_distributed_converges`'s thresholds, on 4 ranks."""
    _, tprob, R_true, t_true = _problem(perturb=0.03)
    out = _run(4, tprob, iters=8)[0]
    for w in range(1, 4):
        dR = out.R[w] @ R_true[w].T
        assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) < 3e-3, w
        assert np.linalg.norm(out.t[w] - t_true[w]) < 1.5e-2, w


def _reduced_system_rank(rank, group, device, cam, stacked, cfg, damping):
    prob = convert.ba_problem(dist_ba.shard_of(stacked, rank), device)
    idx_p, idx_l = tba.prepare_indices(prob)
    lam = torch.tensor(damping, device=device)
    S = tba.reduced_camera_system(cam, prob, idx_p, idx_l, prob.R, prob.t, prob.pts, prob.lns, cfg, lam, group)[0]
    return S.numpy()


def test_pose_blocks_damped_once_per_rank():
    """ROADMAP queue 3 B12, as in the reference (ba.py:442 then :450): each
    rank adds the LM damping to its share of S before the all-reduce, so the
    reduced pose blocks carry n * damping where one process has it once. The
    landmark blocks are damped once, on the rank that owns the landmark, so
    the Schur terms are unchanged: S_n - S_1 = (n - 1) * damping * I on the
    diagonal blocks and 0 elsewhere."""
    n, lam = 4, 1000.0
    _, tprob, _, _ = _problem()
    idx_p, idx_l = tba.prepare_indices(tprob)
    S1 = tba.reduced_camera_system(TC, tprob, idx_p, idx_l, tprob.R, tprob.t, tprob.pts, tprob.lns, TCFG,
                                   torch.tensor(lam))[0].numpy()
    stacked = convert.to_host(dist_ba.partition_observations(tprob, n))
    Sn = launch.run_ranks(_reduced_system_rank, n, "gloo", torch.device("cpu"), TIMEOUT,
                          args=(TC, stacked, TCFG, lam))
    for S in Sn[1:]:
        np.testing.assert_array_equal(S, Sn[0])
    W = S1.shape[0]
    want = np.zeros_like(S1)
    want[np.arange(W), np.arange(W)] = (n - 1) * lam * np.eye(6, dtype=np.float32)
    # the shards' float32 sums (entries up to ~2e7) run in another order: 1e-6 of the largest entry
    np.testing.assert_allclose(Sn[0] - S1, want, atol=1e-6 * np.abs(S1).max())
