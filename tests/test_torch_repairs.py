"""The port's repairs of its own faults (ROADMAP queue 3 A), on the CPU.

A1, reproducible runs on the card: the card sums the Hough votes and the
PGO's H / g with `ops.indexing.fixed_point_index_add` (CUDA's float
`index_add` adds in thread-arrival order). That sum is held here exactly
to the float64 sum rounded to float32, for any order of its inputs, with
NaN for a non-finite row; and the Hough accumulator and PGO computed with
it (the card's path, forced on the CPU) against the reference within the
tolerances of test_torch_ops.py / test_torch_loop.py. `NondetSites`, the
diagnostic that found the Hough votes, must flag exactly the clashing
scatters. A2 (the renderer's bits) is held by test_torch_datasets.py.
A3, the first loop closure: `LoopCloser.warm_up` runs every closure
solver on the tracker's stores without touching them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _drifted_circle, _graph_arrays
from test_torch_ops import stereo_pair  # noqa: F401  (fixture)

from pli_slam_tpu.ops import lines as jlines
from pli_slam_tpu.solve import pgo as jpgo
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops import indexing
from pli_slam_tpu_torch.ops import lines as tlines
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.solve import pgo as tpgo
from pli_slam_tpu_torch.utils import synthetic
from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.utils.profile import NondetSites

torch.set_num_threads(1)


def _float64_sum(dst, idx, src):
    return (dst.double().reshape(dst.shape[0], -1).index_add(0, idx, src.double().reshape(len(idx), -1))
            .to(dst.dtype).reshape(dst.shape))


@pytest.mark.parametrize("scale", [1.0, 1e-6, 1e6])
def test_fixed_point_sum_is_exact_and_order_free(scale):
    g = torch.Generator().manual_seed(3)
    n, m = 5000, 37
    # columns of very different magnitudes and signs, and a heavy repeat on destination 0
    src = (torch.randn(n, 3, 4, generator=g) * torch.tensor([1.0, 1e3, 1e-4, 7.0]) * scale).to(torch.float32)
    idx = torch.randint(0, m, (n,), generator=g)
    idx[::3] = 0
    dst = torch.randn(m, 3, 4, generator=g)
    want = _float64_sum(dst, idx, src)
    got = indexing.fixed_point_index_add(dst, idx, src)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-12 * scale)
    assert (got == want).float().mean() > 0.99  # correctly rounded but for ties at the last bit
    perm = torch.randperm(n, generator=g)
    assert torch.equal(indexing.fixed_point_index_add(dst, idx[perm], src[perm]), got)
    src[7, 1, 2] = float("inf")
    bad = indexing.fixed_point_index_add(dst, idx, src)
    assert torch.isnan(bad[idx[7], 1, 2]) and int(torch.isnan(bad).sum()) == 1
    assert torch.equal(indexing.deterministic_index_add(dst, idx, src[:, 0, 0].reshape(-1, 1).expand(n, 12)
                                                        .reshape(n, 3, 4)),
                       dst.index_add(0, idx, src[:, 0, 0].reshape(-1, 1).expand(n, 12).reshape(n, 3, 4)))


def test_hough_votes_in_fixed_point_match_the_reference(stereo_pair, monkeypatch):  # noqa: F811
    """The card's Hough accumulator (fixed point) against the reference's
    update-order float32 sum: test_torch_ops.py's tolerance."""
    (cfg, tcfg), img, _ = stereo_pair
    monkeypatch.setattr(tlines, "deterministic_index_add", indexing.fixed_point_index_add)
    h, w = img.shape
    ja, _, _ = jlines._hough_vote(*jlines._edge_map(img, cfg.lines.grad_threshold), cfg.lines, h, w)
    ta, _, _ = tlines._hough_vote(*tlines._edge_map(torch.as_tensor(img), cfg.lines.grad_threshold), tcfg.lines, h, w)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("mode", ["se3", "sim3", "4dof"])
def test_pgo_in_fixed_point_matches_the_reference(mode, monkeypatch):
    """The card's PGO (H and g summed in fixed point) against the reference:
    test_torch_loop.py's tolerances."""
    monkeypatch.setattr(tpgo, "deterministic_index_add", indexing.fixed_point_index_add)
    g = _graph_arrays(*_drifted_circle())
    out_t = tpgo.optimize(tpgo.PoseGraph(**{k: torch.as_tensor(v) for k, v in g.items()}), iters=20, mode=mode)
    out_j = jpgo.optimize(jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()}), iters=20, mode=mode)
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=1e-4)
    np.testing.assert_allclose(out_t.s.numpy(), np.asarray(out_j.s), atol=1e-5)


def test_nondet_sites_flags_only_clashing_scatters():
    i = torch.tensor([1, 1, 2])
    with NondetSites() as mode:
        torch.zeros(4).index_add(0, i, torch.tensor([1.0, 2.0, 3.0]))  # float, repeated: flagged
        torch.zeros(4, dtype=torch.int32).index_add(0, i, torch.tensor([1, 2, 3], dtype=torch.int32))  # exact
        torch.zeros(4).index_add(0, torch.tensor([0, 1, 2]), torch.ones(3))  # no repeat
        x = torch.zeros(4)
        x[i] = torch.tensor([5.0, 6.0, 7.0])  # repeated with different values: flagged
        y = torch.zeros(4)
        y[i] = torch.tensor([5.0, 5.0, 7.0])  # repeated with equal values: the same bits whoever wins
        torch.zeros(4).scatter_reduce(0, i, torch.tensor([1.0, 2.0, 3.0]), reduce="amax")  # order-free
        torch.zeros(4).scatter_add(0, i, torch.tensor([1.0, 2.0, 3.0]))  # flagged
    ops = sorted(op for op, _ in mode.sites)
    assert ops == ["index_add", "index_put_ with clashing duplicates", "scatter_add"], ops


@pytest.mark.parametrize("sensor", ["stereo", "stereo_imu", "mono"])
def test_loop_warm_up_runs_every_closure_solver(sensor):
    """On the CPU construction does not warm up (nothing is loaded lazily
    there); `warm_up` itself runs the closure's solvers (both PGO modes a
    stereo-inertial tracker can reach, the Sim(3) one for mono) on the
    tracker's stores and leaves them as they were."""
    cam = Camera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    cfg = SlamConfig.tiny_test().replace(sensor=sensor)
    assert cfg.loop.enabled
    tr = Tracker(cam, cfg, "cpu")
    assert tr.loop_warmup_ms is None
    traj = synthetic.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    if sensor == "stereo":  # a map with keyframes, not only empty stores
        for fr in synthetic.make_sequence(cam, 4, "cpu", fps=cfg.fps, traj=traj, room_half=2.55):
            tr.process(fr["img_l"], fr["img_r"], fr["t"])
    before = {name: {k: v.clone() for k, v in vars(getattr(tr, name)).items()} for name in ("kstore", "pstore",
                                                                                            "lstore")}
    calls = []
    real = tpgo.optimize
    try:
        tpgo.optimize = lambda graph, **kw: calls.append(kw["mode"]) or real(graph, **kw)
        ms = tr.loop_closer.warm_up(tr)
    finally:
        tpgo.optimize = real
    assert ms > 0.0
    assert calls == {"stereo": ["se3"], "stereo_imu": ["se3", "4dof"], "mono": ["sim3"]}[sensor]
    for name, fields in before.items():
        for k, v in fields.items():
            assert torch.equal(getattr(getattr(tr, name), k), v), (name, k)
    assert dataclasses.asdict(tr.cfg) == dataclasses.asdict(cfg)
