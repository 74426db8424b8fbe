"""Problems at production shapes for the distributed solvers, and the
multi-rank dry run that drives them (the port's copies of the reference's
`__graft_entry__.build_production_ba_problem`, `build_production_pgo`,
`dryrun_multichip` and `scripts/bench_scaling.build_problem`).

Every problem is made on the host from a numpy seed, so each device and
each rank solves the same bits; the callers move it where they solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import lie
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.solve import ba
from pli_slam_tpu_torch.solve import pgo as pgo_mod

T = torch.from_numpy


def _line_obs(cam, xs_c, xe_c):
    """Normalized image line through the projections of two camera-frame endpoints."""
    uv_s, uv_e = cam_ops.project(cam, xs_c), cam_ops.project(cam, xe_c)
    one = torch.ones((uv_s.shape[0], 1), dtype=uv_s.dtype)
    l_obs = torch.linalg.cross(torch.cat([uv_s, one], -1), torch.cat([uv_e, one], -1), dim=-1)
    return l_obs / torch.clamp(torch.linalg.norm(l_obs[:, :2], dim=-1, keepdim=True), min=1e-9)


def build_production_ba_problem(n_devices: int, W: int = 32, P: int = 16384, L: int = 1024, obs_per_pt: int = 6,
                                obs_per_ln: int = 6, seed: int = 0):
    """W poses marching along +x, P point and L line landmarks each seen by a
    run of ~`obs_per_pt` / `obs_per_ln` consecutive poses (at the defaults
    ~124k observations), stereo observations from the truth, the state
    perturbed away from it (poses 0.10 m, landmarks 0.15 m; pose 0 fixed).
    Observations are pose-major in equal per-pose blocks. Returns (cam, prob,
    true translations t [W,3])."""
    cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=47.9, width=752, height=480)
    rng = np.random.default_rng(seed)
    if P % n_devices or L % n_devices:
        raise ValueError(f"{P} points and {L} lines do not split into {n_devices} shards")
    t_np = np.stack([[0.25 * w, 0, 0] for w in range(W)]).astype(np.float32)
    kp = (np.arange(P) * (W - obs_per_pt + 1)) // P  # first observing pose
    pts_np = np.empty((P, 3), np.float32)
    pts_np[:, 0] = t_np[kp, 0] * -1.0 + rng.uniform(-3, 3, P)
    pts_np[:, 1] = rng.uniform(-3, 3, P)
    pts_np[:, 2] = rng.uniform(5.0, 12.0, P)
    kl = (np.arange(L) * (W - obs_per_ln + 1)) // L
    xs_np = np.empty((L, 3), np.float32)
    xs_np[:, 0] = t_np[kl, 0] * -1.0 + rng.uniform(-3, 3, L)
    xs_np[:, 1] = rng.uniform(-3, 3, L)
    xs_np[:, 2] = rng.uniform(5.0, 12.0, L)
    lns_np = np.concatenate([xs_np, xs_np + rng.normal(size=(L, 3)).astype(np.float32) * 0.5], axis=-1)

    def pose_blocks(k_first, per):
        """Pose w observes the landmarks with k_first <= w < k_first + per,
        padded to the largest per-pose count."""
        sels = [np.nonzero((k_first <= w) & (w < k_first + per))[0] for w in range(W)]
        cap = max(max(len(s) for s in sels), 1)
        ids = np.zeros((W, cap), np.int32)
        mask = np.zeros((W, cap), bool)
        for w, s in enumerate(sels):
            ids[w, :len(s)] = s
            mask[w, :len(s)] = True
        pose = np.repeat(np.arange(W, dtype=np.int32)[:, None], cap, axis=1)
        return T(pose.reshape(-1)), T(ids.reshape(-1)), T(mask.reshape(-1))

    po_pose, po_pt, po_keep = pose_blocks(kp, obs_per_pt)
    lo_pose, lo_ln, lo_keep = pose_blocks(kl, obs_per_ln)
    t, pts, lns = T(t_np), T(pts_np), T(lns_np)
    lp, ll = po_pose.long(), lo_pose.long()
    uvr = cam_ops.stereo_project(cam, pts[po_pt.long()] + t[lp])  # R = I
    l_obs = _line_obs(cam, lns[lo_ln.long(), :3] + t[ll], lns[lo_ln.long(), 3:] + t[ll])

    t_noise = (rng.normal(size=(W, 3)) * 0.10).astype(np.float32)
    t_noise[0] = 0.0
    pts_pert = pts + T((rng.normal(size=(P, 3)) * 0.15).astype(np.float32))
    lns_pert = lns + T((rng.normal(size=(L, 6)) * 0.15).astype(np.float32))
    n_po, n_lo = po_pose.shape[0], lo_pose.shape[0]
    neg = torch.full_like(po_pt, -1)
    prob = ba.BAProblem(
        R=torch.eye(3).repeat(W, 1, 1), t=t + T(t_noise), pose_mask=torch.ones(W, dtype=torch.bool),
        fixed_mask=torch.arange(W) < 1, pts=pts_pert, pt_mask=torch.ones(P, dtype=torch.bool),
        lns=lns_pert, ln_mask=torch.ones(L, dtype=torch.bool),
        po_pose=po_pose, po_pt=torch.where(po_keep, po_pt, neg), po_uvr=uvr,
        po_stereo=torch.ones(n_po, dtype=torch.bool), po_sigma2=torch.ones(n_po), po_mask=po_keep,
        lo_pose=lo_pose, lo_ln=torch.where(lo_keep, lo_ln, torch.full_like(lo_ln, -1)), lo_l=l_obs,
        lo_sigma2=torch.ones(n_lo), lo_mask=lo_keep,
    )
    return cam, prob, t


def _rel_edges(R, t, i, j):
    """Measured S_ji = S_j S_i^-1 from the true poses."""
    Rii, tii = lie.se3_inverse(R[i.long()], t[i.long()])
    return lie.se3_compose(R[j.long()], t[j.long()], Rii, tii)


def build_production_pgo(K: int = 256, seed: int = 1):
    """A K-node circle (unit radius, camera looking along the tangent) with
    a random-walk drift of 0.01 m per node on the translations, chain edges,
    the loop closure K-1 -> 0 and a cross-loop edge every 32 nodes, measured
    from the truth; node 0 fixed. Returns (graph, t_gt, drift)."""
    rng = np.random.default_rng(seed)
    angs = [2 * np.pi * k / K for k in range(K)]
    R_gt = T(np.stack([np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]]).T
                       for a in angs]).astype(np.float32))
    c = T(np.stack([[np.cos(a), np.sin(a), 0.0] for a in angs]).astype(np.float32))
    t_gt = -torch.einsum("kij,kj->ki", R_gt, c)
    drift_np = np.cumsum(rng.normal(size=(K, 3)) * 0.01, axis=0).astype(np.float32)
    drift_np[0] = 0.0
    drift = T(drift_np)
    i = torch.cat([torch.arange(K - 1, dtype=torch.int32),
                   torch.tensor([K - 1] + list(range(0, K - 32, 32)), dtype=torch.int32)])
    j = torch.cat([torch.arange(1, K, dtype=torch.int32),
                   torch.tensor([0] + [k + 32 for k in range(0, K - 32, 32)], dtype=torch.int32)])
    e_R, e_t = _rel_edges(R_gt, t_gt, i, j)
    n_e = i.shape[0]
    graph = pgo_mod.PoseGraph(
        R=R_gt, t=t_gt + drift, s=torch.ones(K), node_mask=torch.ones(K, dtype=torch.bool),
        fixed_mask=torch.arange(K) < 1, e_i=i, e_j=j, e_R=e_R, e_t=e_t, e_s=torch.ones(n_e),
        e_weight=torch.ones(n_e), e_mask=torch.ones(n_e, dtype=torch.bool))
    return graph, t_gt, drift


def build_scaling_problem(W: int = 16, P: int = 8192, L: int = 512, seed: int = 0):
    """The scaling benchmark's dense problem: every one of W poses sees all P
    points and L lines (W*(P+L) observations), poses 0.1 m and landmarks
    0.15 m off the truth. Returns (cam, prob)."""
    rng = np.random.default_rng(seed)
    cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2, bf=47.9)
    pts = T((rng.uniform(-4, 4, (P, 3)) + np.array([0, 0, 8.0])).astype(np.float32))
    xs = T((rng.uniform(-4, 4, (L, 3)) + np.array([0, 0, 8.0])).astype(np.float32))
    lns = torch.cat([xs, xs + T(rng.normal(size=(L, 3)).astype(np.float32))], -1)
    t = T(np.stack([[-0.1 * w, 0, 0] for w in range(W)]).astype(np.float32))
    uvr = torch.cat([cam_ops.stereo_project(cam, pts + t[w][None]) for w in range(W)])
    l_obs = torch.cat([_line_obs(cam, xs + t[w][None], lns[:, 3:] + t[w][None]) for w in range(W)])
    t_noise = (rng.normal(size=(W, 3)) * 0.1).astype(np.float32)
    t_noise[0] = 0.0
    ones_p, ones_l = torch.ones(W * P), torch.ones(W * L)
    prob = ba.BAProblem(
        R=torch.eye(3).repeat(W, 1, 1), t=t + T(t_noise), pose_mask=torch.ones(W, dtype=torch.bool),
        fixed_mask=torch.arange(W) < 1,
        pts=pts + T((rng.normal(size=(P, 3)) * 0.15).astype(np.float32)), pt_mask=torch.ones(P, dtype=torch.bool),
        lns=lns + T((rng.normal(size=(L, 6)) * 0.15).astype(np.float32)), ln_mask=torch.ones(L, dtype=torch.bool),
        po_pose=torch.arange(W, dtype=torch.int32).repeat_interleave(P),
        po_pt=torch.arange(P, dtype=torch.int32).repeat(W), po_uvr=uvr,
        po_stereo=ones_p.bool(), po_sigma2=ones_p, po_mask=ones_p.bool(),
        lo_pose=torch.arange(W, dtype=torch.int32).repeat_interleave(L),
        lo_ln=torch.arange(L, dtype=torch.int32).repeat(W), lo_l=l_obs,
        lo_sigma2=ones_l, lo_mask=ones_l.bool(),
    )
    return cam, prob


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_ms(device, fn, reps: int = 1):
    """(result of the last call, ms per call), the device synchronised at both ends."""
    import time

    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn()
    _sync(device)
    return res, (time.perf_counter() - t0) * 1e3 / reps


ITERS = {"ba": 6, "gba": 12, "pgo": 12}  # the reference's dry run
REPS = 5  # all-reduce repetitions timed
NOISE_PX = 0.2  # test_ba.build_problem's observation noise


def with_point_noise(prob, px: float = NOISE_PX, seed: int = 7):
    """`prob` with `px` pixels of seeded Gaussian noise on every point
    observation. The production problem's observations are exact, so any
    solver that converges lands on the truth, one that drops or mis-sums a
    shard too; with noise the optimum depends on every observation."""
    noise = np.random.default_rng(seed).normal(size=tuple(prob.po_uvr.shape)) * px
    return dataclasses.replace(prob, po_uvr=prob.po_uvr + T(noise.astype(np.float32)))


def _dryrun_shard(rank, group, device, cam, cfg, stacked_ba, stacked_noisy, stacked_pgo):
    """Rank `rank` of one dry run: its landmark shard through the Schur
    solver (0 iterations, which warms it, then `ITERS["ba"]`), the same on the
    noisy problem, and the alternating solver; its edge block through the se3
    PGO (one iteration, which warms it, then `ITERS["pgo"]`); then the
    all-reduces of one Schur and one PGO iteration on their own, `REPS`
    times. Returns costs, poses and synchronised times."""
    import torch.distributed as dist

    from pli_slam_tpu_torch.ops.collective import psum
    from pli_slam_tpu_torch.parallel import dist_ba, dist_pgo
    from pli_slam_tpu_torch.utils import convert

    prob = convert.ba_problem(dist_ba.shard_of(stacked_ba, rank), device)
    noisy = convert.ba_problem(dist_ba.shard_of(stacked_noisy, rank), device)
    graph = convert.pose_graph(dist_pgo.shard_edges(stacked_pgo, rank), device)
    out, ms = {}, {}
    out["c_init"] = float(ba.evaluate_cost(cam, prob, prob.R, prob.t, prob.pts, prob.lns, cfg, group)[0])
    out["cost0"] = float(dist_ba.solve_ba_distributed(cam, prob, cfg, group, iters=0).cost)
    res, ms["ba"] = _timed_ms(device, lambda: dist_ba.solve_ba_distributed(cam, prob, cfg, group, ITERS["ba"]))
    nres = dist_ba.solve_ba_distributed(cam, noisy, cfg, group, ITERS["ba"])
    gba, ms["gba"] = _timed_ms(device, lambda: dist_ba.solve_gba_distributed(cam, prob, cfg, group, ITERS["gba"]))
    dist_pgo.optimize_distributed(graph, group, 1, "se3")
    pg, ms["pgo"] = _timed_ms(device, lambda: dist_pgo.optimize_distributed(graph, group, ITERS["pgo"], "se3"))
    out.update(cost1=float(res.cost), gcost=float(gba.cost), noisy_cost=float(nres.cost))
    for name, x in (("ba", res), ("noisy", nres), ("gba", gba), ("pgo", pg)):
        out[name + "_R"], out[name + "_t"] = x.R.cpu().numpy(), x.t.cpu().numpy()
    W, K = prob.R.shape[0], graph.R.shape[0]
    msgs = {"ba": [torch.zeros((W, W, 6, 6), device=device), torch.zeros((W, 6), device=device),
                   torch.zeros((), device=device)],  # S, rhs, cost
            "pgo": [torch.zeros((K, K, 7, 7), device=device), torch.zeros((K, 7), device=device)]}  # H, g
    for name, m in msgs.items():
        for x in m:  # warm-up
            psum(x, group)
        dist.barrier(group)
        ms[name + "_allreduce"] = _timed_ms(device, lambda: [psum(x, group) for x in m], REPS)[1]
        out[name + "_allreduce_bytes"] = sum(x.numel() * x.element_size() for x in m)
    out["ms"] = ms
    return out


def _dryrun_rank(rank, group, device, cam, cfg, problems):
    """One rank of `dryrun_sizes`: one PGO iteration on its own (every rank
    at once, so that each loads the CUDA modules and cuSOLVER of the PGO
    before any is timed: ~10 s on an H100), then for each world size n of
    `problems`, in order, the ranks below n run `_dryrun_shard` in their own
    group and the others wait. Returns {n: that shard's result}."""
    import torch.distributed as dist

    from pli_slam_tpu_torch.parallel import dist_pgo
    from pli_slam_tpu_torch.utils import convert

    stacked_pgo = problems[max(problems)][2]
    pgo_mod.optimize(convert.pose_graph(dist_pgo.shard_edges(stacked_pgo, rank), device), iters=1, mode="se3")
    outs = {}
    for n, stacked in problems.items():
        sub = dist.new_group(list(range(n)))  # every rank of `group` takes part in making it
        if rank < n:
            outs[n] = _dryrun_shard(rank, sub, device, cam, cfg, *stacked)
        dist.barrier(group)
    return outs


def dryrun_sizes(sizes, backend: str, device, W: int = 32, P: int = 16384, L: int = 1024, K: int = 256,
                 timeout: float = 600.0) -> list[dict]:
    """`dryrun_multichip` for each world size in `sizes`, in order, in one
    group of max(sizes) ranks (`parallel.launch.run_ranks`): size n runs on
    ranks 0..n-1 in a group of their own while the others wait, so the ranks
    start once. Returns one result per size; raises as `dryrun_multichip`."""
    from pli_slam_tpu_torch.parallel import dist_ba, dist_pgo, launch
    from pli_slam_tpu_torch.utils import convert
    from pli_slam_tpu_torch.utils.config import OptimizerConfig

    cfg = OptimizerConfig(local_ba_window=W)
    cam, prob, _ = build_production_ba_problem(1, W=W, P=P, L=L)
    noisy = with_point_noise(prob)
    graph, t_gt, drift = build_production_pgo(K=K)
    problems = {}
    for n in sizes:
        stacked = dist_ba.partition_observations(prob, n)
        problems[n] = (convert.to_host(stacked), convert.to_host(dist_ba.partition_observations(noisy, n)),
                       convert.to_host(dist_pgo.partition_edges(graph, n)))
    by_rank = launch.run_ranks(_dryrun_rank, max(sizes), backend, device, timeout, args=(cam, cfg, problems))
    t_err0 = float(torch.linalg.norm(drift, dim=-1).mean())
    results = []
    for n in sizes:
        outs = [by_rank[r][n] for r in range(n)]
        for key in ("ba_R", "ba_t", "noisy_R", "noisy_t", "gba_R", "gba_t", "pgo_R", "pgo_t", "c_init", "cost0",
                    "cost1", "noisy_cost", "gcost"):
            if not all(np.array_equal(o[key], outs[0][key]) for o in outs[1:]):
                raise AssertionError(f"dryrun: {key} differs between the {n} ranks")
        o = outs[0]
        t_err1 = float(np.linalg.norm(o["pgo_t"] - t_gt.numpy(), axis=-1).mean())
        if not np.all(np.isfinite(o["ba_t"])):
            raise AssertionError("dryrun: distributed BA produced non-finite poses")
        if not o["cost0"] > 1.0:
            raise AssertionError(f"dryrun: the problem is trivial (cost0={o['cost0']})")
        if not o["cost1"] < 0.5 * o["cost0"]:
            raise AssertionError(f"dryrun: distributed BA failed to converge: {o['cost0']} -> {o['cost1']}")
        if not o["gcost"] < 0.6 * o["c_init"]:
            raise AssertionError(f"dryrun: distributed GBA did not reduce the cost: {o['c_init']} -> {o['gcost']}")
        if not t_err1 < 0.3 * t_err0:
            raise AssertionError(f"dryrun: distributed PGO failed: {t_err0} -> {t_err1}")
        pgo_rows = problems[n][2].e_i.shape[1]
        results.append(dict(
            o, world_size=n, backend=backend, n_obs=int(prob.po_pose.shape[0] + prob.lo_pose.shape[0]),
            n_edges=int(graph.e_i.shape[0]), t_err0=t_err0, t_err1=t_err1,
            obs_rows_per_shard=int(problems[n][0].po_pose.shape[1] + problems[n][0].lo_pose.shape[1]),
            landmarks_per_shard=(P + L) // n, edges_per_shard=int(pgo_rows),
            ms_max={k: max(x["ms"][k] for x in outs) for k in o["ms"]}))
    return results


def dryrun_multichip(world_size: int, backend: str, device, W: int = 32, P: int = 16384, L: int = 1024,
                     K: int = 256, timeout: float = 600.0) -> dict:
    """Distributed Schur BA, whole-map BA and pose-graph optimization over
    `world_size` ranks (`parallel.launch.run_ranks`) at production shapes
    (W=32 poses, 16384 points, 1024 lines, ~124k observations; a 256-node
    graph with loop edges). Checks, as the reference's dry run does: the Schur
    cost after 6 iterations below half the cost after 0; the whole-map cost
    after 12 iterations below 0.6 of the initial robust cost; the PGO mean
    translation error after 12 se3 iterations below 0.3 of the drift's. Also
    that every rank holds the same bits of every replicated pose. Besides, the
    Schur solve of the problem `with_point_noise` ("noisy_R", "noisy_t",
    "noisy_cost"), for comparison with one process. Raises AssertionError on
    a failed check; returns the numbers, rank 0's poses and the slowest
    rank's synchronised times (`ms_max`: the whole solves "ba", "gba" and
    "pgo", each after a warm-up; and "ba_allreduce" / "pgo_allreduce", one
    iteration's all-reduces issued on their own after a barrier, not inside a
    solve, averaged over `REPS`)."""
    return dryrun_sizes([world_size], backend, device, W=W, P=P, L=L, K=K, timeout=timeout)[0]
