"""The rare paths' stage programs and their two kernels, on the CPU.

`Tracker` runs relocalization (`reloc_match`, the draw, `reloc_pnp`, one
`reloc_track` per seed, `reloc_pick`), the loop closer's verification and
correction (`loop_match`, the draw, `loop_verify`, `loop_correct`) and the
BA chunks (`vi_ba`, `gba`) through `frontend.graphs.StageProgram`: on a GPU
captured once per input signature and replayed. Their values are held
against the reference by the existing parity tests (test_torch_loop,
test_torch_reloc_atlas, test_torch_flagship, test_torch_mono_rgbd, which
run the port's trackers through these stages); here, on a small
stereo-inertial map (test_torch_stages' configuration, 12 host-path frames,
loop closing at a low inlier floor):

- (a) each new stage traced with `make_fx(tracing_mode="fake")` on the
  arguments it got in the run (the mono PnP and every correction mode
  included): a host read, an index by a 0-d tensor, a data-dependent size
  or a constant uploaded inside the stage fails it;
- (b) the chain of a keyframe window gathered on the device (`step.kf_chain`)
  equals the host's numpy gather (`_host_kf_chain`, the tracker's before
  the stages) on windows with gaps, culled slots and padding;
- (c) a kidnapped frame's relocalization, a planted loop's verification and
  correction with the "gba" chunk it queues, and the visual-inertial BA
  over a window with a culled slot, each run through the stages from one
  state, equal the same calls as the tracker made them eagerly before the
  stages existed (transcribed here:
  host ints, host reads, the chain in numpy, the seeds' best picked on the
  host) bit for bit, with the reference's own RANSAC draw
  (`reference_draw`, `jax.random.choice`) in both; and the stages again on
  stand-in graphs (test_torch_stages.stand_in_capture) equal eager;
- (d) each kernel's method (csrc/eig4.cu: round-robin Jacobi in float64,
  `test_torch_small_kernels.eig4_method`; csrc/svd_small.cu: one-sided Jacobi in float64, a warp a matrix in
  round-robin order, `svd_small.schedule`), mirrored in numpy,
  against its twin (`torch.linalg.eigh` / `torch.linalg.svd`, what the CPU
  runs) and against float64 on the matrices the run hands them (Horn's
  matrices of the PnP and loop RANSACs, the mono PnP's DLT systems and
  rotation blocks) and on degenerate ones (collinear and coincident
  triplets, rank-deficient DLT systems): no farther from float64 than the
  twin, and where the largest eigenvalue is not simple, an eigenvector of
  it; svd_small's schedule (disjoint pairs, each pair once a sweep, the
  phantom column of an odd n never rotated), and its source compiled for
  the host (`svd_small_host`) equal to the numpy method bit for bit.

What the CPU cannot show: that CUDA accepts the captures and that the
kernels build and agree on the card. chip_smoke.py phases 3c / 3d (the
kernels) and 6a / 6b / 8 (the rare paths, graphs against eager) do that.
"""

import ctypes
import dataclasses
import os
import shutil
import subprocess
from collections import defaultdict
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_graph_step import _fake_trace
from test_torch_reloc_atlas import reference_draw
from test_torch_small_kernels import eig4_method
from test_torch_stages import CAM, _frames, _vi_cfg, stand_in_capture

from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import loop_closing as tlc
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import matching
from pli_slam_tpu_torch.ops.kernels import eig4, svd_small
from pli_slam_tpu_torch.solve import pnp as tpnp
from pli_slam_tpu_torch.solve import sim3 as tsim3
from pli_slam_tpu_torch.utils.profile import imu_batch

torch.set_num_threads(1)
N_FRAMES = 12
RARE = ("reloc_match", "reloc_pnp", "reloc_track", "reloc_pick", "loop_match", "loop_verify", "loop_correct", "vi_ba",
        "gba")
STATE = ("R", "t", "R_prev", "t_prev", "vel_xi", "has_vel", "pstore", "lstore", "kstore", "bow_db", "_local_pt",
         "state", "_lost_frames", "_map_event_cooldown", "gravity_w", "_pints")


def _cfg(**opt):
    """test_torch_stages' stereo-inertial configuration with loop closing on
    at a low inlier floor (the planted loop verifies), the "gba" chunks of 2
    iterations; `opt` overrides the optimizer (the traces' fewer iterations)."""
    cfg = _vi_cfg()
    return dataclasses.replace(
        cfg, loop=dataclasses.replace(cfg.loop, enabled=True, min_kf_gap=2, sim3_min_inliers=10, proj_min_inliers=10,
                                      gba_chunk_iters=2),
        opt=dataclasses.replace(cfg.opt, **opt))


def _snap(tr) -> dict:
    return {name: getattr(tr, name) for name in STATE} | {"_deferred_ba": list(tr._deferred_ba)}


def _install(tr, snap: dict) -> None:
    for name, val in snap.items():
        setattr(tr, name, list(val) if name == "_deferred_ba" else val)


def _assert_same(a: dict, b: dict, label: str) -> None:
    for name in a:
        if name == "_deferred_ba":
            assert [k for k, _ in a[name]] == [k for k, _ in b[name]], label
            continue
        la, lb = graphs.tree_leaves(a[name]), graphs.tree_leaves(b[name])
        if not la:
            assert a[name] == b[name], (label, name, a[name], b[name])
        for x, y in zip(la, lb, strict=True):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"{label} {name}: {m}")


# ---------------------------------------------------------------------------
# The rare paths as the tracker ran them eagerly before the stages, transcribed
# ---------------------------------------------------------------------------


def _unstaged_relocalize(tr, frame) -> bool:
    """Tracker._relocalize as it ran before the stages: eager, the seeds' counts and the
    nearest keyframe read on the host."""
    if tr.n_kf == 0:
        return False
    cfg, ps = tr.cfg, tr.pstore
    dist = matching.hamming_matrix(frame.feats.desc, ps.desc)
    idx, _, okm = matching.match_nn(dist, frame.feats.valid, ps.valid, max_dist=cfg.match.orb_th_low, ratio=0.8)
    okm = matching.mutual_consistency(idx, okm, dist, frame.feats.valid, ps.valid)
    if not tr.is_mono:
        okm = okm & (frame.depth > 0)
    hyp = tr.draw(7000 + len(tr.stats), tsim3.mask_probs(okm), (tpnp.N_HYPOTHESES, 6 if tr.is_mono else 3))
    Rp, tp, _, _, okp = tpnp.solve_pnp(tr.cam, ps.x[idx.long()], frame.feats.uv, frame.u_right, frame.stereo_ok,
                                       frame.depth, frame.sigma2, okm, hyp, cfg.opt, inlier_px=8.0, min_inliers=12,
                                       mono=tr.is_mono)
    seeds = [(Rp, tp)] if bool(okp) else []
    nb = cfg.loop.bow_candidates
    excl = torch.zeros(tr.bow_db.valid.shape[0], dtype=torch.bool)
    slots, scores = tstep.vocab_query(tr.bow_db, tr.voc_pt.bow(frame.feats.desc, frame.feats.valid),
                                      tr.voc_ln.bow(frame.lines.desc, frame.lines.valid), excl, n_best=nb)
    for k, score in zip(slots.numpy(), scores.numpy()):
        if k >= 0 and float(score) > 0.05:
            seeds.append((tr.kstore.R[int(k)], tr.kstore.t[int(k)]))
    best_n, best_pose = 0, None
    for R0, t0 in seeds:
        R, t, *_, n_in, tr.pstore, tr.lstore = tstep.track_step(tr.cam, cfg, frame, R0, t0, tr.pstore, tr.lstore,
                                                                wide=torch.ones((), dtype=torch.bool))
        if int(n_in) > best_n:
            best_n, best_pose = int(n_in), (R, t)
    if best_pose is None or best_n < cfg.tracking.min_inliers_local_map:
        return False
    tr.R, tr.t = best_pose
    tr._reset_motion()
    tr.state = TrackingState.OK
    d = np.linalg.norm(tr.kstore.t[: tr.n_kf].numpy() - tr.t.numpy()[None], axis=1)
    d[~tr.kstore.valid[: tr.n_kf].numpy()] = np.inf
    tr._refresh_local_map(int(np.argmin(d)))
    return True


def _unstaged_verify_and_close(lc, tr, kf_slot, candidates) -> bool:
    """LoopCloser._verify_and_close as it ran before the stages (amortized GBA), eager on host ints."""
    cfg, verified = lc.cfg, None
    for s, _ in candidates:
        x, y, m = tlc.match_kf_landmarks(tr.kstore, tr.pstore, kf_slot, s)
        idx = lc.draw(kf_slot * 7 + s, tsim3.mask_probs(m), (cfg.loop.sim3_hypotheses, 3))
        R_rel, t_rel, s_rel, _, n_in = tsim3.ransac_sim3(x, y, m, idx, inlier_thresh=tlc.scene_scaled_thresh(x, m),
                                                         with_scale=lc.with_scale)
        if int(n_in) < cfg.loop.sim3_min_inliers:
            continue
        sup = [int(tlc.projection_support(tr.cam, tr.kstore, tr.pstore, k, s, R_rel, t_rel, s_rel,
                                          radius=cfg.loop.proj_radius_px)) for k in (kf_slot, max(kf_slot - 1, 0))]
        if sup[0] >= cfg.loop.proj_min_inliers and sup[1] >= cfg.loop.proj_min_inliers // 2:
            verified = (s, R_rel, t_rel, s_rel)
            break
    if verified is None:
        return False
    best, R_rel, t_rel, s_rel = verified
    inertial = bool(tr.imu_ready)
    R_kf0, t_kf0 = tr.kstore.R[kf_slot], tr.kstore.t[kf_slot]
    tr.kstore, tr.pstore, tr.lstore = tlc.apply_loop_correction(tr.kstore, tr.pstore, tr.lstore, kf_slot, best,
                                                                R_rel, t_rel, cfg, inertial=inertial,
                                                                s_rel=s_rel if lc.with_scale else None)
    tr._queue_gba(inertial)
    R_d = tr.kstore.R[kf_slot] @ R_kf0.T
    t_d = tr.kstore.t[kf_slot] - R_d @ t_kf0
    tr.t = R_d @ tr.t + t_d
    tr.R = R_d @ tr.R
    tr._reset_motion()
    tr._map_event_cooldown = 5
    lc.n_loops_closed += 1
    return True


def _host_kf_chain(tr, window: np.ndarray):
    """The stacked preintegration chain and its mask (numpy) of consecutive
    window slots, gathered on the host as the tracker did before the stages:
    factor i spans window[i] -> window[i+1], valid only between adjacent
    slots with a recorded accumulator."""
    window = np.asarray(window)
    nxt = window[1:]
    stacked = tr._pints.gather(torch.as_tensor(nxt, dtype=torch.int32, device=tr.device))
    return stacked, tr._pints.valid.cpu().numpy()[nxt] & (nxt == window[:-1] + 1)


def _unstaged_vi_ba(tr, window, fixed) -> None:
    """A "fiba" chunk as it ran before the stages: the chain and the culled slots read on the host."""
    fixed = fixed | ~tr.kstore.valid.numpy()[window]
    stacked, imu_mask = _host_kf_chain(tr, window)
    tr.kstore, tr.pstore, tr.lstore = tstep.local_inertial_ba(
        tr.cam, tr.cfg, tr.kstore, tr.pstore, tr.lstore, torch.as_tensor(window, dtype=torch.int32),
        torch.as_tensor(fixed), stacked, torch.as_tensor(imu_mask), tr.gravity_w, tr.ext)


def _unstaged_gba(tr, iters) -> None:
    tr.kstore, tr.pstore, tr.lstore = tstep.global_ba(tr.cam, tr.cfg, tr.kstore, tr.pstore, tr.lstore, iters=iters)


# ---------------------------------------------------------------------------
# The run: a small map, then each rare path through the stages, recorded
# ---------------------------------------------------------------------------

WINDOW = np.array([1, 2, 3, 4, 5, 5, 5, 5])  # a "fiba" window of capacity 8 over 6 keyframes, padded
FIXED = np.array([True, False, False, False, False, True, True, True])
CULLED = 3  # a slot culled after the window was drawn


def _kidnap(tr):
    tr.R, tr.t = torch.eye(3), torch.zeros(3)
    tr.state = TrackingState.LOST


def _loop_prep(tr):
    """The loop closer with the reference's draw, and a keyframe slot / candidate pair that shares landmarks."""
    lc = tlc.LoopCloser(tr.cfg, draw=reference_draw)
    return lc, tr.n_kf - 1, [(tr.n_kf - 3, 0.9)]


def _vi_prep(tr):
    tr.gravity_w = torch.tensor([0.0, 0.3, -9.8])
    tr.kstore = dataclasses.replace(tr.kstore, valid=tr.kstore.valid.clone().index_fill_(0, torch.tensor([CULLED]),
                                                                                          False))


@pytest.fixture(scope="module")
def run():
    """The map after N_FRAMES; each rare path run from the same state through
    the stages (recording each stage call's arguments and every matrix handed
    to the two kernels) and as the tracker ran it before the stages."""
    frames = _frames()[:N_FRAMES]
    tr = Tracker(CAM, _cfg(), "cpu")
    tr.draw = reference_draw
    for fr in frames:
        tr.process(fr["img_l"], fr["img_r"], fr["t"], imu=imu_batch(fr))
    assert tr.n_kf >= 6 and tr.state == TrackingState.OK, (tr.n_kf, tr.state)
    frame = tr.build_frame(torch.as_tensor(frames[-2]["img_l"]), torch.as_tensor(frames[-2]["img_r"]))
    base = _snap(tr)

    calls, mats = defaultdict(list), defaultdict(list)
    mp = pytest.MonkeyPatch()
    orig_call, orig_eig, orig_svd = graphs.StageProgram.__call__, eig4.largest_eigvec, svd_small.svd

    def record_call(self, *args):
        calls[self.name].append(args)
        return orig_call(self, *args)

    def record_eig(N):
        mats["horn"].append(N.detach().reshape(-1, 4, 4).clone())
        return orig_eig(N)

    def record_svd(A):
        mats[f"svd{A.shape[-1]}"].append(A.detach().reshape(-1, A.shape[-1], A.shape[-1]).clone())
        return orig_svd(A)

    mp.setattr(graphs.StageProgram, "__call__", record_call)
    mp.setattr(eig4, "largest_eigvec", record_eig)
    mp.setattr(svd_small, "svd", record_svd)

    def paths(t, stages: bool):
        """Each rare path from the base state: (label, what it returned, the state after)."""
        out = []
        _install(t, base)
        _kidnap(t)
        ok = t._relocalize(frame) if stages else _unstaged_relocalize(t, frame)
        out.append(("relocalization", ok, _snap(t)))
        _install(t, base)
        lc, kf, cands = _loop_prep(t)
        closed = lc._verify_and_close(t, kf, cands) if stages else _unstaged_verify_and_close(lc, t, kf, cands)
        out.append(("loop closure", closed, _snap(t)))
        kind, iters = t._deferred_ba[0]
        assert kind == "gba"
        t._deferred_ba = []
        if stages:
            t.kstore, t.pstore, t.lstore = t._stages["gba"](t.kstore, t.pstore, t.lstore, iters)
        else:
            _unstaged_gba(t, iters)
        out.append(("gba chunk", None, _snap(t)))
        _install(t, base)
        _vi_prep(t)
        if stages:
            t._run_vi_ba(WINDOW, FIXED)
        else:
            _unstaged_vi_ba(t, WINDOW, FIXED)
        out.append(("vi_ba window", None, _snap(t)))
        _install(t, base)
        return out

    try:
        staged = paths(tr, True)
        # the mono PnP (the 6-point DLT) on the relocalization's matches: its draw, its stage's result
        (frame_r, x_store, idx, okm, _, bow_db), = calls["reloc_pnp"]
        mono_hyp = reference_draw(7003, tsim3.mask_probs(okm), (tpnp.N_HYPOTHESES, 6))
        mono_pnp = tstep.reloc_pnp(tr.cam, tr.cfg, True, tr.voc_pt, tr.voc_ln, frame_r, x_store, idx, okm, mono_hyp,
                                   bow_db)
    finally:
        mp.undo()
    eager = paths(tr, False)
    return dict(tracker=tr, frame=frame, base=base, staged=staged, eager=eager, calls=calls,
                mats={k: torch.cat(v) for k, v in mats.items()}, mono=(mono_hyp, mono_pnp))


# ---------------------------------------------------------------------------
# (a) fake-mode traces of every new stage
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trace_tracker():
    """A tracker of the run's configuration with one Gauss-Newton iteration
    a round, one BA and one PGO iteration: the traces repeat the same bodies
    fewer times (the arguments' shapes are the run's)."""
    return Tracker(CAM, _cfg(pose_rounds=2, pose_gn_iters=1, pose_gn_iters_refine=0, local_ba_iters=1, pgo_iters=1),
                   "cpu")


TRACES = [(name, None) for name in RARE if name not in ("reloc_pnp", "loop_correct")] + [
    ("reloc_pnp", "stereo"), ("reloc_pnp", "mono"), ("loop_correct", "se3"), ("loop_correct", "4dof"),
    ("loop_correct", "sim3")]


@pytest.mark.parametrize("name,variant", TRACES)
def test_rare_stage_traces_in_fake_mode(run, trace_tracker, name, variant):
    tr, tt = run["tracker"], trace_tracker
    args = run["calls"][name][0]
    fn = tt._stages[name].fn
    if name == "reloc_pnp" and variant == "mono":
        args = args[:4] + (run["mono"][0], args[5])
        fn = lambda *a: tstep.reloc_pnp(tt.cam, tt.cfg, True, tt.voc_pt, tt.voc_ln, *a)  # noqa: E731
    if name == "loop_correct":
        args = (variant,) + args[1:]  # the mode
    if name == "gba":
        args = args[:-1] + (1,)  # one BA iteration
    fn(*args)  # the eager run fills the constant cache, as the warm-up before a capture does
    outside = graphs.tree_leaves(tr.ext) + graphs.tree_leaves(tt.ext)
    assert len(_fake_trace(fn, args, outside).graph.nodes) > 10


# ---------------------------------------------------------------------------
# (b) the window's chain on the device against the host's
# ---------------------------------------------------------------------------


def test_kf_chain_on_the_device_equals_the_host_gather(run):
    """Windows with a gap, a culled slot, the padding of a "fiba" window and
    slots whose accumulator was never recorded."""
    tr = run["tracker"]
    old = tr._pints
    K = old.valid.shape[0]
    valid = old.valid.clone()
    valid[2] = False  # a factor never recorded (a merge dropped it)
    tr_pints = tr._pints = dataclasses.replace(old, valid=valid)
    try:
        n_masked = 0
        for window in (np.arange(8), np.array([0, 1, 3, 4, 5, 6, 7, 8]), np.clip(np.arange(2, 10), 0, 5),
                       np.array([4, 5, 6, K - 2, K - 1, K - 1])):
            stacked_h, mask_h = _host_kf_chain(tr, window)
            stacked_d, mask_d = tstep.kf_chain(tr_pints, torch.as_tensor(window, dtype=torch.int32))
            assert np.array_equal(mask_d.numpy(), mask_h), window
            for a, b in zip(graphs.tree_leaves(stacked_d), graphs.tree_leaves(stacked_h), strict=True):
                assert torch.equal(a, b)
            n_masked += int((~mask_h).sum())
        assert n_masked >= 6
    finally:
        tr._pints = old


# ---------------------------------------------------------------------------
# (c) the rare paths through the stages against the eager calls before them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["relocalization", "loop closure", "gba chunk", "vi_ba window"])
def test_rare_path_through_stages_equals_unstaged_eager(run, path):
    (label, got, after), = [p for p in run["staged"] if p[0] == path]
    (_, want, after_e), = [p for p in run["eager"] if p[0] == path]
    assert got == want, (path, got, want)
    if path in ("relocalization", "loop closure"):
        assert got, f"the planted {path} did not succeed"
    _assert_same(after, after_e, path)
    moved = [name for name in ("R", "pstore", "kstore") if any(
        not torch.equal(a, b) for a, b in zip(graphs.tree_leaves(after[name]), graphs.tree_leaves(run["base"][name])))]
    assert moved, f"{path} changed nothing"


def test_rare_paths_on_stand_in_graphs_equal_eager(run):
    """The staged paths again with every rare stage replaying a stand-in
    graph (test_torch_stages.stand_in_capture: outputs rewritten in place at
    every replay): the same states bit for bit. The first lost frame (a
    tracker's `_note_lost`) captures every relocalization stage
    (`Tracker.warm_up_reloc`) in the signature the relocalization then
    replays (the draw as `sample_indices` gives it, int64), the second does
    not again, and each stage is captured once per signature (the seeds'
    re-tracks replay one capture)."""
    tr = run["tracker"]
    saved, draw = {name: tr._stages[name] for name in RARE}, tr.draw
    for name in RARE:
        tr._stages[name] = graphs.StageProgram(saved[name].fn, "cpu", True, name, capture=stand_in_capture)
    tr.draw = lambda seed, probs, shape: reference_draw(seed, probs, shape).long()
    try:
        _install(tr, run["base"])
        assert tr.reloc_warmup_ms is None
        tr._note_lost()
        warm = {name: tr._stages[name].captures for name in RARE if name.startswith("reloc")}
        tr._note_lost()
        assert tr.reloc_warmup_ms is not None and tr._lost_frames == 2
        tr._lost_frames = 0
        assert warm["reloc_pick"] == 1 + tr.cfg.loop.bow_candidates and warm["reloc_track"] == 1, warm
        _kidnap(tr)
        assert tr._relocalize(run["frame"])
        assert {name: tr._stages[name].captures for name in warm} == warm, "the relocalization captured anew"
        _assert_same(_snap(tr), run["staged"][0][2], "relocalization on stand-in graphs")
        _install(tr, run["base"])
        lc, kf, cands = _loop_prep(tr)
        assert lc._verify_and_close(tr, kf, cands)
        _assert_same(_snap(tr), run["staged"][1][2], "loop closure on stand-in graphs")
        progs = {name: tr._stages[name] for name in RARE}
        assert progs["reloc_track"].captures == 1 and progs["reloc_track"].replays >= 2
        assert all(progs[n].captures == 1 for n in RARE if n not in ("vi_ba", "gba", "reloc_pick")), \
            {n: p.captures for n, p in progs.items()}
    finally:
        tr._stages.update(saved)
        tr.draw, tr.reloc_warmup_ms, tr._lost_frames = draw, None, 0
        _install(tr, run["base"])


def test_empty_frame_has_every_builders_signature(run):
    """`frame.empty_frame` (what the relocalization's warm-up captures on) has
    the structure, shapes and types of the stereo, RGB-D and mono builders'
    frames, so the first relocalization replays the warm-up's capture."""
    fr = _frames()[0]
    img_l, img_r = torch.as_tensor(fr["img_l"]), torch.as_tensor(fr["img_r"])
    cfg = _cfg()
    want = graphs.signature(tframe.empty_frame(cfg))
    for build, imgs in ((partial(tframe.build_frame, CAM, cfg), (img_l, img_r)),
                        (partial(tframe.build_frame_rgbd, CAM, cfg), (img_l, torch.full_like(img_l, 2.0))),
                        (partial(tframe.build_frame_mono, CAM, cfg), (img_l,))):
        assert graphs.signature(build(*imgs)) == want, build.func.__name__


# ---------------------------------------------------------------------------
# (d) the kernels' methods against their twins and float64
# ---------------------------------------------------------------------------


def _svd_method(A: np.ndarray, rotated: set | None = None):
    """csrc/svd_small.cu's arithmetic, transcribed (float64, all matrices at
    once, each float operation in the kernel's order): one-sided Jacobi on
    the columns in the round-robin order of `svd_small.schedule`, each
    pair's alpha, beta, gamma summed per lane over its rows and then over
    the pair's lanes by the xor butterfly; the norms sorted descending by
    rank (stable) into a permutation, zero columns of U completed by
    Gram-Schmidt. `rotated` collects the pairs that rotated in any matrix.
    Returns (U, S, Vh) in float32 and each matrix's sweeps."""
    N, n, _ = A.shape
    lanes, steps = svd_small.schedule(n)
    b = A.astype(np.float64).transpose(0, 2, 1).copy()  # b[:, j]: column j of B
    v = np.tile(np.eye(n), (N, 1, 1))  # v[:, j]: column j of V
    tol2, tiny = n * np.finfo(np.float64).eps * np.finfo(np.float64).eps, np.finfo(np.float64).tiny
    sweeps = np.full(N, 30, np.int32)
    for sw in range(30):
        any_rot = np.zeros(N, bool)
        for pairs in steps:
            live = [(p, q) for p, q in pairs if q < n]
            if not live:
                continue
            P, Q = np.array([p for p, _ in live]), np.array([q for _, q in live])
            bp, bq = b[:, P], b[:, Q]  # [N, pairs, n]
            part = []
            for sub in range(lanes):
                x = np.zeros((3,) + bp.shape[:2])
                for r in range(sub, n, lanes):
                    x = x + np.stack([bp[..., r] * bp[..., r], bq[..., r] * bq[..., r], bp[..., r] * bq[..., r]])
                part.append(x)
            off = 1
            while off < lanes:
                part = [part[i] + part[i ^ off] for i in range(lanes)]
                off *= 2
            alpha, beta, gamma = part[0]
            d, g = beta - alpha, 2.0 * gamma
            x = d * d + g * g
            m = (gamma * gamma > tol2 * alpha * beta) & (np.minimum(np.minimum(alpha, beta),
                                                                    np.minimum(np.abs(gamma), x)) >= tiny)
            with np.errstate(divide="ignore", invalid="ignore"):
                h = x * (1.0 / np.sqrt(x))
                D = np.abs(d) + h
                r = 1.0 / np.sqrt(2.0 * h * D)
                cs, sn = D * r, np.where(d >= 0.0, g, -g) * r
            m &= np.abs(sn) >= tiny
            if not m.any():
                continue
            any_rot |= m.any(1)
            if rotated is not None:
                rotated.update(live[k] for k in np.flatnonzero(m.any(0)))
            cs, sn, m = cs[..., None], sn[..., None], m[..., None]
            for M in (b, v):
                x, y = M[:, P], M[:, Q]
                M[:, P], M[:, Q] = np.where(m, cs * x - sn * y, x), np.where(m, sn * x + cs * y, y)
        sweeps[(sweeps == 30) & ~any_rot] = sw
        if not any_rot.any():
            break
    rows = np.arange(N)
    nrm = np.zeros((N, n))
    for r in range(n):
        nrm = nrm + b[:, :, r] * b[:, :, r]
    perm = np.zeros((N, n), int)  # a stable descending sort by ranks
    for j in range(n):
        rank = (nrm > nrm[:, j:j + 1]).sum(1) + (nrm[:, :j] == nrm[:, j:j + 1]).sum(1)
        perm[rows, rank] = j
    nrm = nrm[rows[:, None], perm]  # in sorted order
    s = np.sqrt(nrm)
    with np.errstate(divide="ignore"):
        inv = np.where(nrm > 1e-300, 1.0 / np.sqrt(nrm), 1.0)
    b[rows[:, None], perm] *= inv[..., None]

    def dot(x, y):
        d = 0.0
        for r in range(n):
            d += x[r] * y[r]
        return d

    for i_m in np.flatnonzero((nrm <= 1e-300).any(1)):
        cols = b[i_m]
        for j in range(n):
            if nrm[i_m, j] > 1e-300:
                continue
            c = cols[perm[i_m, j]]
            for e in range(n):
                c[:] = np.eye(n)[e]
                for _ in range(2):
                    for i in range(j):
                        ci = cols[perm[i_m, i]]
                        d = dot(ci, c)
                        c -= d * ci
                x = dot(c, c)
                if 2.0 * n * x > 1.0 or e == n - 1:
                    c *= 1.0 / np.sqrt(x)
                    break
    u = b[rows[:, None], perm].transpose(0, 2, 1)
    vt = v[rows[:, None], perm]
    return u.astype(np.float32), s.astype(np.float32), vt.astype(np.float32), sweeps


def _sign_free(a, b):
    """Largest difference of unit vectors [n, d] up to each one's sign."""
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


def _degenerate_horn(rng):
    """Horn's N for triplets whose alignment is not unique: collinear and
    coincident points (two or more equal largest eigenvalues), and N = 0."""
    mats = []
    for kind in ("collinear", "coincident", "zero"):
        for _ in range(20):
            if kind == "collinear":
                d = rng.normal(size=3)
                x = np.outer(rng.normal(size=3), d) + rng.normal(size=3)
            elif kind == "coincident":
                x = np.repeat(rng.normal(size=(1, 3)), 3, axis=0)
            else:
                x = np.zeros((3, 3))
            y = x @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + rng.normal(size=3)
            mats.append(_horn_matrix(x.astype(np.float32), y.astype(np.float32)))
    return np.stack(mats)


def _horn_matrix(x, y):
    xc, yc = x - x.mean(0), y - y.mean(0)
    S = (xc[:, :, None] * yc[:, None, :]).mean(0)
    (sxx, sxy, sxz), (syx, syy, syz), (szx, szy, szz) = S
    return np.array([[sxx + syy + szz, syz - szy, szx - sxz, sxy - syx],
                     [syz - szy, sxx - syy - szz, sxy + syx, szx + sxz],
                     [szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy],
                     [sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]], np.float32)


def test_eig4_method_no_farther_from_float64_than_the_twin(run, capsys):
    """On the Horn matrices of the run's PnP and loop RANSACs and refits, and
    on general symmetric matrices: the method's largest error against the
    float64 eigenvector (sign-free) is no larger than eigh's in float32.
    Degenerate matrices (collinear, coincident triplets; N = 0): the
    method's vector is a unit eigenvector of the largest eigenvalue."""
    rng = np.random.default_rng(5)
    main = run["mats"]["horn"].numpy()
    assert len(main) >= 500
    B = rng.normal(size=(400, 4, 4)).astype(np.float32)
    general = ((B + B.transpose(0, 2, 1)) / 2).astype(np.float32)
    for label, N in (("main path", main), ("general", general)):
        w, V = np.linalg.eigh(N.astype(np.float64))
        simple = (w[:, 3] - w[:, 2]) > 1e-3 * np.maximum(np.abs(w).max(1), 1e-30)
        exact = V[:, :, 3]
        got = eig4_method(N)[0]
        twin = eig4.largest_eigvec_reference(torch.as_tensor(N)).numpy()
        e_m, e_t = _sign_free(got, exact)[simple].max(), _sign_free(twin, exact)[simple].max()
        with capsys.disabled():
            print(f"\neig4 {label} ({simple.sum()} of {len(N)} with a simple largest eigenvalue): max |q - q_float64| "
                  f"method {e_m:.3e}, twin {e_t:.3e}")
        assert simple.sum() >= 0.9 * len(N)
        assert e_m <= e_t, (label, e_m, e_t)
    deg = _degenerate_horn(rng)
    got, lam, _ = eig4_method(deg)
    w = np.linalg.eigh(deg.astype(np.float64))[0][:, 3]
    scale = np.maximum(np.abs(deg).max((1, 2)), 1e-30)
    resid = np.abs(np.einsum("nij,nj->ni", deg.astype(np.float64), got) - w[:, None] * got).max(1) / scale
    assert np.allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    assert resid.max() < 1e-5 and np.abs(lam - w).max() <= 1e-5 * scale.max(), (resid.max(), np.abs(lam - w).max())


def test_svd_small_method_no_farther_from_float64_than_the_twin(run, capsys):
    """On the mono PnP's DLT systems A [H,12,12] (the null vector: the last
    row of Vh) and rotation blocks M [H,3,3] (R = U Vh, S), and on general
    and rank-deficient systems: the method's largest error against float64
    is no larger than torch.linalg.svd's in float32; on rank-deficient
    systems U and V are orthogonal and A = U S Vh."""
    rng = np.random.default_rng(6)
    A_main, M_main = run["mats"]["svd12"].numpy(), run["mats"]["svd3"].numpy()
    assert len(A_main) == tpnp.N_HYPOTHESES and len(M_main) == tpnp.N_HYPOTHESES
    for label, A in (("DLT systems", A_main), ("general 12x12", rng.normal(size=(200, 12, 12)).astype(np.float32))):
        _, s64, vt64 = np.linalg.svd(A.astype(np.float64))
        gap = (s64[:, -2] - s64[:, -1]) > 1e-4 * s64[:, 0]
        _, _, vt, _ = _svd_method(A)
        twin = svd_small.svd_reference(torch.as_tensor(A))[2].numpy()
        e_m = _sign_free(vt[:, -1], vt64[:, -1])[gap].max()
        e_t = _sign_free(twin[:, -1], vt64[:, -1])[gap].max()
        with capsys.disabled():
            print(f"\nsvd_small {label} ({gap.sum()} of {len(A)} with a simple smallest singular value): max "
                  f"|v_min - v_float64| method {e_m:.3e}, twin {e_t:.3e}")
        assert gap.sum() >= 0.5 * len(A)
        assert e_m <= e_t, (label, e_m, e_t)
    for label, M in (("rotation blocks", M_main), ("general 3x3", rng.normal(size=(400, 3, 3)).astype(np.float32))):
        u64, s64, vt64 = np.linalg.svd(M.astype(np.float64))
        R64 = u64 @ vt64
        u, s, vt, _ = _svd_method(M)
        tu, ts, tvt = (x.numpy() for x in svd_small.svd_reference(torch.as_tensor(M)))
        e_m = max(np.abs(u.astype(np.float64) @ vt - R64).max(), np.abs(s - s64).max() / s64.max())
        e_t = max(np.abs(tu.astype(np.float64) @ tvt - R64).max(), np.abs(ts - s64).max() / s64.max())
        with capsys.disabled():
            print(f"svd_small {label}: max error of (U Vh, S / S_max) method {e_m:.3e}, twin {e_t:.3e}")
        assert e_m <= e_t, (label, e_m, e_t)
    # rank-deficient DLT systems: points on a line (rank 8 at most) and a repeated point, and zero rows
    A = A_main[:40].copy()
    A[:20, 6:] = 0.0
    A[20:, :, 3] = A[20:, :, 7] = 0.0
    u, s, vt, _ = _svd_method(A)
    eye = np.eye(12)
    assert np.abs(np.einsum("nji,njk->nik", u.astype(np.float64), u) - eye).max() < 1e-6
    assert np.abs(np.einsum("nij,nkj->nik", vt.astype(np.float64), vt) - eye).max() < 1e-6
    assert np.abs(np.einsum("nij,nj,njk->nik", u.astype(np.float64), s, vt) - A).max() < 1e-5 * np.abs(A).max()
    assert (s[:, -1] == 0).all() and np.abs(np.einsum("nij,nj->ni", A.astype(np.float64), vt[:, -1])).max() < 1e-5


@pytest.mark.parametrize("n", range(1, svd_small.MAX_N + 1))
def test_svd_small_schedule_visits_every_pair_once_a_sweep(n):
    """`svd_small.schedule`: the pairs of each step are disjoint, a sweep
    visits every pair of the n' = n rounded up to even columns exactly once,
    the slots' lanes fit in a warp with at most 3 rows a lane (the kernel's
    kRows), and the method never rotates an odd n's phantom column."""
    lanes, steps = svd_small.schedule(n)
    even = n + n % 2
    assert len(steps) == max(even - 1, 1) and all(len(pairs) == even // 2 for pairs in steps)
    assert lanes & (lanes - 1) == 0 and even // 2 * lanes <= 32 < even // 2 * lanes * 2
    assert -(-n // lanes) <= 3
    for pairs in steps:
        cols = [c for pair in pairs for c in pair]
        assert len(set(cols)) == len(cols) and all(p < q for p, q in pairs)
        assert sum(q == n for _, q in pairs) == n % 2
    assert sorted(pair for pairs in steps for pair in pairs) == [(p, q) for p in range(even) for q in range(p + 1, even)]
    rotated = set()
    A = np.random.default_rng(n).normal(size=(32, n, n)).astype(np.float32)
    _svd_method(A, rotated)
    assert all(q < n for _, q in rotated) and len(rotated) == n * (n - 1) // 2


@pytest.fixture(scope="module")
def svd_host(tmp_path_factory):
    """csrc/svd_small.cu built as plain C++ (no __CUDACC__: `svd_small_host`,
    the warp's lanes run one after another), contraction into fused
    multiply-adds off so that its float operations are numpy's."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler (g++ / c++) to build csrc/svd_small.cu for the host"
    out = tmp_path_factory.mktemp("svd_host")
    src = out / "svd_host.cpp"
    src.write_text(f'#include "{Path(svd_small._SRC)}"\n')
    so = out / "libsvd_host.so"
    subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                    str(src)], check=True, capture_output=True, timeout=30)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.svd_small_host.argtypes = [vp, vp, vp, vp, ci, ci, vp]
    lib.svd_small_host.restype = ci

    def factor(A):
        A = np.ascontiguousarray(A, np.float32)
        count, n = A.shape[0], A.shape[-1]
        u, vt, s = np.empty_like(A), np.empty_like(A), np.empty((count, n), np.float32)
        sweeps = np.empty(count, np.int32)
        assert lib.svd_small_host(A.ctypes.data, u.ctypes.data, s.ctypes.data, vt.ctypes.data, count, n,
                                  sweeps.ctypes.data) == 0
        return u, s, vt, sweeps

    return factor


@pytest.mark.parametrize("n", range(1, svd_small.MAX_N + 1))
def test_svd_small_source_on_the_host_equals_the_method(svd_host, n):
    """The kernel's source, compiled for the host, equals the numpy method
    bit for bit (U, S, Vh and the sweeps) on general matrices, matrices with
    a zero column (a zero singular value: U completed) and with a repeated
    row. The card's build contracts into fused multiply-adds and so differs
    in the last bits; chip_smoke.py phase 3d holds it against float64."""
    A = np.random.default_rng(100 + n).normal(size=(48, n, n)).astype(np.float32)
    if n > 1:
        A[:8, :, -1] = 0.0
        A[8:16, -1] = A[8:16, 0]
    for got, want in zip(svd_host(A), _svd_method(A), strict=True):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_svd_small_source_on_the_host_equals_the_method_on_the_main_path(svd_host, run):
    """As above, on the mono PnP's DLT systems and rotation blocks of the run."""
    for key in ("svd12", "svd3"):
        A = run["mats"][key].numpy()
        for got, want in zip(svd_host(A), _svd_method(A), strict=True):
            assert np.array_equal(got, want), key
