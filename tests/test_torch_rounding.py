"""Windowed BA's reduced camera system: one float32 ulp of input, in float32
and in float64.

chip_smoke.py's phase 6a parted, under two builds of the closest-rotation
kernel whose results differ by one ulp, at its first windowed BA: three
keyframes, the two oldest fixed, ~600 landmarks, the newest keyframe's pose
half a micrometre apart; after the BA the camera lay ~2 mm apart, after a
few more BAs the keyframes centimetres (`utils/rounding.py`, ROADMAP queue 3
A6). The amplifier is the Schur complement: with the landmarks shared by
the fixed keyframes, S = Hpp - W V^-1 W^T is a small difference of large
terms, and float32 assembles it a few percent off. The problem below is that
window's shape. Its newest pose moved by one ulp (numpy.nextafter), the
reference's solve (JAX, float32, as `pli_slam_tpu.solve.ba.solve_ba` runs on
the CPU) and the port's with the reduced system in float32 (the CPU's
default, the reference's arithmetic) move the keyframe by AMPLIFIED and more;
the port's in float64 (the default on CUDA, `ba.reduced_dtype`) by at most
ROUNDED_MOVE, the state's own float32 rounding. A recorded divergence:
ROADMAP queue 3 C. The float64 path is held against the reference on
test_torch_solve's well-conditioned problem (poses at that file's parity
tolerances; landmarks and cost no farther from a float64 solve than the
reference's), and on this window against a float64 solve: the port with
every float of the problem in float64.
"""

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.solve import ba as jba
from pli_slam_tpu.utils.config import OptimizerConfig
from pli_slam_tpu_torch.solve import ba as tba
from test_torch_solve import CAM_ARGS, JC, TC, T, _ba_problem, _topt

torch.set_num_threads(1)
W, N_FIXED, P, L = 3, 2, 600, 12
SEEDS = (0, 1)
# Over seeds 0-7 the reference moves the keyframe 5.9e-7 to 1.6e-2 m (more than AMPLIFIED in 7), the port's
# float32 solve 8.9e-8 to 8.1e-4 m (in 6), its float64 solve at most 3.8e-7 m; the float32 assembly is off by
# 6.7e-4 to 5.8e-2 (more than S_F32_OFF in 7). Seeds 3 and 7 hardly amplify; SEEDS are the first two.
AMPLIFIED = 1e-5  # m: the least the float32 solves move the keyframe
ROUNDED_MOVE = 1e-6  # m: the most the float64 solve moves it
# Over seeds 0-7 the float64 path's keyframes lie at most 4.2e-7 m from the float64 solve's, the reference's
# 1.7e-7 to 1.6e-2 m. On test_torch_solve's problem (seeds 0-2, 4) its poses lie within 7.3e-6 of the
# reference's, its landmarks within 1.7e-4 of the float64 solve's (the reference's 1.9e-3 to 2.8e-2).
S_F32_OFF = 1e-3  # the float32 assembly's least error in the equilibrated system


def _project(x: np.ndarray) -> np.ndarray:
    """Pinhole pixels (u, v) of camera-frame points [n, 3] (the cameras' CAM_ARGS)."""
    return np.stack([CAM_ARGS["fx"] * x[:, 0] / x[:, 2] + CAM_ARGS["cx"],
                     CAM_ARGS["fy"] * x[:, 1] / x[:, 2] + CAM_ARGS["cy"]], -1)


def _rotation(w: np.ndarray) -> np.ndarray:
    """exp of the rotation vector `w` (Rodrigues)."""
    a = np.linalg.norm(w)
    k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]) / a
    return np.eye(3) + np.sin(a) * k + (1.0 - np.cos(a)) * k @ k


def window_problem(rng) -> dict:
    """A first windowed BA: W keyframes 0.2 m apart along x, the N_FIXED
    oldest fixed, the newest 0.005 rad / m off; P points 3-40 m deep, seen
    by every keyframe (20% of the slots empty), stereo where nearer than
    6 m; L lines; 0.7 px of noise."""
    pts = np.stack([rng.uniform(-8, 8, P), rng.uniform(-4, 4, P), rng.uniform(3, 40, P)], -1).astype(np.float32)
    xs = np.stack([rng.uniform(-3, 4, L), rng.uniform(-2, 2, L), rng.uniform(4, 12, L)], -1).astype(np.float32)
    d = rng.normal(size=(L, 3)).astype(np.float32)
    xe = xs + d / np.linalg.norm(d, axis=-1, keepdims=True) * 1.2
    t_true = np.array([[-0.2 * w, 0.03 * w, -0.05 * w] for w in range(W)], np.float32)
    po_uvr, lo_l = [], []
    for w in range(W):
        xc, sc, ec = pts + t_true[w], xs + t_true[w], xe + t_true[w]
        uv = _project(xc)
        uvr = np.concatenate([uv, uv[:, :1] - CAM_ARGS["bf"] / xc[:, 2:]], -1)
        po_uvr.append(uvr + rng.normal(size=uvr.shape) * 0.7)
        hom = [np.concatenate([_project(x), np.ones((L, 1))], -1) for x in (sc, ec)]
        line = np.cross(*hom)
        lo_l.append(line / np.linalg.norm(line[:, :2], axis=-1, keepdims=True))
    R0, t0 = np.stack([np.eye(3, dtype=np.float32)] * W), t_true.copy()
    for w in range(N_FIXED, W):
        dR = _rotation(rng.normal(size=3) * 0.005)
        R0[w], t0[w] = dR, dR @ t0[w] + rng.normal(size=3) * 0.005
    po_pt = np.tile(np.arange(P, dtype=np.int32), W)
    po_pt[rng.random(W * P) < 0.2] = -1
    return dict(
        R=R0, t=t0, pose_mask=np.ones(W, bool), fixed_mask=np.arange(W) < N_FIXED,
        pts=pts + rng.normal(size=pts.shape).astype(np.float32) * 0.03, pt_mask=np.ones(P, bool),
        lns=np.concatenate([xs, xe], -1) + rng.normal(size=(L, 6)).astype(np.float32) * 0.05,
        ln_mask=np.ones(L, bool), po_pose=np.repeat(np.arange(W, dtype=np.int32), P), po_pt=po_pt,
        po_uvr=np.concatenate(po_uvr).astype(np.float32), po_stereo=np.tile(pts[:, 2], W) < 6.0,
        po_sigma2=np.ones(W * P, np.float32), po_mask=np.ones(W * P, bool),
        lo_pose=np.repeat(np.arange(W, dtype=np.int32), L), lo_ln=np.tile(np.arange(L, dtype=np.int32), W),
        lo_l=np.concatenate(lo_l).astype(np.float32), lo_sigma2=np.full(W * L, 4.0, np.float32),
        lo_mask=np.ones(W * L, bool))


def one_ulp(prob: dict) -> dict:
    """The newest keyframe's rotation, every entry one float32 ulp toward zero."""
    R = prob["R"].copy()
    R[-1] = np.nextafter(R[-1], np.float32(0))
    return {**prob, "R": R}


def centres(R, t) -> np.ndarray:
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return -np.einsum("wji,wj->wi", R, t)


def moved(res_a, res_b) -> float:
    """The largest keyframe-centre distance, m, between two solves' results."""
    return float(np.abs(centres(res_a.R, res_a.t) - centres(res_b.R, res_b.t)).max())


def torch_problem(prob: dict) -> tba.BAProblem:
    return tba.BAProblem(**{k: T(v) for k, v in prob.items()})


@pytest.fixture(scope="module")
def cases():
    return [window_problem(np.random.default_rng(seed)) for seed in SEEDS]


def test_reduced_dtype_is_float64_on_cuda_only():
    assert tba.reduced_dtype("cuda") == torch.float64 and tba.reduced_dtype(torch.device("cuda", 0)) == torch.float64
    assert tba.reduced_dtype("cpu") == torch.float32


def float64_problem(prob: dict) -> tba.BAProblem:
    return tba.BAProblem(**{k: T(v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in prob.items()})


def farthest(res, ref, names) -> dict:
    """The largest absolute difference of each field in `names`."""
    return {f: float(np.abs(np.asarray(getattr(res, f), np.float64) - np.asarray(getattr(ref, f), np.float64)).max())
            for f in names}


def test_float64_solve_parity_on_the_well_conditioned_problem(monkeypatch):
    """test_torch_solve.test_ba_parity's problem through the port's solve_ba
    with the reduced system in float64 (CUDA's): R and t within that test's
    tolerances of the reference's; the landmarks and the cost no farther
    from a float64 solve than the reference's."""
    cfg = OptimizerConfig()
    prob = _ba_problem(np.random.default_rng(4))
    monkeypatch.setattr(tba, "reduced_dtype", lambda device: torch.float64)
    port = tba.solve_ba(TC, torch_problem(prob), _topt(cfg))
    r64 = tba.solve_ba(TC, float64_problem(prob), _topt(cfg))
    ref = jax.jit(lambda p: jba.solve_ba(JC, p, cfg))(jba.BAProblem(**prob))
    np.testing.assert_allclose(port.R.numpy(), np.asarray(ref.R), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.t.numpy(), np.asarray(ref.t), rtol=1e-4, atol=1e-4)
    names = ("pts", "lns", "cost")
    port_off, ref_off = farthest(port, r64, names), farthest(ref, r64, names)
    assert all(port_off[f] <= ref_off[f] for f in names), (port_off, ref_off)


def test_window_solve_no_farther_from_float64_than_the_reference(cases, monkeypatch):
    """Each case through the port's solve_ba with the reduced system in
    float64, the reference's, and the port's with every float of the
    problem in float64: the port's keyframes lie within ROUNDED_MOVE of the
    float64 solve's, and no farther than the reference's."""
    cfg = OptimizerConfig()
    monkeypatch.setattr(tba, "reduced_dtype", lambda device: torch.float64)
    jsolve = jax.jit(lambda p: jba.solve_ba(JC, p, cfg))
    for seed, prob in zip(SEEDS, cases):
        r64 = tba.solve_ba(TC, float64_problem(prob), _topt(cfg))
        assert r64.R.dtype == torch.float64
        port = moved(tba.solve_ba(TC, torch_problem(prob), _topt(cfg)), r64)
        ref = moved(jsolve(jba.BAProblem(**prob)), r64)
        assert port <= ROUNDED_MOVE and port <= ref, (seed, port, ref)


def test_float32_assembly_of_the_window_is_off(cases):
    """The equilibrated reduced system of the newest keyframe, assembled in
    float32 (the reference's and the CPU's) against float64 from the same
    linearization: off by S_F32_OFF and more."""
    cfg = _topt(OptimizerConfig())
    lam = torch.tensor(cfg.damping_init)
    for prob in cases:
        tp = torch_problem(prob)
        ip, il = tba.prepare_indices(tp)
        eq = {}
        for dt in (torch.float32, torch.float64):
            S = tba.assemble_visual(TC, tp, ip, il, tp.R, tp.t, tp.pts, tp.lns, cfg, lam, dt)[0][-1, -1].double()
            d = 1.0 / torch.sqrt(torch.diagonal(S))
            eq[dt] = S * d[:, None] * d[None, :]
        assert (eq[torch.float32] - eq[torch.float64]).abs().max() > S_F32_OFF


def test_one_ulp_moves_the_float32_solves_not_the_float64_one(cases, capsys, monkeypatch):
    """Each case and its one-ulp twin through the reference's solve_ba and
    the port's with the reduced system in float32 (the CPU's) and in
    float64 (CUDA's, `reduced_dtype` set so here): the first two move the
    newest keyframe by AMPLIFIED and more, the float64 one by at most
    ROUNDED_MOVE."""
    cfg = OptimizerConfig()
    jsolve = jax.jit(lambda p: jba.solve_ba(JC, p, cfg))

    def solve(dt, p):
        monkeypatch.setattr(tba, "reduced_dtype", lambda device: dt)
        return tba.solve_ba(TC, torch_problem(p), _topt(cfg))

    for seed, prob in zip(SEEDS, cases):
        pair = (prob, one_ulp(prob))
        ref = moved(*(jsolve(jba.BAProblem(**p)) for p in pair))
        port = {dt: moved(*(solve(dt, p) for p in pair)) for dt in (torch.float32, torch.float64)}
        with capsys.disabled():
            print(f"\none ulp, seed {seed}: the keyframe moved {ref:.3e} m (reference), {port[torch.float32]:.3e} m "
                  f"(port, float32), {port[torch.float64]:.3e} m (port, float64)")
        assert ref > AMPLIFIED and port[torch.float32] > AMPLIFIED, (seed, ref, port)
        assert port[torch.float64] <= ROUNDED_MOVE, (seed, port)
