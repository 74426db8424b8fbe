"""The closest-rotation and Horn eigenvector kernels' methods on the CPU.

`csrc/rot3.cu` (the closest rotation, a thread a matrix, in float64: the
Newton-Schulz polar iteration for near rotations, one-sided Jacobi for
every other matrix) and
`csrc/eig4.cu` (the largest eigenpair of a symmetric 4x4: round-robin
Jacobi in float64, four lanes a matrix) are built here as plain C++ (no
__CUDACC__, contraction into fused multiply-adds off) and held bit for bit
against numpy transcriptions of their methods (`rot3_method`,
`eig4_method`, in the kernels' order and precision; test_torch_graph_step,
test_torch_stages and test_torch_rare_stages import them); the
transcriptions are held against the twins (`torch.linalg.svd` + det,
`torch.linalg.eigh`) and float64 on the main path's matrices (formed on
the CPU as chip_smoke.py forms them on the card), exact rotations, the
identity, det < 0, rank one and zero, both sides of rot3's gate between its
branches (and 1e-5 from its edge), and Horn matrices with repeated top eigenvalues. The card's builds differ from
the host's in the last bits (fused multiply-adds, eig4's refined roots);
chip_smoke.py phases 3b and 3c hold them against their twins and float64
on the H100, and the `cuda` test below does where a card is.
"""

import ctypes
import math
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pli_slam_tpu_torch.ops.kernels import eig4, rot3

torch.set_num_threads(1)
EPS = 2.220446049250313e-16
TINY = 2.2250738585072014e-308


# ---------------------------------------------------------------------------
# csrc/jacobi.cuh on a host, transcribed
# ---------------------------------------------------------------------------


def _inv_root(x: float) -> float:
    """1.0 / sqrt(x) as C computes it (inf at 0, NaN below)."""
    if x > 0.0 or x != x:
        return 1.0 / math.sqrt(x)
    return math.copysign(math.inf, x) if x == 0.0 else math.nan


def _fmin(a: float, b: float) -> float:
    """C's fmin: the other argument where one is NaN."""
    if a != a:
        return b
    if b != b:
        return a
    return min(a, b)


def _plane_rotation(alpha, beta, gamma):
    """jacobi::plane_rotation: (cs, sn, x, hr)."""
    d, g = beta - alpha, 2.0 * gamma
    x = d * d + g * g
    h = x * _inv_root(x)
    D = abs(d) + h
    r = _inv_root(2.0 * h * D)
    return D * r, (g if d >= 0.0 else -g) * r, x, 2.0 * h * r


def _one_sided_rotation(alpha, beta, gamma, tol2):
    """jacobi::rotation: (rotates?, cs, sn)."""
    c, t, x, _ = _plane_rotation(alpha, beta, gamma)
    ok = (gamma * gamma > tol2 * alpha * beta and _fmin(_fmin(alpha, beta), _fmin(abs(gamma), x)) >= TINY
          and abs(t) >= TINY)
    return ok, (c if ok else 1.0), (t if ok else 0.0)


# ---------------------------------------------------------------------------
# csrc/rot3.cu, transcribed
# ---------------------------------------------------------------------------

F = np.float32
ROT3_POLAR_ITERS, ROT3_POLAR_TOL, ROT3_POLAR_LAST, ROT3_DISC, ROT3_SWEEPS64, ROT3_RANK = 8, 1e-13, 1e-6, 0.24, 16, 1e-24


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _swap_neg(c, v, i, j):
    c[i], c[j] = c[j], [-t for t in c[i]]
    v[i], v[j] = v[j], [-t for t in v[i]]


def _positive_definite(a, b, c, d, e, f):
    """rot3::positive_definite: Sylvester's test of [[a, b, c], [b, d, e], [c, e, f]]."""
    return a > 0.0 and a * d - b * b > 0.0 and a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c) > 0.0


def _gram_defect(x):
    """rot3::gram_defect: X^T X - I of the row-major x [9] as (e00, e01, e02, e11, e12, e22)."""
    return [x[0] * x[0] + x[3] * x[3] + x[6] * x[6] - 1.0, x[0] * x[1] + x[3] * x[4] + x[6] * x[7],
            x[0] * x[2] + x[3] * x[5] + x[6] * x[8], x[1] * x[1] + x[4] * x[4] + x[7] * x[7] - 1.0,
            x[1] * x[2] + x[4] * x[5] + x[7] * x[8], x[2] * x[2] + x[5] * x[5] + x[8] * x[8] - 1.0]


def _rot3_near(x, e):
    """rot3::closest's gate on the float64 x [9] and its Gram defect e: det
    > 0 and every eigenvalue of I + e in (0.75, 1.25) (Gershgorin's discs,
    else the minors)."""
    det = (x[0] * (x[4] * x[8] - x[5] * x[7]) - x[1] * (x[3] * x[8] - x[5] * x[6])
           + x[2] * (x[3] * x[7] - x[4] * x[6]))
    if not det > 0.0:
        return False
    r = (abs(e[0]) + abs(e[1]) + abs(e[2]), abs(e[1]) + abs(e[3]) + abs(e[4]), abs(e[2]) + abs(e[4]) + abs(e[5]))
    if all(ri < ROT3_DISC for ri in r):
        return True
    m = [e[0] + 1.0, e[1], e[2], e[3] + 1.0, e[4], e[5] + 1.0]
    hi, lo = 1.25, 0.75
    return (_positive_definite(hi - m[0], -m[1], -m[2], hi - m[3], -m[4], hi - m[5])
            and _positive_definite(m[0] - lo, m[1], m[2], m[3] - lo, m[4], m[5] - lo))


def _rot3_polar(x, e):
    """rot3::polar: the Newton-Schulz iteration X <- X - X E / 2, E = X^T X
    - I, in float64 from the row-major x [9] and its Gram defect e: (R rows
    before the store's rounding, the steps)."""
    x, k = list(x), 0
    while True:
        err = max(abs(t) for t in e)
        if not err > ROT3_POLAR_TOL or k == ROT3_POLAR_ITERS:
            break
        for r in range(3):
            x0, x1, x2 = x[3 * r:3 * r + 3]
            x[3 * r] = x0 - 0.5 * (x0 * e[0] + x1 * e[1] + x2 * e[2])
            x[3 * r + 1] = x1 - 0.5 * (x0 * e[1] + x1 * e[3] + x2 * e[4])
            x[3 * r + 2] = x2 - 0.5 * (x0 * e[2] + x1 * e[4] + x2 * e[5])
        k += 1
        if err < ROT3_POLAR_LAST:
            break
        e = _gram_defect(x)
    return [x[0:3], x[3:6], x[6:9]], k


def _rot3_f64(m):
    """rot3::closest_f64 on one float32 matrix [3, 3], in float64: (R rows
    before the store's rounding, the sweeps)."""
    c = [[float(m[r, j]) for r in range(3)] for j in range(3)]
    v = [[1.0 if r == j else 0.0 for r in range(3)] for j in range(3)]
    tol2 = 3.0 * EPS * EPS
    for s in range(ROT3_SWEEPS64):
        rotated = False
        for p, q in ((0, 1), (0, 2), (1, 2)):
            ok, cs, sn = _one_sided_rotation(_dot3(c[p], c[p]), _dot3(c[q], c[q]), _dot3(c[p], c[q]), tol2)
            if not ok:
                continue
            rotated = True
            c[p], c[q] = [cs * x - sn * y for x, y in zip(c[p], c[q])], [sn * x + cs * y for x, y in zip(c[p], c[q])]
            v[p], v[q] = [cs * x - sn * y for x, y in zip(v[p], v[q])], [sn * x + cs * y for x, y in zip(v[p], v[q])]
        if not rotated:
            break
    else:
        s = ROT3_SWEEPS64
    n = [_dot3(col, col) for col in c]
    for i, j in ((0, 1), (0, 2), (1, 2)):
        if n[i] < n[j]:
            _swap_neg(c, v, i, j)
            n[i], n[j] = n[j], n[i]
    if n[0] > 0.0:
        inv = _inv_root(n[0])
        u0 = [x * inv for x in c[0]]
    else:
        u0 = [1.0, 0.0, 0.0]
    d01 = _dot3(u0, c[1])
    w = [c[1][r] - d01 * u0[r] for r in range(3)]
    wn = _dot3(w, w)
    if not wn > ROT3_RANK * (n[0] if n[0] > 0.0 else 1.0):
        e = [1.0, 0.0, 0.0] if abs(u0[0]) < 0.9 else [0.0, 1.0, 0.0]
        d = _dot3(u0, e)
        w = [e[r] - d * u0[r] for r in range(3)]
        wn = _dot3(w, w)
    winv = _inv_root(wn)
    u1 = [x * winv for x in w]
    u2 = [u0[1] * u1[2] - u0[2] * u1[1], u0[2] * u1[0] - u0[0] * u1[2], u0[0] * u1[1] - u0[1] * u1[0]]
    u = (u0, u1, u2)
    return [[u[0][r] * v[0][col] + u[1][r] * v[1][col] + u[2][r] * v[2][col] for col in range(3)]
            for r in range(3)], s


def rot3_method(M: np.ndarray):
    """csrc/rot3.cu's arithmetic on float32 matrices [n, 3, 3]: (R [n, 3, 3]
    float32, the kernel's `sweeps` output [n]: the polar iteration's steps
    (>= 0) for a near rotation, else -1 - the float64 Jacobi branch's
    sweeps)."""
    M = np.asarray(M, np.float32).reshape(-1, 3, 3)
    out, sweeps = np.empty_like(M), np.empty(len(M), np.int32)
    with np.errstate(all="ignore"):
        for i, m in enumerate(M):
            x = [float(t) for t in m.reshape(9)]
            e = _gram_defect(x)
            if _rot3_near(x, e):
                R, sweeps[i] = _rot3_polar(x, e)
            else:
                R, s = _rot3_f64(m)
                sweeps[i] = -1 - s
            out[i] = np.asarray(R, np.float64).astype(np.float32)
    return out, sweeps


# ---------------------------------------------------------------------------
# csrc/eig4.cu, transcribed
# ---------------------------------------------------------------------------

EIG4_SWEEPS, EIG4_TOL = 16, 1e-15


def _pair_rotation(app, aqq, apq, tol):
    """eig4::pair_rotation: (cs, sn, tq, ok)."""
    c, s, _, hr = _plane_rotation(app, aqq, apq)
    ok = abs(apq) > tol
    return (c, s, s * hr * apq, True) if ok else (1.0, 0.0, 0.0, False)


def _eig4_one(m):
    """eig4_host on one float32 matrix [4, 4]: (vec [4] float32, val float32, sweeps)."""
    a, fro = [[0.0] * 4 for _ in range(4)], 0.0
    for i in range(4):
        for j in range(i, 4):
            a[i][j] = float(m[j, i])  # the lower triangle
            fro += (1.0 if i == j else 2.0) * (a[i][j] * a[i][j])
    tol = EIG4_TOL * math.sqrt(fro)
    v = [[1.0 if c == i else 0.0 for c in range(4)] for i in range(4)]
    steps = eig4.schedule()
    off = [(p, q) for p in range(4) for q in range(p + 1, 4)]
    s = None
    for sweep in range(EIG4_SWEEPS):
        for j, ((p1, q1), (p2, q2)) in enumerate(steps):
            if all(not abs(a[p][q]) > tol for p, q in off):  # converged: no pair would rotate
                s = sweep if j == 0 else sweep + 1
                break
            c1, s1, t1, ok1 = _pair_rotation(a[p1][p1], a[q1][q1], a[p1][q1], tol)
            c2, s2, t2, ok2 = _pair_rotation(a[p2][p2], a[q2][q2], a[p2][q2], tol)
            up = (lambda i, j: (i, j) if i <= j else (j, i))
            (i00, j00), (i01, j01), (i10, j10), (i11, j11) = up(p1, p2), up(p1, q2), up(q1, p2), up(q1, q2)
            b00, b01, b10, b11 = a[i00][j00], a[i01][j01], a[i10][j10], a[i11][j11]
            x00, x01 = c2 * b00 - s2 * b01, s2 * b00 + c2 * b01
            x10, x11 = c2 * b10 - s2 * b11, s2 * b10 + c2 * b11
            a[i00][j00], a[i10][j10] = c1 * x00 - s1 * x10, s1 * x00 + c1 * x10
            a[i01][j01], a[i11][j11] = c1 * x01 - s1 * x11, s1 * x01 + c1 * x11
            a[p1][p1] -= t1
            a[q1][q1] += t1
            a[p1][q1] = 0.0 if ok1 else a[p1][q1]
            a[p2][p2] -= t2
            a[q2][q2] += t2
            a[p2][q2] = 0.0 if ok2 else a[p2][q2]
            for row in v:
                g, h = row[p1], row[q1]
                row[p1], row[q1] = c1 * g - s1 * h, s1 * g + c1 * h
                g, h = row[p2], row[q2]
                row[p2], row[q2] = c2 * g - s2 * h, s2 * g + c2 * h
        if s is not None:
            break
    else:
        s = EIG4_SWEEPS
    k, best = 0, a[0][0]
    for i in range(1, 4):
        if a[i][i] >= best:
            k, best = i, a[i][i]
    col = [row[k] for row in v]
    inv = _inv_root((col[0] * col[0] + col[1] * col[1]) + (col[2] * col[2] + col[3] * col[3]))
    return np.asarray([t * inv for t in col], np.float64).astype(np.float32), np.float32(best), s


def eig4_method(N: np.ndarray):
    """csrc/eig4.cu's arithmetic on float32 symmetric matrices [n, 4, 4]
    (their lower triangles): (unit vectors [n, 4] float32, largest
    eigenvalues [n] float32, sweeps [n])."""
    N = np.asarray(N, np.float32).reshape(-1, 4, 4)
    vec, val, sweeps = np.empty((len(N), 4), np.float32), np.empty(len(N), np.float32), np.empty(len(N), np.int32)
    for i, m in enumerate(N):
        vec[i], val[i], sweeps[i] = _eig4_one(m)
    return vec, val, sweeps


# ---------------------------------------------------------------------------
# The sources built for the host
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """csrc/rot3.cu and csrc/eig4.cu built as plain C++ (no __CUDACC__),
    contraction into fused multiply-adds off so that their float operations
    are numpy's and Python's: {"rot3": M -> (R, sweeps), "eig4": N -> (vec,
    val, sweeps)}."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    assert cxx, "no C++ compiler (g++ / c++) to build the kernels' sources for the host"
    out = tmp_path_factory.mktemp("small_kernels_host")
    libs = {}
    for name, src in (("rot3", rot3._SRC), ("eig4", eig4._SRC)):
        cpp, so = out / f"{name}_host.cpp", out / f"lib{name}_host.so"
        cpp.write_text(f'#include "{Path(src)}"\n')
        subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so),
                        str(cpp)], check=True, capture_output=True, timeout=30)
        libs[name] = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs["rot3"].rot3_host.argtypes = [vp, vp, ci, vp]
    libs["eig4"].eig4_host.argtypes = [vp, vp, vp, ci, vp]

    def closest(M):
        M = np.ascontiguousarray(M, np.float32)
        out, codes = np.empty_like(M), np.empty(len(M), np.int32)
        assert libs["rot3"].rot3_host(M.ctypes.data, out.ctypes.data, len(M), codes.ctypes.data) == 0
        return out, codes

    def largest(N):
        N = np.ascontiguousarray(N, np.float32)
        vec, val, sweeps = np.empty((len(N), 4), np.float32), np.empty(len(N), np.float32), np.empty(len(N), np.int32)
        assert libs["eig4"].eig4_host(N.ctypes.data, vec.ctypes.data, val.ctypes.data, len(N),
                                      sweeps.ctypes.data) == 0
        return vec, val, sweeps

    return {"rot3": closest, "eig4": largest}


# ---------------------------------------------------------------------------
# The inputs
# ---------------------------------------------------------------------------


def _closest_f64(M: np.ndarray) -> np.ndarray:
    """U diag(1, 1, sign det(U V^T)) V^T in float64 (numpy's LAPACK SVD)."""
    u, _, vt = np.linalg.svd(np.asarray(M, np.float64))
    u[..., :, 2] *= np.sign(np.linalg.det(u @ vt))[..., None]
    return u @ vt


def _rotations(rng, n) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1).reshape(n, 3, 3)


def _gate_matrices(rng, defect) -> np.ndarray:
    """Matrices Q diag(s) W^T with det > 0 and one squared singular value
    1 +- defect, the others within it (in float64, before float32 rounding)."""
    Q, W = _rotations(rng, 32), _rotations(rng, 32)
    d = rng.uniform(-defect, defect, size=(32, 3))  # the singular values' s^2 - 1
    d[np.arange(32), rng.integers(0, 3, 32)] = defect * rng.choice([-1.0, 1.0], 32)
    return (Q * np.sqrt(1.0 + d)[:, None, :]) @ W.transpose(0, 2, 1)


def rot3_cases() -> dict:
    """Name -> float32 matrices [n, 3, 3]."""
    import chip_smoke

    rng = np.random.default_rng(31)
    main = chip_smoke.rot3_main_path_matrices(torch.device("cpu"), torch.Generator().manual_seed(31), n=128).numpy()
    perm = np.array([[[0, -1, 0], [1, 0, 0], [0, 0, 1]], [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
                     [[-1, 0, 0], [0, -1, 0], [0, 0, 1]]], np.float32)
    a, b = rng.integers(-3, 4, size=(2, 24, 3)).astype(np.float32)
    a[:, 0] = b[:, 0] = 1.0
    general = rng.normal(size=(48, 3, 3))
    return {
        "main_path": main,
        "exact_rotations": np.concatenate([np.eye(3, dtype=np.float32)[None], perm,
                                           _rotations(rng, 60).astype(np.float32)]),
        "general": general.astype(np.float32),
        "det_negative": np.concatenate([-_rotations(rng, 16),  # every singular value 1: no unique answer
                                        (_rotations(rng, 16) * np.array([1.5, 1.0, -0.5])) @ _rotations(rng, 16),
                                        general * np.sign(np.linalg.det(general))[:, None, None]
                                        * np.array([1, 1, -1])]).astype(np.float32),
        "rank_one_and_zero": np.concatenate([a[:, :, None] * b[:, None, :], np.zeros((2, 3, 3))]).astype(np.float32),
        "gate_below": _gate_matrices(rng, 0.249).astype(np.float32),
        "gate_above": _gate_matrices(rng, 0.251).astype(np.float32),  # (0.75, 1.25): the kernel's gate
        "gate_edge": np.concatenate([_gate_matrices(rng, 0.25 - 1e-5),
                                     _gate_matrices(rng, 0.25 + 1e-5)]).astype(np.float32),
    }


def horn_cases() -> dict:
    """Name -> float32 symmetric matrices [n, 4, 4]: Horn's as the main path
    forms them (chip_smoke.horn_cases on the CPU), general symmetric ones, and
    ones whose largest eigenvalue is repeated."""
    import chip_smoke

    main = {label: N.numpy() for label, N in chip_smoke.horn_cases(torch.device("cpu"),
                                                                   torch.Generator().manual_seed(12))}
    rng = np.random.default_rng(32)
    Q = np.linalg.qr(rng.normal(size=(24, 4, 4)))[0]
    top = rng.integers(1, 5, size=(24, 1)).astype(np.float64)
    lam = np.concatenate([top, top, top - 1.5, -top], 1)  # the largest twice
    repeated = np.concatenate([(Q * lam[:, None, :]) @ Q.transpose(0, 2, 1),
                               np.diag([3.0, 3.0, 1.0, 0.0])[None], np.diag([2.0, 0.0, 2.0, 2.0])[None],
                               np.eye(4)[None], np.zeros((1, 4, 4))])
    repeated = (repeated + repeated.transpose(0, 2, 1)) / 2
    return {"pnp_hypotheses": main["pnp_hypotheses"][:96], "refit": main["refit"], "general": main["general"][:96],
            "repeated_top": repeated.astype(np.float32)}


# ---------------------------------------------------------------------------
# rot3
# ---------------------------------------------------------------------------

ROT3_CASES = ("main_path", "exact_rotations", "general", "det_negative", "rank_one_and_zero", "gate_below",
              "gate_above", "gate_edge")
NEAR_ROTATIONS = ("main_path", "exact_rotations", "gate_below")  # the polar branch's cases


@pytest.fixture(scope="module")
def rot3_inputs():
    return rot3_cases()


@pytest.mark.parametrize("case", ROT3_CASES)
def test_rot3_source_on_the_host_equals_the_method(host, rot3_inputs, case):
    """The kernel's source, compiled for the host, equals the numpy method
    bit for bit: the rotations and each matrix's branch and sweeps."""
    M = rot3_inputs[case]
    got, want = host["rot3"](M), rot3_method(M)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize("case", ROT3_CASES)
def test_rot3_method_against_float64_and_the_twin(rot3_inputs, case, capsys):
    """Each case's branch (the polar iteration for near rotations, Jacobi
    for the rest: det > 0 and every eigenvalue of M^T M in (0.75, 1.25), as
    numpy's float64 eigenvalues say); the result a proper rotation no
    farther from M than the float64 closest rotation (to float32), whether
    or not that is unique; where it is unique, its distance from it and the
    twin's (torch.linalg.svd + det in float32), printed, the method's no
    larger (ROADMAP queue 3 A4) and within 6e-8 (the float64 answer rounded
    once) on both branches. Rank one: R takes the row space's direction to
    the column space's."""
    M = rot3_inputs[case]
    R, sweeps = rot3_method(M)
    M64 = M.astype(np.float64)
    lam = np.linalg.eigvalsh(M64.transpose(0, 2, 1) @ M64)
    near = (np.linalg.det(M64) > 0) & (lam.min(1) > 0.75) & (lam.max(1) < 1.25)
    assert np.array_equal(sweeps >= 0, near), (sweeps, lam)
    if case in NEAR_ROTATIONS:
        assert near.all()
    elif case != "gate_edge":
        assert not near.any()
    else:
        assert 0 < near.sum() < len(M)
    R64 = R.astype(np.float64)
    assert np.abs(R64 @ R64.transpose(0, 2, 1) - np.eye(3)).max() < 1e-6
    assert np.abs(np.linalg.det(R64) - 1.0).max() < 1e-6
    exact = _closest_f64(M)
    dist = lambda R_: np.linalg.norm(R_ - M64, axis=(1, 2))  # noqa: E731
    assert (dist(R64) <= dist(exact) + 1e-6).all()
    if case == "rank_one_and_zero":
        a = M[:24, :, 0] / np.linalg.norm(M[:24, :, 0], axis=1, keepdims=True)
        b = M[:24, 0, :] / np.linalg.norm(M[:24, 0, :], axis=1, keepdims=True)
        assert np.abs(np.einsum("nij,nj->ni", R64[:24], b) - a).max() < 1e-6
        return
    s = np.linalg.svd(M64, compute_uv=False)
    det = np.linalg.det(M64)
    unique = np.where(det > 0, s[:, 1] + s[:, 2], s[:, 1] - s[:, 2]) > 1e-2 * s[:, 0]
    assert unique.mean() >= 0.75
    twin = rot3.closest_rotation(torch.as_tensor(M)).numpy().astype(np.float64)  # the CPU runs the twin
    e_m, e_t = (np.abs(x - exact)[unique].max() for x in (R64, twin))
    with capsys.disabled():
        print(f"\nrot3 {case} ({unique.sum()} of {len(M)} with a unique answer, branch and work "
              f"{sorted(set(sweeps.tolist()))}): max |R - R_float64| method {e_m:.3e}, twin {e_t:.3e}")
    assert e_m <= e_t, (e_m, e_t)
    assert e_m <= 6e-8, e_m


# ---------------------------------------------------------------------------
# eig4
# ---------------------------------------------------------------------------

HORN_CASES = ("pnp_hypotheses", "refit", "general", "repeated_top")


@pytest.fixture(scope="module")
def horn_inputs():
    return horn_cases()


def test_eig4_schedule_visits_every_pair_once_a_sweep():
    """`eig4.schedule`, the order the method and the kernel's `pairs` take:
    three steps of two disjoint pairs, every pair of the four indices once."""
    steps = eig4.schedule()
    assert len(steps) == 3 and all(len(pairs) == 2 for pairs in steps)
    for pairs in steps:
        cols = [c for pair in pairs for c in pair]
        assert sorted(cols) == [0, 1, 2, 3] and all(p < q for p, q in pairs)
    assert sorted(pair for pairs in steps for pair in pairs) == [(p, q) for p in range(4) for q in range(p + 1, 4)]


@pytest.mark.parametrize("case", HORN_CASES)
def test_eig4_source_on_the_host_equals_the_method(host, horn_inputs, case):
    """The kernel's source, compiled for the host, equals the numpy method
    bit for bit: vectors, eigenvalues and sweeps."""
    N = horn_inputs[case]
    for got, want in zip(host["eig4"](N), eig4_method(N), strict=True):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _sign_free(a, b):
    return np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))


@pytest.mark.parametrize("case", HORN_CASES)
def test_eig4_method_against_float64_and_the_twin(horn_inputs, case, capsys):
    """Where the largest eigenvalue is simple: the method's unit vector
    within 5e-8 of the float64 eigenvector (sign-free) and no farther than
    eigh's in float32, within 1e-4 of the twin in rotation; the eigenvalue to
    float32. Where it is repeated: a unit vector of the top eigenspace, and
    the tie rule (the last of equal diagonal entries) on diagonal matrices."""
    N = horn_inputs[case]
    vec, val, sweeps = eig4_method(N)
    w, V = np.linalg.eigh(N.astype(np.float64))
    scale = np.maximum(np.abs(w).max(1), 1e-30)
    assert np.allclose(np.linalg.norm(vec.astype(np.float64), axis=1), 1.0, atol=1e-6)
    assert np.abs(val - w[:, 3]).max() <= 1e-6 * scale.max() and sweeps.max() <= 8, sweeps.max()
    resid = np.abs(np.einsum("nij,nj->ni", N.astype(np.float64), vec) - w[:, 3:] * vec).max(1) / scale
    assert resid.max() < 1e-6, resid.max()
    simple = (w[:, 3] - w[:, 2]) > 1e-2 * scale
    if case == "repeated_top":
        assert not simple.any()
        diag = np.array([np.array_equal(n, np.diag(np.diag(n))) and n.any() for n in N])
        last = np.array([3 - int(np.argmax(np.diag(n)[::-1])) for n in N])
        assert np.array_equal(np.abs(vec[diag]), np.eye(4, dtype=np.float32)[last[diag]])
        return
    assert simple.mean() >= 0.9
    twin = eig4.largest_eigvec(torch.as_tensor(N)).numpy()  # the CPU runs the twin
    e_m, e_t = _sign_free(vec, V[:, :, 3])[simple].max(), _sign_free(twin, V[:, :, 3])[simple].max()
    d_rot = _sign_free(vec, twin)[simple].max()
    with capsys.disabled():
        print(f"\neig4 {case} ({simple.sum()} of {len(N)} simple, {sweeps.sum()} sweeps): max |q - q_float64| "
              f"method {e_m:.3e}, twin {e_t:.3e}; |q - q_twin| {d_rot:.3e}")
    assert e_m <= 5e-8 and e_m <= e_t, (e_m, e_t)
    assert d_rot <= 1e-4


# ---------------------------------------------------------------------------
# The build's report
# ---------------------------------------------------------------------------

# what nvcc -Xptxas -v printed for the two kernels and one svd_small instance (NVIDIA's nvcc for sm_90a)
PTXAS_TEXT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__aba8d571_7_rot3_cu_56c0ac6c11rot3_kernelEPKfPfiPi' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__aba8d571_7_rot3_cu_56c0ac6c11rot3_kernelEPKfPfiPi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__2d608247_12_svd_small_cu_5372efaf16svd_small_kernelILi12EEEvPKfPfS3_S3_iPi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__2d608247_12_svd_small_cu_5372efaf16svd_small_kernelILi12EEEvPKfPfS3_S3_iPi
    24 bytes stack frame, 50 bytes spill stores, 76 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 15552 bytes smem
"""


def test_ptxas_usage_reads_each_kernel():
    """`hamming.ptxas_usage`, which chip_smoke.py's phases 3b-3d fail on
    (a stack frame or a spill): each entry's registers, stack frame, spills
    and shared memory, and none for a kernel ptxas did not report."""
    from pli_slam_tpu_torch.ops.kernels import hamming

    (rot,) = hamming.ptxas_usage(PTXAS_TEXT, "rot3_kernel").values()
    assert {k: rot[k] for k in ("registers", "stack_frame", "spill_stores", "spill_loads", "smem")} == {
        "registers": 64, "stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "smem": 0}
    (svd,) = hamming.ptxas_usage(PTXAS_TEXT, "svd_small_kernel").values()
    assert (svd["registers"], svd["stack_frame"], svd["spill_stores"], svd["spill_loads"], svd["smem"]) == (
        40, 24, 50, 76, 15552)
    with pytest.raises(RuntimeError):
        hamming.ptxas_usage(PTXAS_TEXT, "eig4_kernel")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_eig4_kernel_equals_twin_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (chip_smoke.py phase 3c runs this on the H100)")
    N = torch.as_tensor(horn_cases()["pnp_hypotheses"]).cuda()
    w = torch.linalg.eigh(N.double())[0]
    simple = (w[:, 3] - w[:, 2]) > 1e-2 * w.abs().amax(1)
    got, want = eig4.largest_eigvec_cuda(N), eig4.largest_eigvec_reference(N)
    err = torch.minimum((got - want).abs().amax(1), (got + want).abs().amax(1))[simple]
    assert float(err.max()) <= 1e-4
