"""Gated Hamming matcher: the port's plain PyTorch version against the TPU
kernel `gated_match_pallas` run in Pallas interpret mode on the CPU.

idx, best and ok must be exactly equal: distances are integers/2 and the
gate is the same float32 expression (du*du + dv*dv <= r*r), so there is
no tolerance. The CUDA kernel itself runs only on the card; its test is
marked `cuda` and is exercised by chip_smoke.py on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pli_slam_tpu.ops import matching as jmatching
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu_torch.ops.kernels import hamming as tham

torch.set_num_threads(1)


def _planted(rng, n=64, p=256):
    """The case of test_pallas_hamming.make_case: noisy planted copies."""
    fdesc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    sdesc = rng.choice(np.array([-1, 1], np.int8), size=(p, 256))
    perm = rng.permutation(p)[:n]
    noisy = fdesc.copy()
    for i in range(n):
        noisy[i, rng.choice(256, size=6, replace=False)] *= -1
    sdesc[perm] = noisy
    fuv = rng.uniform(0, 500, size=(n, 2)).astype(np.float32)
    suv = rng.uniform(0, 500, size=(p, 2)).astype(np.float32)
    suv[perm] = fuv + (rng.normal(size=(n, 2)) * 2).astype(np.float32)
    return dict(fdesc=fdesc, fuv=fuv, fvalid=np.ones(n, bool), sdesc=sdesc, suv=suv, svalid=np.ones(p, bool))


def case_xla_reference(rng):
    return _planted(rng), dict(radius=15.0, max_dist=60.0, ratio=1.0)


def case_planted(rng):
    return _planted(rng), dict(radius=15.0, max_dist=30.0, ratio=1.0)


def case_ratio_cross_tile(rng):
    n, p = 8, 128
    fdesc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    sdesc = np.zeros((p, 256), np.int8)
    sdesc[3] = fdesc[0]
    near = fdesc[0].copy()
    near[rng.choice(256, size=4, replace=False)] *= -1
    sdesc[70] = near
    fvalid = np.zeros(n, bool)
    fvalid[0] = True
    svalid = np.zeros(p, bool)
    svalid[[3, 70]] = True
    return (dict(fdesc=fdesc, fuv=np.zeros((n, 2), np.float32), fvalid=fvalid, sdesc=sdesc,
                 suv=np.zeros((p, 2), np.float32), svalid=svalid),
            dict(radius=50.0, max_dist=60.0, ratio=0.6))


def case_on_radius(rng):
    """Store points exactly on (|d| = r) and just outside the radius."""
    d = _planted(rng)
    d["fuv"] = np.round(d["fuv"])
    d["suv"] = np.round(d["suv"])
    d["suv"][:32] = d["fuv"][0] + np.float32([9.0, 12.0])  # 81 + 144 = 225 = 15^2
    d["suv"][32:64] = d["fuv"][1] + np.float32([9.0, 12.5])
    d["sdesc"][:64] = d["fdesc"][:2].repeat(32, axis=0)
    return d, dict(radius=15.0, max_dist=60.0, ratio=1.0)


def case_duplicate_rows(rng):
    """Exact duplicate store rows: the lower row wins and, since
    second == best, the ratio test rejects the match."""
    d = _planted(rng)
    d["sdesc"][200:232] = d["sdesc"][10:42]
    d["suv"][200:232] = d["suv"][10:42]
    return d, dict(radius=15.0, max_dist=60.0, ratio=0.9)


def case_all_gated(rng):
    """Valid features with no store row inside the radius: idx -1, best 1e9."""
    d = _planted(rng)
    d["suv"] = d["suv"] + np.float32(1000.0)
    d["fvalid"][::3] = False
    return d, dict(radius=15.0, max_dist=60.0, ratio=1.0)


CASES = [case_xla_reference, case_planted, case_ratio_cross_tile, case_on_radius, case_duplicate_rows,
         case_all_gated]


def _torch_args(d):
    return [torch.as_tensor(d[k]) for k in ("fdesc", "fuv", "fvalid", "sdesc", "suv", "svalid")]


@pytest.mark.parametrize("make", CASES, ids=[c.__name__[5:] for c in CASES])
def test_plain_equals_pallas_interpret(make):
    d, kw = make(np.random.default_rng(42))
    jidx, jbest, jok = jham.gated_match_pallas(
        *[jnp.asarray(d[k]) for k in ("fdesc", "fuv", "fvalid", "sdesc", "suv", "svalid")],
        radius=kw["radius"], max_dist=kw["max_dist"], ratio=kw["ratio"], tile=64, interpret=True)
    tidx, tbest, tok = tham.gated_match(*_torch_args(d), kw["radius"], kw["max_dist"], kw["ratio"])
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tbest.numpy(), np.asarray(jbest))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_case_properties():
    """The special cases really exercise what they are named for."""
    rng = np.random.default_rng(42)
    d, kw = case_on_radius(rng)
    idx, _, ok = tham.gated_match(*_torch_args(d), kw["radius"], kw["max_dist"], kw["ratio"])
    assert int(idx[0]) == 0 and bool(ok[0])  # on the circle: inside
    assert int(idx[1]) != 32  # 0.5 px outside: gated
    d, kw = case_duplicate_rows(np.random.default_rng(42))
    idx, best, second = tham.gated_match_reference(*_torch_args(d), kw["radius"])
    dup = (idx >= 10) & (idx < 42)
    assert bool(dup.any()) and torch.equal(best[dup], second[dup])
    _, _, ok = tham.gated_match(*_torch_args(d), kw["radius"], kw["max_dist"], kw["ratio"])
    assert not bool(ok[dup].any())
    d, kw = case_all_gated(np.random.default_rng(42))
    idx, best, ok = tham.gated_match(*_torch_args(d), kw["radius"])
    assert bool((idx == -1).all()) and bool((best == 1e9).all()) and not bool(ok.any())


def test_ragged_store_against_dense_path():
    """P % tile != 0, which the Pallas kernel cannot take: the plain version
    is held against the JAX dense matcher (hamming_matrix + window_gate +
    match_nn) on the rows that dense path accepts."""
    d = _planted(np.random.default_rng(7), n=64, p=200)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    dist = jmatching.hamming_matrix(jd["fdesc"], jd["sdesc"])
    gate = jmatching.window_gate(jd["fuv"], jd["suv"], 15.0) & jd["svalid"][None, :]
    jidx, jbest, jok = jmatching.match_nn(dist, jd["fvalid"], jd["svalid"], gate, max_dist=60.0, ratio=0.9)
    tidx, tbest, tok = tham.gated_match(*_torch_args(d), 15.0, 60.0, 0.9)
    m = np.asarray(jok)
    assert m.sum() > 40
    np.testing.assert_array_equal(tok.numpy(), m)
    np.testing.assert_array_equal(tidx.numpy()[m], np.asarray(jidx)[m])
    np.testing.assert_array_equal(tbest.numpy()[m], np.asarray(jbest)[m])


def test_dispatch_and_validation():
    d, _ = case_planted(np.random.default_rng(1))
    args = _torch_args(d)
    tham.reset_launches()
    tham.gated_match(*args, 15.0)
    assert tham.launches == 0  # the CPU path runs the plain version and counts nothing
    with pytest.raises(TypeError):
        tham.gated_match(args[0].to(torch.int32), *args[1:], 15.0)
    with pytest.raises(ValueError):
        tham.gated_match(args[0][:, :128], *args[1:], 15.0)
    with pytest.raises(RuntimeError):
        tham.gated_match(*[a.to("meta") for a in args], 15.0)


@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode (chip_smoke.py runs this on the H100)")
    rng = np.random.default_rng(3)
    for make in CASES:
        d, kw = make(rng)
        args = [a.cuda() for a in _torch_args(d)]
        k = tham.gated_match_cuda(*args, kw["radius"])
        p = tham.gated_match_reference(*args, kw["radius"])
        for a, b in zip(k, p):
            assert torch.equal(a, b)
