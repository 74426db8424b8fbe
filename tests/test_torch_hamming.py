"""Gated Hamming matcher: the port's plain PyTorch version against the TPU
kernel `gated_match_pallas` run in Pallas interpret mode on the CPU.

idx, best and ok must be exactly equal: distances are integers/2 and the
gate is the same float32 expression (du*du + dv*dv <= r*r), so there is
no tolerance. The CUDA kernel itself runs only on the card; its test is
marked `cuda` and is exercised by chip_smoke.py on the H100.

The kernel folds its columns, the lanes of a quad, the tiles of a block and
the chunks of the store in whatever order they come, which is right only if
the merge of partial results is order-free. `merge_partials_reference` is
that merge in plain PyTorch: here the store is cut into uneven (also
interleaved) subsets, each goes through `gated_match_reference`, the
partials are shuffled and merged, and idx, best and second must equal the
unsplit call exactly (every value is an integer or half-integer below 2^24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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
        k = tham.gated_match_cuda(*args, kw["radius"], kw["max_dist"], kw["ratio"])
        p = tham.gated_match_reference(*args, kw["radius"])
        for a, b in zip(k, (*p, tham.accept_reference(args[2], *p, kw["max_dist"], kw["ratio"]))):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the order-free merge of partial results
# ---------------------------------------------------------------------------


def _split_and_merge(d, radius, subsets, rng):
    """gated_match_reference on each subset of store rows (sorted row indices),
    the partials shuffled, then merged."""
    fdesc, fuv, fvalid, sdesc, suv, svalid = _torch_args(d)
    parts = []
    for rows in subsets:
        rows_t = torch.as_tensor(rows, dtype=torch.int64)
        idx, best, second = tham.gated_match_reference(fdesc, fuv, fvalid, sdesc[rows_t], suv[rows_t], svalid[rows_t],
                                                       radius)
        glob = torch.cat([rows_t, torch.tensor([-1])])[idx.to(torch.int64)]  # local row -> store row, -1 stays
        parts.append((best, glob.to(torch.int32), second))
    order = rng.permutation(len(parts))
    n = fdesc.shape[0]
    stack = [torch.stack([parts[i][k] for i in order]) if len(parts) else
             torch.empty((0, n), dtype=(torch.float32, torch.int32, torch.float32)[k]) for k in range(3)]
    return tham.merge_partials_reference(*stack)


def _subsets(rng, p, n_parts, interleaved):
    """Uneven subsets covering range(p): contiguous chunks, or rows dealt at random."""
    if n_parts == 0:
        return []
    if interleaved:
        owner = rng.integers(0, n_parts, size=p)
        return [np.flatnonzero(owner == k) for k in range(n_parts)]  # some may be empty
    cuts = np.sort(rng.choice(np.arange(1, max(p, 2)), size=min(n_parts - 1, max(p - 1, 0)), replace=False))
    return np.split(np.arange(p), cuts)


def _assert_merge_equals_unsplit(d, kw, subsets, rng):
    want = tham.gated_match_reference(*_torch_args(d), kw["radius"])
    got = _split_and_merge(d, kw["radius"], subsets, rng)
    for name, a, b in zip(("idx", "best", "second"), got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    return got


def _tied(rng, n, p):
    """Any n and p (an empty store too). Few distinct descriptors and
    positions, so exact ties abound, within a subset and across subsets."""
    fdesc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    fuv = np.round(rng.uniform(0, 40, size=(n, 2))).astype(np.float32)
    pick = rng.integers(0, n, size=p)
    return dict(fdesc=fdesc, fuv=fuv, fvalid=rng.random(n) > 0.2, sdesc=fdesc[pick],
                suv=fuv[rng.integers(0, n, size=p)], svalid=rng.random(p) > 0.2)


def case_duplicates_across_chunks(rng):
    """The winner's exact duplicate sits far away in the store: second == best,
    the lower row wins, whichever subset each copy falls into."""
    d = _planted(rng)
    d["sdesc"][128:192] = d["sdesc"][0:64]
    d["suv"][128:192] = d["suv"][0:64]
    d["sdesc"][250] = d["sdesc"][5]
    d["suv"][250] = d["suv"][5]
    return d, dict(radius=15.0, max_dist=60.0, ratio=0.9)


MERGE_CASES = CASES + [case_duplicates_across_chunks]


@pytest.mark.parametrize("interleaved", [False, True], ids=["chunks", "interleaved"])
@pytest.mark.parametrize("make", MERGE_CASES, ids=[c.__name__[5:] for c in MERGE_CASES])
def test_merged_partials_equal_unsplit(make, interleaved):
    rng = np.random.default_rng(11)
    d, kw = make(rng)
    p = d["sdesc"].shape[0]
    for n_parts in (1, 2, 5, 9):
        idx, best, second = _assert_merge_equals_unsplit(d, kw, _subsets(rng, p, n_parts, interleaved), rng)
    if p % 64 == 0:  # the Pallas wrapper takes the shape
        jidx, jbest, jok = jham.gated_match_pallas(
            *[jnp.asarray(d[k]) for k in ("fdesc", "fuv", "fvalid", "sdesc", "suv", "svalid")],
            radius=kw["radius"], max_dist=kw["max_dist"], ratio=kw["ratio"], tile=64, interpret=True)
        ok = tham.accept_reference(torch.as_tensor(d["fvalid"]), idx, best, second, kw["max_dist"], kw["ratio"])
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_merge_special_cases():
    rng = np.random.default_rng(5)
    # duplicates: whichever subsets the two copies fall into, the lower row wins and second == best
    d, kw = case_duplicates_across_chunks(rng)
    idx, best, second = _assert_merge_equals_unsplit(d, kw, [np.arange(0, 100), np.arange(100, 256)], rng)
    hit = (idx >= 0) & (idx < 64)
    assert int(hit.sum()) > 8 and torch.equal(best[hit], second[hit])
    # all rows gated out: every partial is the identity
    d, kw = case_all_gated(rng)
    idx, best, second = _assert_merge_equals_unsplit(d, kw, _subsets(rng, 256, 4, False), rng)
    assert bool((idx == -1).all()) and bool((best == 1e9).all()) and bool((second == 1e9).all())
    # an empty store, as no partial at all and as empty partials
    d = _tied(rng, 16, 0)
    for subsets in ([], [np.arange(0)], [np.arange(0), np.arange(0)]):
        idx, best, second = _assert_merge_equals_unsplit(d, dict(radius=15.0), subsets, rng)
        assert bool((idx == -1).all()) and bool((best == 1e9).all()) and bool((second == 1e9).all())
    # arbitrary int8 values and rows of zeros on both sides: negative and half-integer distances
    d = _planted(rng, n=32, p=96)
    d["fdesc"] = rng.integers(-128, 128, size=(32, 256)).astype(np.int8)
    d["sdesc"] = rng.integers(-128, 128, size=(96, 256)).astype(np.int8)
    d["fdesc"][::5] = 0
    d["sdesc"][::7] = 0
    d["suv"] = d["fuv"][rng.integers(0, 32, size=96)] + rng.normal(size=(96, 2)).astype(np.float32)
    _, best, _ = _assert_merge_equals_unsplit(d, dict(radius=15.0), _subsets(rng, 96, 6, True), rng)
    assert float(best.min()) < 0 and bool(((best[::5] == 128.0) | (best[::5] == 1e9)).all()) and bool((best[::5] == 128.0).any())


def test_merge_is_associative_and_commutative():
    """Merging merged groups equals merging everything at once."""
    rng = np.random.default_rng(9)
    d, kw = case_duplicates_across_chunks(rng)
    subsets = _subsets(rng, 256, 8, True)
    want = tham.gated_match_reference(*_torch_args(d), kw["radius"])
    groups = [_split_and_merge(d, kw["radius"], subsets[a:b], rng) for a, b in ((0, 3), (3, 4), (4, 8))]
    stack = [torch.stack([g[k] for g in reversed(groups)]) for k in (1, 0, 2)]  # best, idx, second
    got = tham.merge_partials_reference(*stack)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@settings(max_examples=30, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 24), p=st.integers(0, 80), n_parts=st.integers(0, 7),
       interleaved=st.booleans(), radius=st.sampled_from([0.0, 3.0, 15.0, 1e6]))
def test_merged_partials_equal_unsplit_hypothesis(seed, n, p, n_parts, interleaved, radius):
    d = _tied(np.random.default_rng(seed), n, p)
    rng = np.random.default_rng(seed + 1)
    if n_parts == 0 and p > 0:
        n_parts = 1
    _assert_merge_equals_unsplit(d, dict(radius=radius), _subsets(rng, p, n_parts, interleaved), rng)
