"""Relocalization and the Atlas in the port against the reference: PnP
(stereo and the monocular DLT), `merge_maps`, `PreintStore.remap`, and the
reference's planted scenarios (tests/test_reloc_pnp.py,
tests/test_atlas_merge.py) run by both trackers. (The map-reset guards of
tests/test_failure_guards.py are in test_torch_loop.py.)

The RANSAC functions get the reference's own draw (`jax.random.choice`
under the reference's key). Tolerances, repeated in each test:
- PnP: inlier masks, counts and the accept flag exact; the RANSAC pose
  within 1e-4, the GN-polished pose within 1e-4;
- merge_maps and remap: integers, masks and bitsets exact, transformed
  geometry within 1e-5;
- trackers: the two packages' maps drift apart slowly at 128x96 (see
  test_torch_tracker), so a whole run compares decisions where both are
  robust (the frame a kidnap is recovered, the blackout's new map) and
  the rare path itself is held in lockstep: at every call of
  `_relocalize` and `_try_merge` in the reference's run, a port tracker
  put into the reference's state makes the same call on the same frame;
  there the decision must be equal and the pose, the stores and the map
  count after it close (a relocalized pose within 1e-3; the merged map
  before its welding BA within 1e-5, the welding BA held to what BA
  decides, as in test_torch_step).
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu.ops import camera as jcam
from pli_slam_tpu.ops import imu as jimu
from pli_slam_tpu.ops.pallas import hamming as jham
from pli_slam_tpu.solve import pnp as jpnp
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import OptimizerConfig, SlamConfig
from pli_slam_tpu.worldmap import atlas as jatlas
from pli_slam_tpu.worldmap import stores as jst
from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
from pli_slam_tpu_torch.ops import camera as tcam
from pli_slam_tpu_torch.solve import pnp as tpnp
from pli_slam_tpu_torch.solve import sim3 as tsim3
from pli_slam_tpu_torch.utils import convert
from pli_slam_tpu_torch.worldmap import atlas as tatlas

torch.set_num_threads(1)
T = torch.as_tensor
CAM_ARGS = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=13.2, width=128, height=96)
JC, TC = jcam.Camera.pinhole(**CAM_ARGS), tcam.Camera.pinhole(**CAM_ARGS)
TRAJ = dict(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)


def close(t, j, rtol=1e-4, atol=1e-4):
    np.testing.assert_allclose(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t, np.asarray(j),
                               rtol=rtol, atol=atol)


def np_tree(x):
    return jax.tree_util.tree_map(np.asarray, x)


def reference_draw(seed, probs, shape):
    """The reference's own hypothesis draw: jax.random.choice under PRNGKey(seed)."""
    p = jnp.asarray(probs.detach().cpu().numpy())
    idx = jax.random.choice(jax.random.PRNGKey(seed), p.shape[0], shape=shape, replace=True, p=p)
    return torch.tensor(np.asarray(idx), device=probs.device)


def port_cfg(cfg):
    return convert.config_from_reference(dataclasses.asdict(cfg))


def assert_same(t_obj, j_obj, atol=1e-5, label=""):
    """Every field: integers, masks and bitsets exact, floats within `atol`."""
    a, b = convert.to_numpy(t_obj), convert.to_numpy(np_tree(j_obj))
    assert a.keys() == b.keys()
    for k in a:
        if a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=label + k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=label + k)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------


def _pnp_scene(rng, n=160, outliers=0.3):
    R_true = Rotation.from_rotvec([0.1, -0.25, 0.05]).as_matrix().astype(np.float32)
    t_true = np.array([0.3, -0.1, 0.4], np.float32)
    xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2.5, 6, n)], -1).astype(np.float32)
    x_w = ((xc - t_true) @ R_true).astype(np.float32)  # R_true^T (xc - t)
    uv = np.asarray(jcam.project(JC, xc)) + rng.normal(size=(n, 2)).astype(np.float32) * 0.5
    depth = (xc[:, 2] * (1 + rng.normal(size=n) * 0.02)).astype(np.float32)
    bad = rng.random(n) < outliers
    x_w[bad] += rng.normal(size=(int(bad.sum()), 3)).astype(np.float32)
    mask = rng.random(n) > 0.05
    u_right = (uv[:, 0] - CAM_ARGS["bf"] / xc[:, 2]).astype(np.float32)
    stereo = rng.random(n) > 0.3
    return dict(x_w=x_w, uv=uv.astype(np.float32), depth=depth, mask=mask, u_right=u_right, stereo=stereo,
                sigma2=np.ones(n, np.float32)), R_true, t_true


@pytest.mark.parametrize("mono", [False, True])
def test_pnp_parity(mono):
    """`ransac_pnp` (stereo: three points lifted by their depth seed, Horn)
    and `ransac_pnp_dlt` (mono: a 6-point DLT per hypothesis), each with the
    reference's draw for its key, then `solve_pnp`'s GN polish: inliers,
    counts and ok exact, poses within 1e-4 (the DLT's RANSAC pose 2e-3: a
    12x12 SVD per hypothesis, LAPACK against XLA) and near the truth."""
    rng = np.random.default_rng(7)
    sc, R_true, t_true = _pnp_scene(rng)
    key, k = 7000 + 3, (6 if mono else 3)
    hyp = reference_draw(key, tsim3.mask_probs(T(sc["mask"])), (256, k))
    args_t = (TC, T(sc["x_w"]), T(sc["uv"]))
    args_j = (JC, jnp.asarray(sc["x_w"]), jnp.asarray(sc["uv"]))
    if mono:
        out_t = tpnp.ransac_pnp_dlt(*args_t, T(sc["mask"]), hyp, inlier_px=8.0, min_inliers=12)
        out_j = jpnp.ransac_pnp_dlt(*args_j, jnp.asarray(sc["mask"]), jax.random.PRNGKey(key), inlier_px=8.0,
                                    min_inliers=12)
    else:
        out_t = tpnp.ransac_pnp(*args_t, T(sc["depth"]), T(sc["mask"]), hyp, inlier_px=8.0, min_inliers=12)
        out_j = jpnp.ransac_pnp(*args_j, jnp.asarray(sc["depth"]), jnp.asarray(sc["mask"]), jax.random.PRNGKey(key),
                                inlier_px=8.0, min_inliers=12)
    tol = 2e-3 if mono else 1e-4
    close(out_t[0], out_j[0], atol=tol)
    close(out_t[1], out_j[1], atol=tol)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    assert int(out_t[3]) == int(out_j[3]) and bool(out_t[4]) == bool(out_j[4]) is True

    cfg = OptimizerConfig()
    res_t = tpnp.solve_pnp(TC, T(sc["x_w"]), T(sc["uv"]), T(sc["u_right"]), T(sc["stereo"]), T(sc["depth"]),
                           T(sc["sigma2"]), T(sc["mask"]), hyp, port_cfg(SlamConfig(opt=cfg)).opt, inlier_px=8.0,
                           min_inliers=12, mono=mono)
    res_j = jpnp.solve_pnp(JC, jnp.asarray(sc["x_w"]), jnp.asarray(sc["uv"]), jnp.asarray(sc["u_right"]),
                           jnp.asarray(sc["stereo"]), jnp.asarray(sc["depth"]), jnp.asarray(sc["sigma2"]),
                           jnp.asarray(sc["mask"]), jax.random.PRNGKey(key), cfg, inlier_px=8.0, min_inliers=12,
                           mono=mono)
    close(res_t[0], res_j[0], atol=1e-4)
    close(res_t[1], res_j[1], atol=1e-4)
    np.testing.assert_array_equal(res_t[2].numpy(), np.asarray(res_j[2]))
    assert int(res_t[3]) == int(res_j[3]) and bool(res_t[4]) == bool(res_j[4])
    np.testing.assert_allclose(res_t[1].numpy(), t_true, atol=0.05)


# ---------------------------------------------------------------------------
# merge_maps, PreintStore.remap
# ---------------------------------------------------------------------------


def _random_map(rng, K, S, Sl, P, L, n_kf, n_pts, n_lns, start=0):
    """Reference stores with every field filled: keyframes, points and lines
    valid from `start` on (so a destination map has free rows before and after)."""
    KW = -(-K // 32)
    kv, pv, lv = (np.zeros(c, bool) for c in (K, P, L))
    kv[start:start + n_kf] = True
    pv[rng.permutation(P)[:n_pts]] = True
    lv[rng.permutation(L)[:n_lns]] = True
    bits = lambda n: (rng.integers(0, 2 ** 31, size=(n, KW)).astype(np.uint32)  # noqa: E731
                      & np.uint32((1 << (K % 32)) - 1 if K % 32 else 0xFFFFFFFF))
    obs = lambda shape, cap: np.where(rng.random(shape) < 0.7, rng.integers(0, cap, shape), -1).astype(np.int32)  # noqa: E731
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    i32 = lambda hi, *shape: rng.integers(0, hi, shape).astype(np.int32)  # noqa: E731
    covis = i32(60, K, K) * (kv[:, None] & kv[None, :])
    Rs = Rotation.from_rotvec(f32(K, 3) * 0.3).as_matrix().astype(np.float32)
    ks = jst.KeyFrameStore(
        R=jnp.asarray(Rs), t=jnp.asarray(f32(K, 3)), v_w=jnp.asarray(f32(K, 3)), bg=jnp.asarray(f32(K, 3)),
        ba=jnp.asarray(f32(K, 3)), stamp=jnp.asarray(rng.random(K).astype(np.float32)), valid=jnp.asarray(kv),
        obs_pt=jnp.asarray(obs((K, S), P)), obs_uvr=jnp.asarray(f32(K, S, 3)),
        obs_sigma2=jnp.asarray(rng.random((K, S)).astype(np.float32)), obs_stereo=jnp.asarray(rng.random((K, S)) > .5),
        obs_ln=jnp.asarray(obs((K, Sl), L)), obs_l=jnp.asarray(f32(K, Sl, 3)),
        obs_ln_sigma2=jnp.asarray(rng.random((K, Sl)).astype(np.float32)), covis=jnp.asarray(covis))
    desc = lambda n: np.sign(rng.normal(size=(n, 256))).astype(np.int8)  # noqa: E731
    ps = jst.PointStore(
        x=jnp.asarray(f32(P, 3)), desc=jnp.asarray(desc(P)), valid=jnp.asarray(pv), n_obs=jnp.asarray(i32(9, P)),
        visible=jnp.asarray(i32(30, P)), found=jnp.asarray(i32(20, P)), first_kf=jnp.asarray(i32(K, P)),
        last_kf=jnp.asarray(i32(K, P)), obs_bits=jnp.asarray(bits(P)),
        desc_bank=jnp.asarray(np.sign(rng.normal(size=(P,) + jst.PointStore.empty(1, K).desc_bank.shape[1:]))
                              .astype(np.int8)))
    ls = jst.LineStore(
        seg=jnp.asarray(f32(L, 6)), desc=jnp.asarray(desc(L)), valid=jnp.asarray(lv), n_obs=jnp.asarray(i32(9, L)),
        visible=jnp.asarray(i32(30, L)), found=jnp.asarray(i32(20, L)), first_kf=jnp.asarray(i32(K, L)),
        last_kf=jnp.asarray(i32(K, L)), obs_bits=jnp.asarray(bits(L)))
    return ks, ps, ls


def _port_bundle(jb):
    return tatlas.MapBundle(pstore=convert.point_store(np_tree(jb.pstore)),
                            lstore=convert.line_store(np_tree(jb.lstore)),
                            kstore=convert.keyframe_store(np_tree(jb.kstore)), n_kf=jb.n_kf)


@pytest.mark.parametrize("fuse", [False, True])
def test_merge_maps_parity(fuse):
    """`merge_maps` welds a source map into a destination's free rows:
    transformed geometry within 1e-5; observation tables, landmark anchors,
    covisibility, the int32 incidence bitsets (uint32 in the reference),
    keyframe slot map and n_kf exact; with fused landmarks (-1 padded
    lists, a repeated source id: last write wins) as well."""
    rng = np.random.default_rng(11)
    K, S, Sl, P, L = 40, 24, 6, 96, 24
    bundle = lambda maps, n_kf: jatlas.MapBundle(kstore=maps[0], pstore=maps[1], lstore=maps[2], n_kf=n_kf)  # noqa: E731
    dst = bundle(_random_map(rng, K, S, Sl, P, L, n_kf=12, n_pts=40, n_lns=8, start=2), 14)
    src = bundle(_random_map(rng, K, S, Sl, P, L, n_kf=9, n_pts=30, n_lns=6), 9)
    R_rel = Rotation.from_rotvec([0.2, -0.1, 0.4]).as_matrix().astype(np.float32)
    t_rel = np.array([0.5, -1.0, 0.25], np.float32)
    fs = fd = None
    if fuse:
        src_valid = np.nonzero(np.asarray(src.pstore.valid))[0]
        dst_valid = np.nonzero(np.asarray(dst.pstore.valid))[0]
        fs = np.full(16, -1, np.int32)
        fd = np.full(16, -1, np.int32)
        fs[:10], fd[:10] = src_valid[:10], dst_valid[:10]
        fs[10], fd[10] = src_valid[3], dst_valid[20]  # a repeated source id
    out_j, slots_j = jatlas.merge_maps(dst, src, jnp.asarray(R_rel), jnp.asarray(t_rel),
                                       None if fs is None else jnp.asarray(fs), None if fd is None else jnp.asarray(fd))
    out_t, slots_t = tatlas.merge_maps(_port_bundle(dst), _port_bundle(src), T(R_rel), T(t_rel),
                                       None if fs is None else T(fs), None if fd is None else T(fd))
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    assert out_t.n_kf == out_j.n_kf
    for name in ("pstore", "lstore", "kstore"):
        assert_same(getattr(out_t, name), getattr(out_j, name), label=name + ".")


def test_atlas_container_parity(rng):
    """tests/test_atlas.py's three cases on both packages' `Atlas`: a new
    map on loss leaves the old one intact; merging a translated map lands
    its points (transformed) and keyframes in the target's free rows with
    re-indexed observations; after an SE3 merge a camera still sees its
    point where it did. The merged bundles are equal (geometry within 1e-5)."""
    jcfg = SlamConfig.tiny_test()
    ja, ta = jatlas.Atlas(jcfg), tatlas.Atlas(port_cfg(jcfg), "cpu")

    def populate(at, n_pts, n_kf, offset, seed):
        r = np.random.default_rng(seed)
        b = at.active
        pts = (np.stack([r.uniform(-2, 2, n_pts), r.uniform(-2, 2, n_pts), r.uniform(3, 6, n_pts)], -1)
               + offset).astype(np.float32)
        S = b.kstore.obs_pt.shape[1]
        obs = np.full(S, -1, np.int32)
        obs[:n_pts] = np.arange(n_pts)
        x, valid, desc = (np.array(v) for v in (b.pstore.x, b.pstore.valid, b.pstore.desc))
        x[:n_pts], valid[:n_pts] = pts, True
        desc[:n_pts] = r.choice([-1, 1], (n_pts, 256))
        kv, kt, ko = (np.array(v) for v in (b.kstore.valid, b.kstore.t, b.kstore.obs_pt))
        for k in range(n_kf):
            kv[k], kt[k], ko[k] = True, [0.1 * k + offset, 0.0, 0.0], obs
        conv = jnp.asarray if isinstance(at, jatlas.Atlas) else torch.as_tensor
        at.maps[at.active_idx] = type(b)(
            pstore=dataclasses.replace(b.pstore, x=conv(x), valid=conv(valid), desc=conv(desc)), lstore=b.lstore,
            kstore=dataclasses.replace(b.kstore, valid=conv(kv), t=conv(kt), obs_pt=conv(ko)), n_kf=n_kf)

    for at in (ja, ta):
        populate(at, 20, 3, 0.0, 1)
        at.create_new_map()
        assert at.n_maps() == 2 and int(at.active.pstore.valid.sum()) == 0 and int(at.maps[0].pstore.valid.sum()) == 20
        populate(at, 10, 2, 5.0, 2)
    R_rel = Rotation.from_rotvec([0.3, -0.2, 0.5]).as_matrix().astype(np.float32)
    t_rel = np.array([1.0, 2.0, 3.0], np.float32)
    x_src, R_src, t_src = (np.asarray(v) for v in (ja.active.pstore.x[0], ja.active.kstore.R[0], ja.active.kstore.t[0]))
    mj = ja.merge_active_into(0, jnp.asarray(R_rel), jnp.asarray(t_rel))
    mt = ta.merge_active_into(0, T(R_rel), T(t_rel))
    assert ja.n_maps() == ta.n_maps() == 1 and mt.n_kf == mj.n_kf
    np.testing.assert_array_equal(ta.last_kf_slots, np.asarray(ja.last_kf_slots))
    for name in ("pstore", "lstore", "kstore"):
        assert_same(getattr(mt, name), getattr(mj, name), label=name + ".")
    assert int(mt.pstore.valid.sum()) == 30 and int(mt.kstore.valid.sum()) == 5
    np.testing.assert_allclose(mt.pstore.x[20:30].numpy(), (np.asarray(ja.maps[0].pstore.x[20:30])), atol=1e-5)
    obs_k3 = mt.kstore.obs_pt[3].numpy()
    assert obs_k3[obs_k3 >= 0].min() >= 20 and obs_k3[obs_k3 >= 0].max() <= 29
    x_cam = mt.kstore.R[3].numpy() @ mt.pstore.x[20].numpy() + mt.kstore.t[3].numpy()
    np.testing.assert_allclose(x_cam, R_src @ x_src + t_src, atol=1e-4)


def test_preint_store_remap_parity():
    """tests/test_atlas_merge.py's three remap cases (a contiguous tail, a
    hole, unmapped endpoints) plus a random slot map over a random chain,
    against the reference's `PreintStore.remap`: valid flags and every
    factor's fields exact (they only move)."""
    rng = np.random.default_rng(12)

    def store_with(keys, K=12):
        st_ = jimu.PreintStore.empty(K)
        for i, k in enumerate(keys):
            p = jimu.Preintegrated.identity()
            p = dataclasses.replace(p, dt=jnp.asarray(float(i + 1)), dV=jnp.asarray(rng.normal(size=3), jnp.float32))
            st_ = st_.set(k, p)
        return st_

    cases = [([1, 2, 3], [5, 6, 7, 8, -1, -1], [6, 7, 8]), ([1, 2, 3], [5, 6, 9, 10], [6, 10]),
             ([1, 2], [-1, 4, 5], [5])]
    perm = rng.permutation(12)
    cases.append(([1, 2, 3, 5, 6, 7, 9, 10], np.where(rng.random(12) < 0.8, perm, -1).tolist(), None))
    for keys, slots, expect in cases:
        js = store_with(keys)
        out_j = js.remap(np.asarray(slots))
        out_t = convert.preint_store(np_tree(js)).remap(np.asarray(slots))
        assert_same(out_t, out_j, atol=0.0)
        if expect is not None:
            assert sorted(np.nonzero(out_t.valid.numpy())[0].tolist()) == expect


# ---------------------------------------------------------------------------
# Trackers
# ---------------------------------------------------------------------------


def _accelerator_branch():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "default_backend", lambda: "tpu")
    mp.setattr(jham, "gated_match_pallas", partial(jham.gated_match_pallas, interpret=True))
    return mp


def _tiny(cfg):
    return dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, max_points=2048, local_map_points=2048))


def _install(tt, jt):
    """Put the port tracker `tt` into the reference tracker `jt`'s state, as
    far as the visual path and its rare paths read it."""
    P = lambda x: convert.tensor(np.asarray(x))  # noqa: E731
    tt.pstore, tt.lstore = convert.point_store(np_tree(jt.pstore)), convert.line_store(np_tree(jt.lstore))
    tt.kstore, tt.bow_db = convert.keyframe_store(np_tree(jt.kstore)), convert.bow_database(np_tree(jt.bow_db))
    tt._pints = convert.preint_store(np_tree(jt._pints))
    tt._kf_view_dev = tuple(P(v) for v in jt._kf_view_dev)
    for name in ("R", "t", "R_prev", "t_prev", "vel_xi", "_local_pt"):
        setattr(tt, name, P(getattr(jt, name)))
    tt.has_vel = torch.tensor(bool(jt.has_vel))
    for name in ("n_kf", "frames_since_kf", "last_kf_inliers"):
        setattr(tt, name, int(getattr(jt, name)))
    for name in ("state", "_lost_frames", "_prev_stamp", "_merge_streak", "_merge_map_idx", "_merge_kf"):
        setattr(tt, name, getattr(jt, name))
    tt.stats = list(jt.stats)
    tt.atlas.maps = [tatlas.MapBundle(
        pstore=convert.point_store(np_tree(b.pstore)), lstore=convert.line_store(np_tree(b.lstore)),
        kstore=convert.keyframe_store(np_tree(b.kstore)), n_kf=int(b.n_kf),
        bow_db=None if b.bow_db is None else convert.bow_database(np_tree(b.bow_db))) for b in jt.atlas.maps]
    tt.atlas.active_idx = jt.atlas.active_idx


def _pose_of(tr):
    R, t = (np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in (tr.R, tr.t))
    return R, t


def _lockstep(jt, tt_lock, records):
    """Wrap the reference's `_relocalize` and `_try_merge` so that each call
    is first made by `tt_lock` from the reference's state and frame. A merge
    also records both packages' welding BA (its input and output stores)."""
    orig_reloc, orig_merge, orig_weld = jt._relocalize, jt._try_merge, tt_lock._weld_ba

    def reloc(frame):
        _install(tt_lock, jt)
        ok_t = tt_lock._relocalize(convert.frame_data(np_tree(frame)))
        ok_j = orig_reloc(frame)
        records.append(dict(kind="reloc", ok=(ok_j, ok_t), pose=(_pose_of(jt), _pose_of(tt_lock))))
        return ok_j

    def merge(kf_slot):
        if jt.atlas.n_maps() <= 1:
            return orig_merge(kf_slot)
        weld = {}

        def weld_t(k_dst):
            weld["t_in"] = (tt_lock.kstore, tt_lock.pstore, tt_lock.lstore)
            orig_weld(k_dst)
            weld["t_out"] = (tt_lock.kstore, tt_lock.pstore, tt_lock.lstore)

        def weld_j(ks, ps, ls, window, fixed):
            weld["j_in"], weld["window"] = (ks, ps, ls), (np.asarray(window), np.asarray(fixed))
            weld["j_out"] = orig_ba(ks, ps, ls, window, fixed)
            return weld["j_out"]

        _install(tt_lock, jt)
        tt_lock._weld_ba, orig_ba = weld_t, jt._ba
        jt._ba = weld_j
        try:
            ok_t = tt_lock._try_merge(kf_slot)
            ok_j = orig_merge(kf_slot)
        finally:
            jt._ba = orig_ba
            del tt_lock._weld_ba
        records.append(dict(kind="merge", ok=(ok_j, ok_t), pose=(_pose_of(jt), _pose_of(tt_lock)), weld=weld,
                            maps=(jt.atlas.n_maps(), tt_lock.atlas.n_maps()), n_kf=(jt.n_kf, tt_lock.n_kf),
                            slots=(np.asarray(jt._kf_view_dev[3]), tt_lock._kf_view_dev[3].numpy())))
        return ok_j

    jt._relocalize, jt._try_merge = reloc, merge


def _weld_objective(cfg, jstores, solution, window, fixed):
    """The welding BA's cost of `solution` = (kstore, pstore, lstore) on the
    reference's post-BA problem: same window, same kept observations."""
    from pli_slam_tpu_torch.frontend import step as tstep
    from pli_slam_tpu_torch.solve import ba as tba

    def port(stores):
        if isinstance(stores[0].R, torch.Tensor):
            return stores
        return tuple(f(np_tree(x)) for f, x in zip((convert.keyframe_store, convert.point_store, convert.line_store),
                                                   stores))

    (ks_j, ps_j, ls_j), solution = port(jstores), port(solution)
    ks = dataclasses.replace(ks_j, R=solution[0].R, t=solution[0].t)
    ps = dataclasses.replace(ps_j, x=solution[1].x)
    ls = dataclasses.replace(ls_j, seg=solution[2].seg)
    prob, _, _ = tstep.window_problem(ks, ps, ls, T(window), T(fixed), pt_cap=cfg.opt.ba_pt_cap,
                                      ln_cap=cfg.opt.ba_ln_cap)
    return float(tba.evaluate_cost(TC, prob, prob.R, prob.t, prob.pts, prob.lns, cfg.opt)[0])


def _check_lockstep(records, kinds, cfg):
    """Relocalization: the same decision, the pose within 1e-3. Merge: the
    same decision; where it welds, the merged map before the welding BA
    equal (slot map and observation tables exact, geometry within 1e-5),
    one map left, and the welding BA held to what BA decides on this
    ill-conditioned 128x96 map (see test_torch_step): poses within 5e-2,
    and each package's solution as good as the other's on the reference's
    problem (cost within 10% + 1)."""
    assert {r["kind"] for r in records} >= set(kinds), [r["kind"] for r in records]
    for r in records:
        (ok_j, ok_t), ((Rj, tj), (Rt, tt_)) = r["ok"], r["pose"]
        assert ok_j == ok_t, r["kind"]
        if not ok_j:
            continue
        if r["kind"] == "reloc":
            np.testing.assert_allclose(Rt, Rj, atol=1e-3)
            np.testing.assert_allclose(tt_, tj, atol=1e-3)
            continue
        assert r["maps"] == (1, 1) and r["n_kf"][0] == r["n_kf"][1]
        np.testing.assert_array_equal(r["slots"][1], r["slots"][0])
        w = r["weld"]
        for ts, js, name in zip(w["t_in"], w["j_in"], ("kstore", "pstore", "lstore")):
            assert_same(ts, js, atol=1e-5, label=name + ".")
        np.testing.assert_allclose(Rt, Rj, atol=5e-2)
        np.testing.assert_allclose(tt_, tj, atol=5e-2)
        cost_j = _weld_objective(port_cfg(cfg), w["j_out"], w["j_out"], *w["window"])
        cost_t = _weld_objective(port_cfg(cfg), w["j_out"], w["t_out"], *w["window"])
        assert cost_t <= 1.1 * cost_j + 1.0, (cost_t, cost_j)


def _kidnap_view(traj):
    """tests/test_reloc_pnp.py's kidnap: the pose at t = 0.1 displaced by
    (0.45, 0.3, -0.25) m and turned 0.35 rad in yaw; its stereo pair and the
    pose in the tracker's world."""
    R_wc, p_w = traj.pose(0.1)
    p_kid = p_w + np.array([0.45, 0.3, -0.25])
    yaw = 0.35
    R_wc = R_wc @ np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    R_j, p_j = jnp.asarray(R_wc, jnp.float32), jnp.asarray(p_kid, jnp.float32)
    img_l = np.asarray(jsyn.render_view(JC, R_j, p_j, room_half=2.55))
    img_r = np.asarray(jsyn.render_view(JC, R_j, p_j + R_j[:, 0] * float(JC.bf / JC.fx), room_half=2.55))
    R0, p0 = traj.pose(0.0)
    R_cw = (R0.T @ R_wc).T.astype(np.float32)
    t_cw = (-R_cw @ (R0.T @ (p_kid - p0))).astype(np.float32)
    return img_l, img_r, R_cw, t_cw


def test_kidnap_relocalization_both_packages():
    """tests/test_reloc_pnp.py at 128x96 (slow there, 20 frames here as
    well): both trackers map 20 frames, then see the kidnap view up to 6
    times. Whole runs: per-frame states equal, both recover on the same
    kidnap frame within 0.2 m of their own oracle-seeded re-track (the
    reference test's criterion). Lockstep: every `_relocalize` call of the
    reference, made by the port from the reference's state, gives the same
    decision and a pose within 1e-3."""
    cfg = SlamConfig.tiny_test()
    cfg = _tiny(dataclasses.replace(cfg, tracking=dataclasses.replace(
        cfg.tracking, recently_lost_sec=3.0, min_inliers_track=20, min_inliers_local_map=25)))
    traj = jsyn.Trajectory(**TRAJ)
    mp = _accelerator_branch()
    try:
        jt = jtr.Tracker(JC, cfg)
        tt = Tracker(TC, port_cfg(cfg), "cpu")
        tt.draw = tt.loop_closer.draw = reference_draw
        lock = Tracker(TC, port_cfg(cfg), "cpu")
        lock.draw = reference_draw
        records = []
        _lockstep(jt, lock, records)
        frames = list(jsyn.make_sequence(JC, 20, fps=cfg.fps, traj=traj, room_half=2.55))
        for fr in frames:
            il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
            assert jt.process(il, ir, fr["t"])["state"] == tt.process(il, ir, fr["t"])["state"] == TrackingState.OK
        img_l, img_r, R_cw, t_cw = _kidnap_view(traj)
        p_ref = []
        for tr, cam, track in ((jt, JC, jt._track), (tt, TC, None)):
            if track is not None:
                R, t, *_, n, _, _ = track(jt.build_frame(img_l, img_r), jnp.asarray(R_cw), jnp.asarray(t_cw),
                                          jt.pstore, jt.lstore)
            else:
                from pli_slam_tpu_torch.frontend import step as tstep

                R, t, *_, n, _, _ = tstep.track_step(TC, tt.cfg, tt.build_frame(T(img_l), T(img_r)), T(R_cw),
                                                     T(t_cw), tt.pstore, tt.lstore, torch.tensor(False))
            assert int(n) >= cfg.tracking.min_inliers_local_map
            p_ref.append(-(np.asarray(R).T @ np.asarray(t)))
        recovered = [None, None]
        for i in range(6):
            stamp = frames[-1]["t"] + 0.05 * (i + 1)
            infos = (jt.process(img_l, img_r, stamp), tt.process(img_l, img_r, stamp))
            assert infos[0]["state"] == infos[1]["state"], (i, infos)
            for k, (tr, info) in enumerate(zip((jt, tt), infos)):
                R, t = _pose_of(tr)
                if recovered[k] is None and info["state"] == TrackingState.OK and \
                        np.linalg.norm(-(R.T @ t) - p_ref[k]) < 0.2:
                    recovered[k] = i
            if None not in recovered:
                break
        assert recovered[0] is not None and recovered[0] == recovered[1], recovered
    finally:
        mp.undo()
    _check_lockstep(records, ["reloc"], cfg)
    assert any(r["ok"][0] for r in records if r["kind"] == "reloc")


def test_loss_new_map_merge_both_packages():
    """tests/test_atlas_merge.py at 128x96: 20 frames, 8 blank frames, then
    the revisit. Whole runs: per-frame states and map counts equal through
    the blackout (a new map on the same frame in both) and the revisit's
    initialization. The merge itself in lockstep: at each `_try_merge` call
    of the reference with a parked map, the port, put into the reference's
    state, decides the same (streak, BoW hit, RANSAC verdict); where the
    reference welds, the merged map's slot map, validity and observation
    tables are equal, poses and landmarks within 1e-3, one map left. The
    reference merges within the revisit and tracks on in the merged world
    within 0.5 m of the truth (the reference test's criterion)."""
    cfg = SlamConfig.tiny_test()
    cfg = _tiny(dataclasses.replace(cfg, tracking=dataclasses.replace(cfg.tracking, recently_lost_sec=0.15),
                                    loop=dataclasses.replace(cfg.loop, min_kf_gap=3)))
    traj = jsyn.Trajectory(**TRAJ)
    mp = _accelerator_branch()
    try:
        jt = jtr.Tracker(JC, cfg)
        tt = Tracker(TC, port_cfg(cfg), "cpu")
        tt.draw = tt.loop_closer.draw = reference_draw
        lock = Tracker(TC, port_cfg(cfg), "cpu")
        lock.draw = reference_draw
        records = []
        _lockstep(jt, lock, records)
        frames = list(jsyn.make_sequence(JC, 24, fps=cfg.fps, traj=traj, room_half=2.55))

        def both(il, ir, stamp, compare=True):
            infos = (jt.process(il, ir, stamp), tt.process(il, ir, stamp))
            if compare:
                assert infos[0]["state"] == infos[1]["state"], (stamp, infos)
                assert jt.atlas.n_maps() == tt.atlas.n_maps(), stamp
            return infos

        for fr in frames[:20]:
            both(np.array(fr["img_l"]), np.array(fr["img_r"]), fr["t"])
        blank = np.zeros_like(np.array(frames[0]["img_l"]))
        for i in range(8):
            both(blank, blank, frames[19]["t"] + 0.05 * (i + 1))
        assert jt.atlas.n_maps() == tt.atlas.n_maps() == 2
        assert jt.state == tt.state == TrackingState.NOT_INITIALIZED
        merged_at = None
        for k, fr in enumerate(frames[2:], 2):
            # the maps agree until the first merge attempt; from there the
            # packages' parked maps differ by their drift (see the module docstring)
            attempted = any(r["kind"] == "merge" for r in records)
            both(np.array(fr["img_l"]), np.array(fr["img_r"]), fr["t"] + 2.0, compare=not attempted)
            if jt.atlas.n_maps() == 1:
                merged_at = k
                break
        assert merged_at is not None, "the reference never merged"
        R0, p0 = traj.pose(0.0)
        for fr in frames[merged_at + 1:merged_at + 5]:
            jt.process(np.array(fr["img_l"]), np.array(fr["img_r"]), fr["t"] + 2.0)
            R, t = _pose_of(jt)
            assert np.linalg.norm(-(R.T @ t) - R0.T @ (fr["p_w"] - p0)) < 0.5
    finally:
        mp.undo()
    _check_lockstep(records, ["merge"], cfg)
    assert any(r["ok"][0] for r in records if r["kind"] == "merge")
