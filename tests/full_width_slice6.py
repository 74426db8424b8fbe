"""The reference alone at full width on the frames of chip_smoke.py's
phases 10-12, which the port renders on the host (the card tracks these
exact pixels): its numbers are the REF_* constants the card's runs are
guarded by. Used by the `slow` tests of test_torch_fisheye.py,
test_torch_mono_inertial.py and test_torch_rgbd_inertial.py; one case
takes 3-15 minutes on a CPU.

`python tests/full_width_slice6.py CASE` runs one case and prints its
numbers (CASE: fisheye, fisheye_vi, mono_vi, rgbd_vi)."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import conftest  # noqa: E402,F401  (JAX on the CPU, before it initializes)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)  # the host renderer beside XLA's threads: more oversubscribe the CPU

from pli_slam_tpu.frontend import tracker as jtr  # noqa: E402
from pli_slam_tpu.ops.camera import Camera as JCamera  # noqa: E402
from pli_slam_tpu.ops.pallas import hamming as jham  # noqa: E402
from pli_slam_tpu.system import System as JSystem  # noqa: E402
from pli_slam_tpu.utils import trajectory as jtio  # noqa: E402
from pli_slam_tpu.utils.config import LoopConfig, SlamConfig  # noqa: E402
from pli_slam_tpu_torch.ops.camera import KANNALA_BRANDT8  # noqa: E402
from pli_slam_tpu_torch.utils import profile  # noqa: E402
from pli_slam_tpu_torch.utils.profile import path_ratio, peek_ate, tracked_positions  # noqa: E402


def reference_config(which: str) -> SlamConfig:
    """The reference's own spelling of profile's configuration for `which`."""
    vi = dataclasses.replace(SlamConfig.euroc_stereo_inertial(), loop=LoopConfig(enabled=False))
    vi = dataclasses.replace(vi, imu=dataclasses.replace(vi.imu, init_time_sec=1.5, max_samples_per_frame=16))
    if which == "fisheye":
        return dataclasses.replace(SlamConfig.euroc_stereo(), loop=LoopConfig(enabled=False), width=512, height=512)
    if which == "fisheye_vi":
        return dataclasses.replace(vi, width=512, height=512)
    if which == "mono_vi":
        return vi.replace(sensor="mono_imu")
    return dataclasses.replace(SlamConfig(sensor="rgbd", width=640, height=480, fps=30.0), sensor="rgbd_imu",
                               imu=vi.imu)


def gated_match_dense(fdesc, fuv, fvalid, sdesc, suv, svalid, radius, max_dist=100.0, ratio=1.0, tile=2048,
                      interpret=False):
    """`gated_match_pallas`'s function in one dense jnp expression: the
    same int8 product, gate, lowest-row argmin, second best and acceptance,
    equal to the kernel output for output (the tiles' merge keeps the first
    tile on ties and the global second best). At full width the kernel in
    interpret mode makes the fused stereo-inertial step too large for
    XLA's CPU compiler (LLVM runs out of memory on the 512x512 fisheye rig)."""
    import jax.numpy as jnp

    dot = jax.lax.dot_general(fdesc, sdesc, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    dist = (fdesc.shape[1] - dot).astype(jnp.float32) * 0.5
    du = fuv[:, 0:1] - suv[:, 0][None, :]
    dv = fuv[:, 1:2] - suv[:, 1][None, :]
    gate = ((du * du + dv * dv) <= jnp.asarray(radius, jnp.float32) ** 2) & svalid[None, :] & fvalid[:, None]
    dist = jnp.where(gate, dist, jham.BIG)
    arg = jnp.argmin(dist, axis=1).astype(jnp.int32)
    best = jnp.min(dist, axis=1)
    cols = jax.lax.broadcasted_iota(jnp.int32, dist.shape, 1)
    second = jnp.min(jnp.where(cols == arg[:, None], jham.BIG, dist), axis=1)
    idx = jnp.where(best < jham.BIG, arg, -1)
    ok = fvalid & (best <= max_dist) & (idx >= 0)
    if ratio < 1.0:
        ok = ok & (best < ratio * second)
    return idx, best, ok


def _camera(c) -> JCamera:
    if c.model == KANNALA_BRANDT8:
        return JCamera.kannala_brandt8(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k=list(c.k), bf=c.bf, width=c.width,
                                       height=c.height)
    return JCamera.pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, bf=c.bf, width=c.width, height=c.height)


def run_reference(which: str, n_frames: int | None = None, verbose: bool = False) -> dict:
    """The reference on its accelerator branch (its gated matcher as
    `gated_match_dense`) over the port's frames of phase `which`: per-frame states, the IMU initialization (frame and log
    record), keyframes, ATE over the run, on the frame before the
    initialization and after it (its full inertial BA moves the map) (SE(3);
    mono also Sim(3) and the path ratio)."""
    tcfg, tcam, frames = profile.slice6_frames(which, "cpu", n_frames)
    cfg = reference_config(which)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    cam = _camera(tcam)
    frames = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in fr.items()} for fr in frames]
    mp_ = [(jax, "default_backend", lambda: "tpu"), (jham, "gated_match_pallas", gated_match_dense)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in mp_]
    for obj, name, val in mp_:
        setattr(obj, name, val)
    try:
        sysm = None
        if which == "mono_vi":
            sysm = JSystem(cam, cfg)
            tracker = sysm.tracker
        else:
            tracker = jtr.Tracker(cam, cfg, T_rl=profile.fisheye_rig() if which.startswith("fisheye") else None)
            tracker.streaming = which.startswith("fisheye")
        states, init_frame, mono_init, ate_init, ate_pre = [], None, None, None, None
        gt = np.stack([f["p_w"] for f in frames])
        for i, fr in enumerate(frames):
            if which.startswith("fisheye"):
                info = tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
            elif which == "mono_vi":
                info = sysm.track_monocular(fr["img_l"], fr["t"], imu_batch=fr["imu"])
            else:
                info = tracker.process_rgbd(fr["img_l"], fr["depth"], fr["t"], imu=fr["imu"])
            states.append(info["state"])
            if verbose:
                print(i, info["state"], info["n_kf"], info["n_inliers"], tracker.imu_ready, flush=True)
            if mono_init is None and info["state"] == jtr.TrackingState.OK:
                mono_init = i
            if tracker.use_imu and not tracker.imu_ready and mono_init is not None and i >= mono_init + 2:
                ate_pre = peek_ate(tracker, frames, with_scale=which == "mono_vi")  # the last one before the init
            if tracker.use_imu and tracker.imu_ready and init_frame is None:
                init_frame = i
                ate_init = peek_ate(tracker, frames, with_scale=which == "mono_vi")
                if verbose:
                    print("IMU initialized:", ate_init, tracker.imu_init_log[-1], flush=True)
        tracker.finalize()
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)
    est, gt_est = tracked_positions(tracker, frames)
    out = dict(which=which, states=states, n_kf=int(tracker.n_kf), init_frame=init_frame, mono_init=mono_init,
               n_recorded=len(est), ate=jtio.ate_rmse(est, gt_est), ate_init=ate_init, ate_pre=ate_pre,
               imu_log=tracker.imu_init_log,
               path=float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()),
               ok=sum(s == jtr.TrackingState.OK for s in states))
    if which == "mono_vi":
        out.update(ate_sim3=jtio.ate_rmse(est, gt_est, with_scale=True), ratio=path_ratio(est, gt_est))
    return out


def fiba_from_identical_input(which: str) -> dict:
    """The reference over `which`'s frames ("fisheye_vi": phase 10b's;
    "stereo_vi": phase 5's, slice_config_vi() on slice_camera()) up to its
    IMU initialization; there the port's `_try_imu_init` runs first, from
    the reference's state. Both full inertial BAs start from the same map
    (returned: the largest difference of the states before them) and are
    compared by how far they move the keyframes, the ATE after them and
    the visual-inertial objective of each solution (the port's evaluator,
    tests/test_torch_tracker_vi._vi_objective)."""
    from test_torch_mono_inertial import install, np_tree, summary_init
    from test_torch_tracker_vi import _vi_objective

    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.utils import convert

    if which == "stereo_vi":
        tcfg, tcam = profile.slice_config_vi(), profile.slice_camera()
        frames = profile.vi_frames(tcam, tcfg, 40, "cpu")
        cfg, kw = reference_config("fisheye_vi"), {}
        cfg = dataclasses.replace(cfg, width=tcfg.width, height=tcfg.height)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    else:
        tcfg, tcam, frames = profile.slice6_frames(which, "cpu", 40)
        cfg, kw = reference_config(which), dict(T_rl=profile.fisheye_rig())
    frames = [{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in fr.items()} for fr in frames]
    saved = [(jax, "default_backend", jax.default_backend), (jham, "gated_match_pallas", jham.gated_match_pallas)]
    jax.default_backend, jham.gated_match_pallas = (lambda: "tpu"), gated_match_dense
    try:
        jt = jtr.Tracker(_camera(tcam), cfg, **kw)
        tt = Tracker(tcam, tcfg, "cpu", **kw)
        res = {}

        def recorded(tr, side):
            orig = tr._full_inertial_ba

            def fiba():
                res[side + "_pre"], res[side + "_ate_pre"] = summary_init(tr), peek_ate(tr, frames)
                orig()
                res[side + "_post"], res[side + "_ate_post"] = summary_init(tr), peek_ate(tr, frames)
            tr._full_inertial_ba = fiba

        recorded(jt, "j")
        recorded(tt, "t")
        orig_init = jt._try_imu_init

        def init():
            install(tt, jt)
            tt._try_imu_init()
            orig_init()

        jt._try_imu_init = init
        for fr in frames:
            jt.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])
            if jt.imu_ready:
                break
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)
    n, W = tt.n_kf, 16
    window = np.clip(np.arange(W), 0, n - 1).astype(np.int32)
    fixed = np.zeros(W, bool)
    fixed[0] = True
    fixed[1:] |= window[1:] <= window[:-1]
    chain, mask = tt._kf_chain(window)
    pin = dataclasses.replace(tcam, model=0)

    def objective(ks, ps, ls):
        return _vi_objective(pin, tcfg, ks, ps, ls, torch.as_tensor(window), torch.as_tensor(fixed), chain,
                             torch.as_tensor(mask), tt.gravity_w, tt.ext)

    out = dict(n_kf=n, pre_diff=max(float(np.abs(res["j_pre"][k] - res["t_pre"][k]).max()) for k in ("kt", "v", "x")),
               ate_pre=res["j_ate_pre"], ate_post=(res["j_ate_post"], res["t_ate_post"]),
               moved=tuple(float(np.linalg.norm(res[s + "_post"]["kt"] - res[s + "_pre"]["kt"], axis=1).max())
                           for s in ("j", "t")),
               objective=(objective(convert.keyframe_store(np_tree(jt.kstore)), convert.point_store(np_tree(jt.pstore)),
                                    convert.line_store(np_tree(jt.lstore))),
                          objective(tt.kstore, tt.pstore, tt.lstore)))
    return out


def describe(r: dict) -> str:
    rec = next((x for x in r["imu_log"] if x["accepted"]), None)
    extra = ""
    if r["which"] == "mono_vi":
        extra = f", Sim(3) ATE {r['ate_sim3']:.4f} m, last-20 path ratio {r['ratio']:.4f}, mono init {r['mono_init']}"
    return (f"reference {r['which']}: {r['ok']}/{len(r['states'])} frames OK, {r['n_recorded']} recorded, "
            f"{r['n_kf']} keyframes, IMU init at frame "
            f"{r['init_frame']} (scale {None if rec is None else rec.get('scale')}, gravity "
            f"{None if rec is None else rec.get('gravity_angle_deg')} deg, n_kf {None if rec is None else rec['n_kf']}), "
            f"ATE {r['ate']:.4f} m over {r['path']:.2f} m, ATE on the frame before the init {r['ate_pre']}, after the "
            f"init's full inertial BA {r['ate_init']}{extra}; "
            f"states {r['states']}")


if __name__ == "__main__":
    print(describe(run_reference(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None, verbose=True)),
          flush=True)
