"""Where two builds of the port part on the same frames: the rounding tracer.

Run from the repository root, on a GPU (through `utils/profile.py`):
  python3 -m pli_slam_tpu_torch.utils.profile --rounding loop|mono-vi|one-ulp|vi [--variants DIR]

`loop` runs chip_smoke.py phase 6a's frames (`profile.loop_frames`) up to
the planted closure (N_FRAMES_LOOP frames) in a
`cuda_graphs=False` tracker (graphs and eager are bit-identical, phase 15)
once with the kernels as built from this tree and once for every rot3
source in DIR (`*.cu`, each with rot3.cu's C entry; `write_variants` writes
the polar branch with its store rounded toward zero, up and down), and
once more with this tree's kernels and the pose one ulp off after frame 1
(`profile.nudge_pose`, chip_smoke.py's one-ulp run). Per
frame it records, in the order the frame computes them: tracking's gated
matches and inliers (`track_step`), the keyframe decision and its inputs
(`need_keyframe`), every windowed BA (the window; per LM stage the cost of
each iterate, whether the next step was taken, the observations the
chi2 gate drops and how near the gate the nearest one lay; what the prune
erased from the store), the local map's ids, the pose, and the keyframes'
positions. Against the first run it prints the first frame where each
record parts, the first record that parts, and frame by frame how the
camera's and the keyframes' positions grow apart, and each run's ATE
before the closure. `mono-vi` runs chip_smoke.py phase 11's frames
(`profile.slice6_frames("mono_vi")`) through a `cuda_graphs=False` tracker
twice: the two-view's smallest eigenvectors through svd_small's kernel
(the card's route), then through `torch.linalg.eigh` (the CPU's route, run
eagerly on the card); with the same records (mono frames run on the host
path: tracking, keyframes, windowed BA, the two-view's hypotheses and
winner) and the IMU initialization's record.

`one-ulp` (`main_ulp`) runs chip_smoke.py's phases 5, 7, 12 and 14b under
CUDA graphs, each twice in one process: as the phase runs it and with the
pose one ulp toward zero after frame 1, recording after each frame what a
graph run lets the host read (pose, keyframes, local map, state); it
prints both ATEs, where the runs part, and whether the outcome is robust
(keyframes within KF_ROBUST_M, ATE within ATE_ROBUST) or re-rolled. The
phases past an IMU initialization (5, 12, 14b) run that pair twice: with
the visual-inertial BA's reduced system in float32 (the reference's
arithmetic, `vi_precision`) and as shipped (float64 on CUDA). `vi`
(`main_vi`) runs those three phases eagerly, the same four runs each, with
the stage wrappers recording: besides the verdicts it prints the first
position record where the runs lie more than PART_M apart (`vi_parting`:
tracking, windowed BA, each visual-inertial BA iteration, the frame's pose)
and how far apart they went in and came out, the IMU initialization's MAP
problems side by side, and the first visual-inertial BAs iteration by
iteration (costs, step norms and the clamp at 3, `bad`, and how far the
float32 system and its step lie from a float64 one formed from the same
linearization: `vi_iteration_record`).

The records of every run are written to `chiprun_out/rounding/<mode>_<run>.pkl.gz`.
It runs on an earlier tree too: copy this file and profile.py over that
tree's (`git archive` the parent into `build/parent`).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import gzip
import pickle
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

OUT = Path("chiprun_out") / "rounding"
ROUNDINGS = {"toward_zero": "rz", "up": "ru", "down": "rd"}
MARGIN_NEAR = 1e-4  # an observation's chi2 within this share of its gate is "at the gate"


def write_variants(dst: Path, src: Path | None = None) -> list[Path]:
    """rot3's source (`src`, default this tree's) with its polar branch's
    store rounded toward zero, up and down (`ROT3_STORE`), as files
    `polar_<rounding>.cu` in `dst`."""
    from pli_slam_tpu_torch.ops.kernels import rot3

    text = Path(src or rot3._SRC).read_text()
    dst.mkdir(parents=True, exist_ok=True)
    out = []
    for name, mode in ROUNDINGS.items():
        p = dst / f"polar_{name}.cu"
        p.write_text(f"// rot3.cu with the polar branch's store rounded {name.replace('_', ' ')}\n"
                     f"__host__ __device__ inline float rot3_store_{mode}(double x) {{\n"
                     f"#ifdef __CUDA_ARCH__\n  return __double2float_{mode}(x);\n#else\n"
                     f"  return static_cast<float>(x);\n#endif\n}}\n"
                     f"#define ROT3_STORE(x) rot3_store_{mode}(x)\n" + text)
        out.append(p)
    return out


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gate_margin(chi2, mask, gate: float) -> tuple[float, int]:
    """(the least |chi2 / gate - 1| over the masked observations, how many lie within MARGIN_NEAR of the gate)."""
    c = _np(chi2).astype(np.float64)[_np(mask).astype(bool)]
    if c.size == 0:
        return float("inf"), 0
    rel = np.abs(c / gate - 1.0)
    return float(rel.min()), int((rel < MARGIN_NEAR).sum())


def _centres(R, t) -> np.ndarray:
    """Camera centres -R^T t [n, 3], float64, of poses R [n, 3, 3], t [n, 3]."""
    R, t = _np(R).astype(np.float64), _np(t).astype(np.float64)
    return -np.einsum("kji,kj->ki", R, t)


def vi_iteration_record(cam, prob, idx_p, idx_l, R, t, v, bg, ba_, pts, lns, cfg, imu_cfg, damping,
                        dtype=None) -> dict:
    """What one `vi_ba_iteration` decides, at its input state: the reduced
    system formed in float32 and in float64 from the same linearization, each
    solved (`vi_ba.solve_step`). Records the visual and the chain factors'
    costs, the largest keyframe step before the clamp, how many keyframes
    the clamp at 3 shortened and `bad`, all of the precision the iteration
    ran in (`dtype`, default `vi_ba.system_dtype`); `sys_err`, the largest
    entry of the float32 system's difference from the float64 one, both
    equilibrated by the float64 diagonal; `step_err`, |step32 - step64| /
    |step64|."""
    from pli_slam_tpu_torch.solve import vi_ba as vib

    path = vib.system_dtype(R) if dtype is None else dtype
    sys, steps = {}, {}
    for dt in (torch.float32, torch.float64):
        sys[dt] = vib.reduced_system(cam, prob, idx_p, idx_l, R, t, v, bg, ba_, pts, lns, cfg, imu_cfg, damping, dt)
        steps[dt] = vib.solve_step(sys[dt][0], sys[dt][1])
    S32, S64 = sys[torch.float32][0].double(), sys[torch.float64][0]
    d = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(S64), min=1e-12))
    s32, s64 = steps[torch.float32][0].double(), steps[torch.float64][0]
    r_f, info = sys[path][5]
    _, bad, norms = steps[path]
    return dict(vis_cost=float(sys[path][4]), chain_cost=float(torch.einsum("ka,kab,kb->", r_f, info, r_f)),
                step_max=float(norms.max()), clamped=int((norms > 3.0).sum()), bad=bool(bad),
                sys_err=float(((S32 - S64) * d[:, None] * d[None, :]).abs().max()),
                step_err=float(torch.linalg.norm(s32 - s64) / torch.clamp(torch.linalg.norm(s64), min=1e-30)))


@contextlib.contextmanager
def vi_precision(dtype: torch.dtype | None):
    """`vi_ba.vi_ba_iteration` with its reduced system in `dtype` for the
    block (None: the default, `vi_ba.system_dtype`): float32 is the
    reference's arithmetic and the port's before it formed the system in
    float64 on CUDA. Enter it before the tracker is built, so that its
    captures take it, and inside `Recorder.patched`, so that the recorder's
    wrapper sees the dtype."""
    from pli_slam_tpu_torch.solve import vi_ba as vib

    if dtype is None:
        yield
        return
    orig = vib.vi_ba_iteration
    vib.vi_ba_iteration = functools.partial(orig, dtype=dtype)
    try:
        yield
    finally:
        vib.vi_ba_iteration = orig


class Recorder:
    """Records a tracker's decisions frame by frame by wrapping the step
    functions it calls (eager runs only: inside a captured graph a wrapper
    runs once, at the capture). `events[i]` is frame i's list of (name,
    value) in the order the frame made them."""

    def __init__(self):
        self.events: list[list[tuple[str, object]]] = []
        self._ba = None
        self._viba = None

    def begin(self, i: int) -> None:
        self.events.append([])

    def add(self, name: str, value) -> None:
        if self.events:
            self.events[-1].append((name, value))

    def end(self, tracker) -> None:
        self.add("local_pt", _np(tracker._local_pt))
        self.add("pose", np.concatenate([_np(tracker.R).reshape(-1), _np(tracker.t)]).astype(np.float64))
        n = tracker.n_kf
        R, t = _np(tracker.kstore.R[:n]).astype(np.float64), _np(tracker.kstore.t[:n]).astype(np.float64)
        self.add("kf_pos", np.concatenate([-np.einsum("kji,kj->ki", R, t),
                                           _np(tracker.kstore.stamp[:n]).astype(np.float64)[:, None],
                                           _np(tracker.kstore.valid[:n]).astype(np.float64)[:, None]], 1))

    @contextlib.contextmanager
    def patched(self):
        from pli_slam_tpu_torch.frontend import step as step_mod
        from pli_slam_tpu_torch.solve import ba as ba_mod
        from pli_slam_tpu_torch.solve import imu_init as imu_init_mod
        from pli_slam_tpu_torch.solve import vi_ba as vib

        saved = [(step_mod, "track_step"), (step_mod, "need_keyframe"), (step_mod, "local_ba"),
                 (ba_mod, "_solve_ba_stage"), (ba_mod, "ba_iteration"), (step_mod, "track_step_inertial"),
                 (imu_init_mod, "inertial_optimization"), (step_mod, "local_inertial_ba"),
                 (vib, "vi_ba_iteration")]
        orig = {name: getattr(mod, name) for mod, name in saved}

        def track_step(*a, **k):
            out = orig["track_step"](*a, **k)
            R, t, pt_idx, pt_in, ln_idx, ln_in, n_in = out[:7]
            self.add("matches", np.concatenate([_np(pt_idx).astype(np.int64), _np(pt_in).astype(np.int64),
                                                _np(ln_idx).astype(np.int64), _np(ln_in).astype(np.int64)]))
            self.add("n_in", int(n_in))
            return out

        def need_keyframe(cfg, ok, n_in, last, n_kf, fs, allow):
            need = orig["need_keyframe"](cfg, ok, n_in, last, n_kf, fs, allow)
            self.add("decision", (int(n_in), int(last), int(fs), bool(need),
                                  float(np.float32(cfg.tracking.kf_ref_ratio) * np.float32(max(int(last), 1)))))
            return need

        def local_ba(cam, cfg, kstore, pstore, lstore, window, fixed, iters=None):
            win = window.long()
            self._ba = {"window": _np(window).tolist(), "fixed": _np(fixed).tolist(), "stages": [],
                        "in": _centres(kstore.R[win], kstore.t[win])}
            before = (_np(kstore.obs_pt[win]) >= 0).sum() + (_np(kstore.obs_ln[win]) >= 0).sum()
            out = orig["local_ba"](cam, cfg, kstore, pstore, lstore, window, fixed, iters)
            after = (_np(out[0].obs_pt[win]) >= 0).sum() + (_np(out[0].obs_ln[win]) >= 0).sum()
            self._ba["erased"] = int(before - after)
            self._ba["out"] = _centres(out[0].R[win], out[0].t[win])
            self.add("ba", self._ba)
            self._ba = None
            return out

        def _solve_ba_stage(cam, prob, cfg, iters, group=None):
            rec = None
            if self._ba is not None:
                rec = {"costs": [], "lams": [], "n_obs": int(_np(prob.po_mask).sum() + _np(prob.lo_mask).sum())}
                self._ba["stages"].append(rec)
            res = orig["_solve_ba_stage"](cam, prob, cfg, iters, group)
            if rec is not None:
                rec["final_cost"] = float(res.cost)
                mp = _gate_margin(res.po_chi2, prob.po_mask, cfg.prune_chi2_pt)
                ml = _gate_margin(res.lo_chi2, prob.lo_mask, cfg.prune_chi2_ln)
                rec["gate_margin"] = min(mp[0], ml[0])
                rec["at_gate"] = mp[1] + ml[1]
                rec["dropped"] = int((_np(prob.po_mask) & (_np(res.po_chi2) >= cfg.prune_chi2_pt)).sum()
                                     + (_np(prob.lo_mask) & (_np(res.lo_chi2) >= cfg.prune_chi2_ln)).sum())
                c, prev, taken = rec["costs"], float("inf"), []
                for x in c:  # _solve_ba_stage's test: an iterate worse than the last kept one is dropped
                    taken.append(not x > prev)
                    prev = prev if x > prev else x
                rec["taken"] = taken
            return res

        def ba_iteration(cam, prob, idx_p, idx_l, R, t, pts, lns, cfg, damping, group=None):
            out = orig["ba_iteration"](cam, prob, idx_p, idx_l, R, t, pts, lns, cfg, damping, group)
            if self._ba is not None and self._ba["stages"]:
                self._ba["stages"][-1]["costs"].append(float(out[4]))
                self._ba["stages"][-1]["lams"].append(float(damping))
            return out

        def track_step_inertial(*a, **k):
            out = orig["track_step_inertial"](*a, **k)
            _st, R, t, pt_idx, pt_in, ln_idx, ln_in, n_in = out[:8]
            self.add("matches", np.concatenate([_np(pt_idx).astype(np.int64), _np(pt_in).astype(np.int64),
                                                _np(ln_idx).astype(np.int64), _np(ln_in).astype(np.int64)]))
            self.add("n_in", int(n_in))
            self.add("track_pose", _centres(R[None], t[None])[0])
            return out

        def inertial_optimization(preint, chain_mask, R_wb, p_wb, v0, Rwg0, bg0, ba0, imu_cfg, **k):
            out = orig["inertial_optimization"](preint, chain_mask, R_wb, p_wb, v0, Rwg0, bg0, ba0, imu_cfg, **k)
            Rwg, s, bg, ba, v, costs = (_np(x).astype(np.float64) for x in out)
            self.add("imu_init", dict(fix_bias=bool(k.get("fix_bias", False)), g=Rwg @ [0.0, 0.0, -imu_cfg.gravity],
                                      s=float(s), bg=bg, ba=ba, v=v, costs=costs))
            return out

        def local_inertial_ba(cam, cfg, kstore, pstore, lstore, window, fixed, *a, **k):
            win = window.long()
            self._viba = {"window": _np(window).tolist(), "fixed": _np(fixed).tolist(), "iters": [],
                          "in": _centres(kstore.R[win], kstore.t[win])}
            out = orig["local_inertial_ba"](cam, cfg, kstore, pstore, lstore, window, fixed, *a, **k)
            self._viba["out"] = _centres(out[0].R[win], out[0].t[win])
            self.add("vi_ba", self._viba)
            self._viba = None
            return out

        def vi_ba_iteration(*a, **k):
            out = orig["vi_ba_iteration"](*a, **k)
            if self._viba is not None:
                self._viba["iters"].append(vi_iteration_record(*a, **k) | {"out": _centres(out[0], out[1])})
            return out

        wrappers = dict(track_step=track_step, need_keyframe=need_keyframe, local_ba=local_ba,
                        _solve_ba_stage=_solve_ba_stage, ba_iteration=ba_iteration,
                        track_step_inertial=track_step_inertial, inertial_optimization=inertial_optimization,
                        local_inertial_ba=local_inertial_ba, vi_ba_iteration=vi_ba_iteration)
        for mod, name in saved:
            setattr(mod, name, wrappers[name])
        try:
            yield self
        finally:
            for mod, name in saved:
                setattr(mod, name, orig[name])


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b or (a != a and b != b)


def _ba_decisions(ba: dict):
    """A windowed BA's discrete record: window, fixed, steps taken, drops, erased."""
    return (ba["window"], ba["fixed"], [s["taken"] for s in ba["stages"]], [s["dropped"] for s in ba["stages"]],
            ba["erased"])


def _named(events, name):
    return [v for k, v in events if k == name]


DISCRETE = ("matches", "n_in", "decision", "ba_decisions", "local_pt", "frame")


def compare(a: list, b: list) -> dict:
    """Two runs' events: the first frame and event where they part, the
    first frame each discrete record parts, and per frame the camera's and
    the common keyframes' position differences (m) and the discrete records
    that differ there."""
    first, first_by, rows = None, {}, []
    for i, (ea, eb) in enumerate(zip(a, b)):
        if first is None:
            for j, (x, y) in enumerate(zip(ea, eb)):
                if x[0] != y[0] or not _same(x[1], y[1]):
                    first = (i, j, x[0] if x[0] == y[0] else f"{x[0]} / {y[0]}")
                    break
            else:
                if len(ea) != len(eb):
                    first = (i, min(len(ea), len(eb)), "event count")
        differs = []
        for name in DISCRETE:
            if name == "ba_decisions":
                va, vb = [_ba_decisions(x) for x in _named(ea, "ba")], [_ba_decisions(x) for x in _named(eb, "ba")]
            else:
                va, vb = _named(ea, name), _named(eb, name)
            if not _same(va, vb):
                differs.append(name)
                first_by.setdefault(name, i)
        pa, pb = _named(ea, "pose"), _named(eb, "pose")
        cam = float("nan")
        if pa and pb:
            ca = -pa[-1][:9].reshape(3, 3).T @ pa[-1][9:]
            cb = -pb[-1][:9].reshape(3, 3).T @ pb[-1][9:]
            cam = float(np.linalg.norm(ca - cb))
        ka, kb = _named(ea, "kf_pos"), _named(eb, "kf_pos")
        kf, n_kf = float("nan"), (0, 0)
        if ka and kb:
            ka, kb = ka[-1], kb[-1]
            n_kf = (len(ka), len(kb))
            n = min(len(ka), len(kb))
            same = (ka[:n, 3] == kb[:n, 3]) & (ka[:n, 4] > 0) & (kb[:n, 4] > 0)
            if same.any():
                kf = float(np.linalg.norm(ka[:n, :3][same] - kb[:n, :3][same], axis=1).max())
            first_by.setdefault("keyframe stamps", None)
            if not np.array_equal(ka[:n, 3], kb[:n, 3]) or len(ka) != len(kb):
                if first_by["keyframe stamps"] is None:
                    first_by["keyframe stamps"] = i
        rows.append(dict(frame=i, cam=cam, kf=kf, n_kf=n_kf, differs=differs))
    first_by = {k: v for k, v in first_by.items() if v is not None}
    return dict(first=first, first_by=first_by, rows=rows)


def print_comparison(label: str, cmp: dict, a: list, b: list) -> None:
    first = cmp["first"]
    if first is None:
        print(f"rounding {label}: the runs are bit-identical", flush=True)
        return
    i, j, name = first
    print(f"rounding {label}: first parting at frame {i}, event {j} ({name}); first frame each record parts: "
          + ", ".join(f"{k} {v}" for k, v in sorted(cmp["first_by"].items(), key=lambda kv: kv[1])), flush=True)
    shown, last_cm = 0, -1
    for r in cmp["rows"]:
        cm = int(np.floor(np.log10(max(r["kf"], 1e-9)))) if r["kf"] == r["kf"] else -9
        notable = ("decision" in r["differs"] or "ba_decisions" in r["differs"] or cm > last_cm
                   or r["n_kf"][0] != r["n_kf"][1] or r["frame"] % 20 == 0)
        if not notable or shown >= 60:
            continue
        last_cm = max(last_cm, cm)
        shown += 1
        extra = ""
        if "decision" in r["differs"]:
            da, db = _named(a[r["frame"]], "decision"), _named(b[r["frame"]], "decision")
            extra += f" decision {da} / {db}"
        if "ba_decisions" in r["differs"]:
            ba_a, ba_b = _named(a[r["frame"]], "ba"), _named(b[r["frame"]], "ba")
            extra += " BA " + " / ".join(
                "; ".join(f"taken {s['taken']} dropped {s['dropped']} margin {s['gate_margin']:.1e}"
                          for s in x[0]["stages"]) + f" erased {x[0]['erased']}" for x in (ba_a, ba_b) if x)
        print(f"  frame {r['frame']:3d}: camera {r['cam'] * 1e3:9.4f} mm, keyframes {r['kf'] * 1e3:9.4f} mm, "
              f"n_kf {r['n_kf'][0]}/{r['n_kf'][1]}, differ: {','.join(r['differs']) or '-'}{extra}", flush=True)


def save(name: str, run: dict) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    with gzip.open(OUT / f"{name}.pkl.gz", "wb") as f:
        pickle.dump(run, f)


@contextlib.contextmanager
def rot3_source(src: Path | None):
    """rot3 built from `src` (None: this tree's) for the block."""
    from pli_slam_tpu_torch.ops.kernels import rot3

    if src is None:
        yield
        return
    rot3.build()
    saved = rot3._lib
    rot3._lib = rot3.load(src)
    try:
        yield
    finally:
        rot3._lib = saved


def trace_loop(dev, frames_data, nudge_after: int | None = None) -> dict:
    """Phase 6a's frames up to the closure in an eager tracker, recorded,
    with `profile.nudge_pose` after frame `nudge_after` (chip_smoke.py's
    one-ulp run)."""
    from pli_slam_tpu_torch.utils import profile, synthetic

    cfg, cam, traj, frames = frames_data
    rec = Recorder()
    t0 = time.perf_counter()
    with rec.patched():  # the tracker's stages are made inside: they call the wrappers
        cr = profile._ClosureRun(cam, cfg, dev, traj, "gba", cuda_graphs=False)
        tracker = cr.tracker
        for i, fr in enumerate(frames[:profile.N_FRAMES_LOOP]):
            rec.begin(i)
            cr.frame(fr, i)
            if i == nudge_after:
                profile.nudge_pose(tracker)
            rec.end(tracker)
    profile._sync(dev)
    gt = np.stack([fr["p_w"] for fr in frames[:profile.N_FRAMES_LOOP]])
    pend, done = list(tracker._traj_pending), list(tracker._traj_done)
    ate = synthetic.ate_rmse(tracker.positions(), gt)
    tracker._traj_pending, tracker._traj_done = pend, done
    return dict(events=rec.events, ate=ate, n_kf=tracker.n_kf, kf_err=profile.kf_error(tracker, traj),
                n_loops=len(cr.loop_frames), s=time.perf_counter() - t0)


def trace_mono_vi(dev, route: str, frames_data) -> dict:
    """Phase 11's frames in an eager tracker with the two-view's smallest
    eigenvectors through `route` ("svd_small" or "eigh"), recorded."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker, TrackingState
    from pli_slam_tpu_torch.ops.kernels import svd_small
    from pli_slam_tpu_torch.solve import twoview
    from pli_slam_tpu_torch.utils import profile
    from pli_slam_tpu_torch.utils import trajectory as tio

    cfg, cam, frames = frames_data
    rec = Recorder()
    orig_eig = svd_small.smallest_eigvec
    init_at = imu_at = ate_pre = None
    t0 = time.perf_counter()

    def eig(A):
        return svd_small.smallest_eigvec_reference(A) if route == "eigh" else orig_eig(A)

    with rec.patched(), contextlib.ExitStack() as stack:
        svd_small.smallest_eigvec = eig
        stack.callback(setattr, svd_small, "smallest_eigvec", orig_eig)
        from pli_slam_tpu_torch.frontend import step as step_mod
        orig_init = step_mod.mono_init

        def mono_init(*a, **k):
            out = orig_init(*a, **k)
            rec.add("two_view", _np(out[-1]).tolist())
            return out

        step_mod.mono_init = mono_init
        stack.callback(setattr, step_mod, "mono_init", orig_init)
        tracker = Tracker(cam, cfg, dev, cuda_graphs=False)  # its stages call the wrappers
        for i, fr in enumerate(frames):
            rec.begin(i)
            info = tracker.process_mono(fr["img_l"], fr["t"], imu=fr["imu"])
            rec.add("info", (str(info["state"]), info.get("n_inliers"), info.get("n_kf"), info.get("new_landmarks")))
            rec.end(tracker)
            if init_at is None and info["state"] == TrackingState.OK:
                init_at = i
            if tracker.imu_ready and imu_at is None:
                imu_at = i
            if not tracker.imu_ready and init_at is not None and i >= init_at + 2:
                ate_pre = profile.peek_ate(tracker, frames, with_scale=True)
    est, gt = profile.tracked_positions(tracker, frames)
    log = tracker.imu_init_log[-1] if tracker.imu_init_log else {}
    return dict(events=rec.events, mono_init=init_at, imu_init=imu_at, ate_pre=ate_pre,
                ate_sim3=tio.ate_rmse(est, gt, with_scale=True), scale=log.get("scale"), n_kf=tracker.n_kf,
                imu_log=[{k: v for k, v in r.items() if isinstance(v, (int, float, bool, str))}
                         for r in tracker.imu_init_log], s=time.perf_counter() - t0)


ULP_PHASES = ("5", "7", "12", "14b")
VI_PHASES = ("5", "12", "14b")  # the phases that run past an IMU initialization
# the visual-inertial BA's reduced system: the reference's float32, and the port's default (float64 on CUDA)
PRECISIONS = (("float32", torch.float32), ("shipped", None))
N_BENCH_FLAGSHIP = 76  # chip_smoke.py's 14b: bench.py's flagship run through the IMU initialization
KF_ROBUST_M = 1e-3  # a one-ulp run is robust when its keyframes stay within this of the plain run's
ATE_ROBUST = 0.10  # and its ATE within this share of the plain run's
PART_M = 1e-3  # `vi_parting`: two runs part where a position record lies this far apart


def ulp_data(dev, phase: str) -> tuple:
    """The frames and configuration of chip_smoke.py's phase 5 (stereo-
    inertial, `Tracker.process(imu=)`), 7 (RGB-D through `System.track_rgbd`),
    12 (RGB-D-inertial, `Tracker.process_rgbd(imu=)`) or 14b (bench.py's
    flagship run, `scripts.bench.run_flagship`, on phase 6a's frames)."""
    from pli_slam_tpu_torch.utils import profile, synthetic

    if phase == "5":
        cfg, cam = profile.slice_config_vi(), profile.slice_camera()
        return cfg, cam, profile.vi_frames(cam, cfg, profile.N_FRAMES_VI, dev)
    if phase == "7":
        cfg, cam = profile.rgbd_config(), profile.rgbd_camera()
        return cfg, cam, list(synthetic.make_sequence(cam, profile.N_FRAMES_RGBD, dev, fps=cfg.fps, with_depth=True))
    if phase == "12":
        return profile.slice6_frames("rgbd_vi", dev)
    return profile.flagship_config(), profile.slice_camera(), profile.loop_frames(dev)[3][:N_BENCH_FLAGSHIP]


def trace_phase(dev, phase: str, data, nudge_after: int | None = None, cuda_graphs: bool | None = None,
                vi_dtype: torch.dtype | None = None) -> dict:
    """One of `ULP_PHASES` as chip_smoke.py runs it, under CUDA graphs (the
    default on a GPU) or eagerly (`cuda_graphs=False`), with
    `profile.nudge_pose` after frame `nudge_after` and the visual-inertial
    BA's reduced system in `vi_dtype` (`vi_precision`). Each frame records
    what `Recorder.end` reads (pose, keyframes, local map) and the tracker's
    state and keyframe count after it; eagerly the stage wrappers record
    too (tracking, keyframe decisions, windowed and visual-inertial BA
    iteration by iteration, the IMU initialization's MAP problem): under
    graphs a wrapper runs once, at its capture, so they are not installed.
    Returns the records, the ATE as the phase computes it, the keyframes
    and the frame the IMU initialized (phases 5, 12 and 14b)."""
    from pli_slam_tpu_torch.frontend.tracker import Tracker
    from pli_slam_tpu_torch.system import System
    from pli_slam_tpu_torch.utils import profile, synthetic
    from pli_slam_tpu_torch.utils import trajectory as tio

    cfg, cam, frames = data
    rec, imu_at = Recorder(), None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if cuda_graphs is False:
            stack.enter_context(rec.patched())  # before the tracker: its stages call the wrappers
        stack.enter_context(vi_precision(vi_dtype))
        if phase == "7":
            sysm = System(cam, cfg, device=dev)
            tracker = sysm.tracker
            tracker.streaming = True
            step = lambda fr: sysm.track_rgbd(fr["img_l"], fr["depth"], fr["t"])  # noqa: E731
        else:
            tracker = Tracker(cam, cfg, dev, cuda_graphs=cuda_graphs)
            if phase == "12":
                step = lambda fr: tracker.process_rgbd(fr["img_l"], fr["depth"], fr["t"], imu=fr["imu"])  # noqa: E731
            else:
                tracker.streaming = True
                step = lambda fr: tracker.process(fr["img_l"], fr["img_r"], fr["t"], imu=fr["imu"])  # noqa: E731
        for i, fr in enumerate(frames):
            rec.begin(i)
            step(fr)
            if i == nudge_after:
                profile.nudge_pose(tracker)
            rec.add("frame", (str(tracker.state), tracker.n_kf, bool(tracker.imu_ready)))
            rec.end(tracker)
            if imu_at is None and tracker.imu_ready:
                imu_at = i
        gt = np.stack([fr["p_w"] for fr in frames])
        if phase == "7":
            sysm.shutdown()
            ate = tio.ate_rmse(np.stack([p for _, _, p in tracker.trajectory]), gt)
        elif phase == "12":
            tracker.finalize()
            ate = synthetic.ate_rmse(*profile.tracked_positions(tracker, frames))
        else:
            tracker.finalize()
            ate = synthetic.ate_rmse(tracker.positions(), gt)
    profile._sync(dev)
    return dict(events=rec.events, ate=float(ate), n_kf=tracker.n_kf, imu_at=imu_at, s=time.perf_counter() - t0)


def ulp_verdict(plain: dict, nudged: dict, cmp: dict) -> dict:
    """Robust when the keyframes stay within KF_ROBUST_M of each other over
    the run and the ATEs within ATE_ROBUST of the plain one; else
    re-rolled. Also the largest keyframe and camera distances and the
    first frame the keyframes lie more than KF_ROBUST_M apart."""
    kf = [r["kf"] for r in cmp["rows"] if r["kf"] == r["kf"]]
    cam = [r["cam"] for r in cmp["rows"] if r["cam"] == r["cam"]]
    far = next((r["frame"] for r in cmp["rows"] if r["kf"] == r["kf"] and r["kf"] > KF_ROBUST_M), None)
    kf_max = max(kf, default=0.0)
    robust = kf_max <= KF_ROBUST_M and abs(nudged["ate"] - plain["ate"]) <= ATE_ROBUST * plain["ate"]
    return dict(kf_max=kf_max, cam_max=max(cam, default=0.0), kf_far_at=far,
                verdict="robust" if robust else "re-rolled")


def _apart(x, y) -> float:
    """The largest row distance of two [n, 3] position arrays (nan if their shapes differ)."""
    if x is None or y is None or np.shape(x) != np.shape(y):
        return float("nan")
    return float(np.linalg.norm(np.asarray(x) - np.asarray(y), axis=-1).max())


def position_steps(events: list) -> list:
    """A run's position records in the order the frames made them: (frame,
    label, in, out), `in` and `out` [n, 3] camera centres before and after
    the step (`in` None where the step has no input of its own): tracking
    (the pose solve after the last frame's pose), each windowed BA, each
    iteration of each visual-inertial BA, each frame's final pose."""
    out, last = [], None
    for i, evs in enumerate(events):
        for name, v in evs:
            if name == "track_pose":
                out.append((i, "tracking", last, v[None]))
            elif name == "ba":
                out.append((i, f"windowed BA {v['window']}", v["in"], v["out"]))
            elif name == "vi_ba":
                prev = v["in"]
                for k, it in enumerate(v["iters"]):
                    out.append((i, f"VI BA {v['window']} iteration {k}", prev, it["out"]))
                    prev = it["out"]
            elif name == "pose":
                last = _centres(v[:9].reshape(1, 3, 3), v[None, 9:])
                out.append((i, "pose", None, last))
    return out


def vi_parting(a: list, b: list) -> dict | None:
    """The first position record (`position_steps`) where two runs lie more
    than PART_M apart, with how far apart they went in and came out; or
    where their records stop matching. None if they never part so far."""
    for sa, sb in zip(position_steps(a), position_steps(b)):
        if sa[:2] != sb[:2]:
            return dict(frame=sa[0], label=f"{sa[1]} / {sb[1]}", d_in=float("nan"), d_out=float("nan"))
        d_out = _apart(sa[3], sb[3])
        if not d_out <= PART_M:
            return dict(frame=sa[0], label=sa[1], d_in=_apart(sa[2], sb[2]), d_out=d_out)
    return None


def imu_init_apart(a: list, b: list) -> list:
    """The IMU initializations' MAP problems of two runs side by side: for
    each pair, the frame, the gravity directions' angle (degrees), the
    largest velocity, gyro and accelerometer bias differences, each run's
    first and last cost."""
    rows = []
    ra = [(i, v) for i, evs in enumerate(a) for name, v in evs if name == "imu_init"]
    rb = [(i, v) for i, evs in enumerate(b) for name, v in evs if name == "imu_init"]
    for (i, x), (j, y) in zip(ra, rb):
        cos = float(x["g"] @ y["g"] / max(np.linalg.norm(x["g"]) * np.linalg.norm(y["g"]), 1e-30))
        rows.append(dict(frame=(i, j), fix_bias=x["fix_bias"], g_deg=float(np.degrees(np.arccos(np.clip(cos, -1, 1)))),
                         v=float(np.abs(x["v"] - y["v"]).max()) if x["v"].shape == y["v"].shape else float("nan"),
                         bg=float(np.abs(x["bg"] - y["bg"]).max()), ba=float(np.abs(x["ba"] - y["ba"]).max()),
                         costs=(x["costs"][[0, -1]].tolist(), y["costs"][[0, -1]].tolist())))
    return rows


def print_vi_windows(label: str, a: list, b: list, n_windows: int = 6) -> None:
    """The first `n_windows` visual-inertial BAs of two runs, iteration by
    iteration: the keyframes' distance after it, each run's largest step
    and how many steps the clamp shortened, `bad`, the costs, and run a's
    float32 system error and step error (`vi_iteration_record`)."""
    wa = [(i, v) for i, evs in enumerate(a) for name, v in evs if name == "vi_ba"]
    wb = [(i, v) for i, evs in enumerate(b) for name, v in evs if name == "vi_ba"]
    for (i, x), (_, y) in list(zip(wa, wb))[:n_windows]:
        print(f"  {label} frame {i}: VI BA window {x['window']} (fixed {x['fixed']}), in "
              f"{_apart(x['in'], y['in']) * 1e3:.4f} mm apart", flush=True)
        for k, (p, q) in enumerate(zip(x["iters"], y["iters"])):
            print(f"    iteration {k}: out {_apart(p['out'], q['out']) * 1e3:10.4f} mm; step {p['step_max']:.4g} / "
                  f"{q['step_max']:.4g}, clamped {p['clamped']} / {q['clamped']}, bad {p['bad']} / {q['bad']}, "
                  f"visual cost {p['vis_cost']:.6g} / {q['vis_cost']:.6g}, chain cost {p['chain_cost']:.6g} / "
                  f"{q['chain_cost']:.6g}; float32 system off {p['sys_err']:.3e}, step off {p['step_err']:.3e}",
                  flush=True)


def run_pair(dev, phase: str, data, tag: str, smi: str, **kw) -> tuple[dict, dict, dict, dict]:
    """`trace_phase` plain and one ulp off after frame 1, saved as
    `<tag>_plain` / `<tag>_nudged`; prints both and the verdict. Returns
    (plain, nudged, compare, verdict)."""
    runs = {}
    for name, nudge in (("plain", None), ("nudged", 1)):
        runs[name] = trace_phase(dev, phase, data, nudge_after=nudge, **kw)
        gc.collect()  # the run's tracker, before the next run
        torch.cuda.synchronize(dev)
        save(f"{tag}_{name}", runs[name])
    a, b = runs["plain"], runs["nudged"]
    cmp = compare(a["events"], b["events"])
    v = ulp_verdict(a, b, cmp)
    for name, r in runs.items():
        print(f"rounding {tag} {name}: {len(r['events'])} frames in {r['s']:.1f} s, ATE {r['ate']:.4f} m, "
              f"{r['n_kf']} keyframes, IMU initialized at frame {r['imu_at']} [{smi}]", flush=True)
    print_comparison(f"{tag} plain vs nudged", cmp, a["events"], b["events"])
    line = (f"{tag}: ATE {a['ate']:.4f} / {b['ate']:.4f} m, keyframes {a['n_kf']} / {b['n_kf']}, IMU at "
            f"{a['imu_at']} / {b['imu_at']}, keyframes at most {v['kf_max'] * 1e3:.4f} mm apart (first over "
            f"{KF_ROBUST_M * 1e3:g} mm at frame {v['kf_far_at']}), cameras at most {v['cam_max'] * 1e3:.4f} mm, "
            f"first record parting by frame {cmp['first_by']}: {v['verdict']}")
    print(f"rounding {line} [{smi}]", flush=True)
    return a, b, cmp, dict(v, line=line)


def main_ulp(dev, smi: str) -> int:
    """`--rounding one-ulp`: chip_smoke.py's phases 5, 7, 12 and 14b each run
    twice under graphs in this process, as the phase runs it and with the
    pose one ulp toward zero after frame 1 (6a's one-ulp run): both ATEs,
    where the runs part (`compare`) and the verdict (`ulp_verdict`); the
    phases past an IMU initialization once with the visual-inertial BA's
    reduced system in float32 (the reference's) and once as shipped."""
    summary = []
    for phase in ULP_PHASES:
        data = ulp_data(dev, phase)
        for prec, dtype in PRECISIONS if phase in VI_PHASES else PRECISIONS[1:]:
            summary.append(run_pair(dev, phase, data, f"ulp_{phase}_{prec}", smi, vi_dtype=dtype)[3]["line"])
    print("rounding one-ulp summary: " + " | ".join(summary) + f" [{smi}]", flush=True)
    return 0


def main_vi(dev, smi: str) -> int:
    """`--rounding vi`: phases 5, 12 and 14b eagerly (graphs and eager are
    bit-identical, phase 15), recorded by the stage wrappers, plain and one
    ulp off after frame 1, with the visual-inertial BA's reduced system in
    float32 and as shipped: the verdicts, the first position record that
    parts by more than PART_M and how far apart it went in and came out
    (`vi_parting`), the IMU initializations' MAP problems side by side and
    the first visual-inertial BAs iteration by iteration."""
    summary = []
    for phase in VI_PHASES:
        data = ulp_data(dev, phase)
        for prec, dtype in PRECISIONS:
            tag = f"vi_{phase}_{prec}"
            a, b, _, v = run_pair(dev, phase, data, tag, smi, cuda_graphs=False, vi_dtype=dtype)
            part = vi_parting(a["events"], b["events"])
            where = "never" if part is None else (f"frame {part['frame']}, {part['label']}: in "
                                                  f"{part['d_in'] * 1e3:.4f} mm, out {part['d_out'] * 1e3:.4f} mm")
            print(f"rounding {tag}: first parting over {PART_M * 1e3:g} mm: {where}", flush=True)
            for r in imu_init_apart(a["events"], b["events"]):
                print(f"  {tag} MAP problem at frames {r['frame']} (fix_bias {r['fix_bias']}): gravity "
                      f"{r['g_deg']:.3e} deg apart, velocities {r['v']:.3e} m/s, bg {r['bg']:.3e}, ba {r['ba']:.3e}; "
                      f"costs {r['costs'][0]} / {r['costs'][1]}", flush=True)
            print_vi_windows(tag, a["events"], b["events"])
            summary.append(f"{v['line']}; first over {PART_M * 1e3:g} mm: {where}")
    print("rounding vi summary: " + " | ".join(summary) + f" [{smi}]", flush=True)
    return 0


def main(dev, mode: str, variants: str | None) -> int:
    from pli_slam_tpu_torch.utils import profile

    smi = nvidia_smi()
    if mode == "one-ulp":
        return main_ulp(dev, smi)
    if mode == "vi":
        return main_vi(dev, smi)
    if mode == "loop":
        data = profile.loop_frames(dev)
        srcs = [("shipped", None)] + [(p.stem, p) for p in sorted(Path(variants).glob("*.cu"))] if variants else \
            [("shipped", None)]
        runs = {}
        for name, src, nudge in [(name, src, None) for name, src in srcs] + [("nudged_pose", None, 1)]:
            with rot3_source(src):
                runs[name] = trace_loop(dev, data, nudge_after=nudge)
            gc.collect()  # the run's tracker, before the next run
            torch.cuda.synchronize(dev)
            r = runs[name]
            save(f"loop_{name}", r)
            print(f"rounding loop {name}: {profile.N_FRAMES_LOOP} frames in {r['s']:.1f} s, ATE before the closure {r['ate']:.4f} m, "
                  f"{r['n_kf']} keyframes, largest keyframe error {r['kf_err']:.4f} m, {r['n_loops']} loop "
                  f"verifications [{smi}]", flush=True)
        base = runs["shipped"]["events"]
        for name in runs:
            if name != "shipped":
                print_comparison(f"shipped vs {name}", compare(base, runs[name]["events"]), base,
                                 runs[name]["events"])
        print("rounding loop ATE before the closure, m: " + ", ".join(f"{k} {v['ate']:.4f}" for k, v in runs.items())
              + f" [{smi}]", flush=True)
        return 0
    data = profile.slice6_frames("mono_vi", dev)
    runs = {}
    for route in ("svd_small", "eigh"):
        runs[route] = r = trace_mono_vi(dev, route, data)
        gc.collect()
        torch.cuda.synchronize(dev)
        save(f"mono_vi_{route}", r)
        print(f"rounding mono-vi {route}: map at frame {r['mono_init']}, IMU at frame {r['imu_init']}, scale "
              f"{r['scale']}, {r['n_kf']} keyframes, Sim(3) ATE before the IMU init {r['ate_pre']}, over the run "
              f"{r['ate_sim3']:.4f} m, {r['s']:.1f} s [{smi}]", flush=True)
    a, b = runs["svd_small"]["events"], runs["eigh"]["events"]
    print_comparison("mono-vi svd_small vs eigh", compare(a, b), a, b)
    for route, r in runs.items():
        for x in r["imu_log"]:
            print(f"  {route} IMU init record: {x}", flush=True)
    return 0
