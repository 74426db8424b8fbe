"""The stereo-inertial fused step cut for CUDA graphs, on the CPU: as
test_torch_graph_step.py holds the visual step, (a) T, the device
decision and K (the counters chained on the device) against the
reference's jitted `make_step_vi` on every fused frame of
test_torch_tracker_vi's reference run (IMU initialization at frame 20,
keyframes with visual-inertial BA, the widened window), (b) T and K traced
with make_fx in fake mode, (c) a real-mode trace taken at a keyframe with
windowed BA replayed on the run's last fused frame, equal to eager bit for
bit. The run's reference tracker is re-run here (module fixtures are per
file)."""

import pytest
import torch
import test_torch_tracker_vi as tvi
from test_torch_graph_step import _segments_step, check_replay_on_later_frame, check_segments_trace

from pli_slam_tpu.frontend import tracker as jtr
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vi_run():
    """test_torch_tracker_vi's reference run (stereo-inertial, IMU
    initialization at frame 20, then fused frames), recorded with the state
    each fused frame started from; the port's own free run is left out."""
    mp = tvi._accelerator_branch()
    try:
        cfg = tvi._cfg(init_min_kfs=5)
        jt, _, rec = tvi._run_both(cfg, tvi.N_FRAMES, record=True, free_run=False)
        yield cfg, jt, rec
    finally:
        mp.undo()


def _vi_io(fz):
    """The port's (inputs, state, n_kf, fs) of a recorded fused frame of the reference run."""
    st = fz["state"]
    state = {k: st[k] for k in ("R", "t", "v_w", "bg", "ba", "gravity_w", "preint_acc", "ext", "pstore", "lstore",
                                "kstore", "bow_db", "kf_view", "local_pt", "pints")}
    state.update(R_prev=st["R"], t_prev=st["t"], n_kf=tstep._dev_int(st["n_kf"], "cpu"),
                 fs=tstep._dev_int(st["frames_since_kf"], "cpu"), last=tstep._dev_int(st["last_kf_inliers"], "cpu"))
    inputs = tstep.scalar_inputs(dict(img=(convert.frame_data(fz["frame"]),), imu=fz["imu"], stamp=fz["stamp"],
                                       allow=True, wide=fz["wide"]), "cpu")
    return inputs, state, st["n_kf"], st["frames_since_kf"]


def _vi_segments(vi_run):
    cfg, jt, _ = vi_run
    return tstep.vi_segments(tvi._cams()[1], tvi.port_cfg(cfg), convert.vocabulary(jt.voc_pt),
                             convert.vocabulary(jt.voc_ln), lambda fd: fd)


def _ba_keyframe_frames(vi_run):
    """(segments, [(inputs, state)] of the fused frames that made a keyframe
    with windowed BA, (inputs, state) of the last fused frame)."""
    fused = vi_run[2]["fused"]
    frames = [_vi_io(fz)[:2] for fz in fused
              if fz["out"][20][jtr.ST_KF_CREATED] > 0 and fz["out"][20][jtr.ST_NKF] >= 3]
    return _vi_segments(vi_run), frames, _vi_io(fused[-1])[:2]


def test_vi_segments_parity(vi_run, monkeypatch):
    """Every fused stereo-inertial frame of the reference run (keyframes with
    visual-inertial BA among them, and the widened window after the IMU
    initialization), replayed by the program (T, the decision on the device,
    K) from the reference's state, the keyframe counters chained as device
    tensors from the port's previous fused frame, and held as
    test_torch_tracker_vi holds make_step_vi."""
    cfg, jt, rec = vi_run
    segs = _vi_segments(vi_run)
    chained = {}  # the keyframe counters the port's previous fused frame left, as device tensors

    def step(img_args, imu_args, stamp, R, t, v_w, bg, ba, gravity_w, preint_acc, ext, n_kf, fs, last, allow_mapping,
             wide, pstore, lstore, kstore, bow_db, kf_view, local_pt, pints):
        assert allow_mapping
        counters = dict(chained) or {k: tstep._dev_int(v, "cpu") for k, v in (("n_kf", n_kf), ("fs", fs),
                                                                            ("last", last))}
        # the program reads none of them on the host; the test holds the chain to the reference's counters
        assert [int(v) for v in counters.values()] == [int(n_kf), int(fs), int(last)], stamp
        state = dict(R=R, t=t, R_prev=R, t_prev=t, v_w=v_w, bg=bg, ba=ba, gravity_w=gravity_w, preint_acc=preint_acc,
                     ext=ext, **counters, pstore=pstore, lstore=lstore, kstore=kstore, bow_db=bow_db,
                     kf_view=kf_view, local_pt=local_pt, pints=pints)
        inputs = tstep.scalar_inputs(dict(img=tuple(img_args), imu=imu_args, stamp=stamp, allow=allow_mapping,
                                          wide=wide), "cpu")
        s, out, c, _ = _segments_step(segs, inputs, state)
        chained.update(n_kf=s["n_kf"], fs=s["fs"], last=s["last"])
        return (s["R"], s["t"], s["R_prev"], s["t_prev"], s["v_w"], s["bg"], s["ba"], s["preint_acc"], s["pstore"],
                s["lstore"], s["kstore"], s["bow_db"], s["kf_view"], s["local_pt"], s["pints"], c["pt_idx"],
                c["pt_in"], c["ln_idx"], c["ln_in"], (s["n_kf"], s["fs"], s["last"]), out["stats"],
                (out["ref"], out["rel_R"], out["rel_t"]))

    monkeypatch.setattr(tstep, "make_step_vi", lambda *a: step)
    assert len(tvi._check_fused_replay(cfg, jt, rec)) >= 1  # the keyframe branch with VI-BA was compared
    assert any(fz["wide"] for fz in rec["fused"]) and not all(fz["wide"] for fz in rec["fused"])


@pytest.mark.parametrize("step", ["vi"])
def test_segments_trace_in_fake_mode(vi_run, step):
    """(b) for the stereo-inertial step."""
    segs, frames, _ = _ba_keyframe_frames(vi_run)
    check_segments_trace(segs, frames)


@pytest.mark.parametrize("step", ["vi"])
def test_replay_on_next_frame_equals_eager(vi_run, step):
    """(c) for the stereo-inertial step."""
    segs, frames, last = _ba_keyframe_frames(vi_run)
    check_replay_on_later_frame(segs, frames[0], last, step)
