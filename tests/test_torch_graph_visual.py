"""The visual fused step cut for CUDA graphs, checks of the port alone
(test_torch_graph_step.py says what the CPU can show of the cut, and
where each step's tests are): each frame builder a fused step runs traced
as part of T, in fake and in real mode; (c) a real-mode trace of T and K
taken at a keyframe with windowed BA and replayed on the next fused frame,
equal to eager bit for bit. Its (b), T and K in fake mode, is the program
trace of test_torch_one_program.py. The (inputs, state) of (c) are
snapshots of the port's own CPU stereo tracker (`own_fused_frames`) over
test_torch_graph_step's scene and settings (the 128x96 camera, its
trajectory, test_torch_step's configuration with a keyframe every second
frame), the images the port's synthetic frames of that scene; no
reference runs here. The step's (a), against the reference's jitted
`make_step_visual`, is in test_torch_step.py."""

from functools import partial

import numpy as np
import pytest
import torch
from test_torch_graph_step import (N_VIS, TRAJ, _fake_trace, _flat, _one_fake_mode, check_replay_on_later_frame,
                                   own_fused_frames)
from test_torch_stages import CAM
from test_torch_step import _cfg, port_cfg
from torch.fx.experimental.proxy_tensor import make_fx

from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.frontend import graphs
from pli_slam_tpu_torch.frontend import step as tstep
from pli_slam_tpu_torch.frontend.tracker import Tracker
from pli_slam_tpu_torch.ops import rectify
from pli_slam_tpu_torch.ops.camera import Camera as TCamera
from pli_slam_tpu_torch.utils import synthetic

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# (b) the frame builders, (c) no frozen values
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def own():
    """The scene's frames, the segments without the frame build, and the
    (inputs, state) of the port's first fused keyframe with windowed BA and
    of the fused frame after it."""
    cfg = port_cfg(_cfg())
    frames = list(synthetic.make_sequence(CAM, N_VIS, "cpu", fps=cfg.fps, traj=synthetic.Trajectory(**TRAJ),
                                          room_half=2.55))
    tracker = Tracker(CAM, cfg, "cpu")
    first, later = own_fused_frames(tracker, frames)
    segs = tstep.visual_segments(CAM, cfg, tracker.voc_pt, tracker.voc_ln, lambda fd: fd)
    return dict(cfg=cfg, frames=frames, segs=segs, first=first, later=later)


@pytest.mark.parametrize("builder", ["stereo", "rectified", "rgbd", "fisheye"])
def test_frame_builders_trace_in_fake_mode(own, builder):
    """Each frame builder a fused step runs (phases 4-6, 14 stereo; rectified
    EuRoC pairs; 7 RGB-D; 10 KB8 fisheye) traces as part of T."""
    pcfg = own["cfg"]
    tcam = CAM
    fr = own["frames"][1]
    img_l, img_r = torch.as_tensor(np.asarray(fr["img_l"])), torch.as_tensor(np.asarray(fr["img_r"]))
    outside = ()
    if builder == "stereo":
        build, args = partial(tframe.build_frame, tcam, pcfg), (img_l, img_r)
    elif builder == "rectified":
        K = np.array([[tcam.fx, 0, tcam.cx], [0, tcam.fy, tcam.cy], [0, 0, 1]], np.float64)
        D = np.array([-0.28, 0.074, 2e-4, 2e-5, 0.0])
        P = np.concatenate([K, np.zeros((3, 1))], axis=1)
        rect = rectify.StereoRectifier.from_kdrp(K, D, np.eye(3), P, K, D, np.eye(3), P, tcam.width, tcam.height,
                                                 "cpu")
        build, args, outside = lambda a, b: tframe.build_frame(tcam, pcfg, *rect(a, b)), (img_l, img_r), \
            graphs.tree_leaves(rect)
    elif builder == "rgbd":
        build, args = partial(tframe.build_frame_rgbd, tcam, pcfg), (img_l, torch.full_like(img_l, 2.0))
    else:
        kb = TCamera.kannala_brandt8(fx=tcam.fx, fy=tcam.fy, cx=tcam.cx, cy=tcam.cy, k=(0.01, -0.005, 0.001, 0.0),
                                     bf=tcam.bf, width=tcam.width, height=tcam.height)
        T_rl = torch.eye(4)
        T_rl[0, 3] = -0.11
        R_rl, t_rl = T_rl[:3, :3], T_rl[:3, 3]
        build, args, outside = partial(tframe.build_frame_fisheye_stereo, kb, kb, pcfg, R_rl, t_rl), (img_l, img_r), \
            (R_rl, t_rl)
    build(*args)  # the eager run fills the constant cache, as the warm-up before a capture does
    _fake_trace(build, args, outside)
    flat, leaves = _flat(build, args)
    with _one_fake_mode():
        make_fx(flat, tracing_mode="real")(*leaves)  # fails on a host read that the fake trace skips


@pytest.mark.parametrize("step", ["visual"])
def test_replay_on_next_frame_equals_eager(own, step):
    """(c) for the visual step (the stereo-inertial one: test_torch_graph_step_vi.py)."""
    check_replay_on_later_frame(own["segs"], own["first"], own["later"], step)
