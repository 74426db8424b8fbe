"""`build_frame` of the port against the reference's jitted build_frame,
compared whole at tiny_test size (128x96, 256 ORB features, 32 lines).

Points: keypoints, octaves, scales, descriptors, validity and stereo
verdicts exactly equal; FAST responses and angles within float rounding
of XLA's fused pyramid arithmetic; u_right / depth within 1e-4 px / m
(SAD patch means are summed in another order). Lines: compared as a set,
because the reference's own eager and jitted runs order near-equal
segment scores differently (see test_torch_ops); at least 90% of its
segments must appear in the port's output with equal descriptors, and
stereo line verdicts must agree on those.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from pli_slam_tpu.frontend import frame as jframe
from pli_slam_tpu.ops.camera import Camera as JCamera
from pli_slam_tpu.utils import synthetic as jsyn
from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.frontend import frame as tframe
from pli_slam_tpu_torch.utils import convert

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frames():
    cfg = SlamConfig.tiny_test()
    tcfg = convert.config_from_reference(dataclasses.asdict(cfg))
    jcam = JCamera.pinhole(fx=120.0, fy=120.0, cx=64.0, cy=48.0, bf=0.11 * 120.0, width=128, height=96)
    tcam = convert.camera(jax.tree_util.tree_map(np.asarray, jcam))
    traj = jsyn.Trajectory(amp=(0.5, 0.35, 0.2), freq=(0.15, 0.19, 0.11), yaw_amp=0.25)
    build_j = jax.jit(partial(jframe.build_frame, jcam, cfg))
    out = []
    for fr in jsyn.make_sequence(jcam, 2, fps=cfg.fps, traj=traj, room_half=2.55):
        il, ir = np.array(fr["img_l"]), np.array(fr["img_r"])
        jf = convert.to_numpy(jax.tree_util.tree_map(np.asarray, build_j(il, ir)))
        tf = convert.to_numpy(tframe.build_frame(tcam, tcfg, torch.as_tensor(il), torch.as_tensor(ir)))
        out.append((jf, tf))
    return out


@pytest.mark.parametrize("k", [0, 1])
def test_build_frame_points(frames, k):
    jf, tf = frames[k]
    assert jf.keys() == tf.keys()
    for key in jf:
        assert jf[key].dtype == tf[key].dtype and jf[key].shape == tf[key].shape, key
    for key in ("feats.uv", "feats.octave", "feats.scale", "feats.desc", "feats.valid", "stereo_ok", "sigma2"):
        np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
    np.testing.assert_allclose(tf["feats.response"], jf["feats.response"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tf["feats.angle"], jf["feats.angle"], rtol=1e-4, atol=1e-4)
    m = jf["stereo_ok"]
    assert m.sum() > 50
    np.testing.assert_allclose(tf["u_right"][m], jf["u_right"][m], atol=1e-4)
    np.testing.assert_allclose(tf["depth"][m], jf["depth"][m], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tf["depth"][~m], jf["depth"][~m])


@pytest.mark.parametrize("k", [0, 1])
def test_build_frame_lines(frames, k):
    jf, tf = frames[k]
    assert tf["lines.valid"].sum() == jf["lines.valid"].sum()
    a = np.concatenate([jf["lines.p0"], jf["lines.p1"]], 1)
    b = np.concatenate([tf["lines.p0"], tf["lines.p1"]], 1)
    d = np.abs(a[:, None, :] - b[None, :, :]).max(-1)
    near = d.argmin(1)
    hit = (d.min(1) < 1e-3) & jf["lines.valid"]
    assert hit.sum() >= 0.9 * jf["lines.valid"].sum(), (hit.sum(), jf["lines.valid"].sum())
    np.testing.assert_array_equal(tf["lines.desc"][near[hit]], jf["lines.desc"][hit])
    np.testing.assert_allclose(tf["lines.angle"][near[hit]], jf["lines.angle"][hit], atol=1e-5)
    # stereo association of those segments: the right image's segments may
    # differ in the same way, so verdicts are compared where both agree
    both = hit & jf["line_ok"] & tf["line_ok"][near]
    assert both.sum() >= 0.8 * (hit & jf["line_ok"]).sum()
    np.testing.assert_allclose(tf["line_disp"][near[both]], jf["line_disp"][both], atol=1e-3)
