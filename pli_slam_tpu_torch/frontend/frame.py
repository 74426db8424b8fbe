"""Per-frame front end for rectified stereo (port of pli_slam_tpu.frontend.frame).

`build_frame` runs both ORB pyramids, stereo point association, left
line detection with LBD and descriptor-free stereo line association, on
the device the images live on.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu.utils.config import SlamConfig
from pli_slam_tpu_torch.ops import lines as line_ops
from pli_slam_tpu_torch.ops import orb, stereo
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.ops.lines import LineFeatures
from pli_slam_tpu_torch.ops.orb import Features


@dataclasses.dataclass(frozen=True)
class FrameData:
    """Everything tracking needs about one stereo frame."""

    feats: Features
    u_right: torch.Tensor  # [N] refined right-image u
    stereo_ok: torch.Tensor  # [N] bool
    depth: torch.Tensor  # [N] depth, -1 where invalid
    lines: LineFeatures
    line_disp: torch.Tensor  # [Nl, 2] endpoint disparities
    line_ok: torch.Tensor  # [Nl] bool
    sigma2: torch.Tensor  # [N] scale^2


def build_frame(cam: Camera, cfg: SlamConfig, img_l: torch.Tensor, img_r: torch.Tensor) -> FrameData:
    fl = orb.extract(img_l, cfg.orb)
    fr = orb.extract(img_r, cfg.orb)
    u_r, sok = stereo.match_stereo(fl, fr, img_l, img_r, max_disparity=cfg.match.stereo_max_disparity)
    depth = stereo.depths_from_stereo(fl, u_r, sok, cam.bf)

    if cfg.use_lines:
        ll = line_ops.detect(img_l, cfg.lines)
        lr = line_ops.detect(img_r, cfg.lines, with_desc=False)
        d0, d1, _, lok = line_ops.match_stereo_lines_geom(
            ll, lr, img_l, img_r, max_disparity=cfg.match.stereo_max_disparity)
        line_disp = torch.stack([d0, d1], dim=-1)
    else:
        nl = cfg.lines.n_lines
        ll = LineFeatures.empty(nl, img_l.device)
        line_disp = torch.zeros((nl, 2), device=img_l.device)
        lok = torch.zeros(nl, dtype=torch.bool, device=img_l.device)

    return FrameData(feats=fl, u_right=u_r, stereo_ok=sok, depth=depth,
                     lines=ll, line_disp=line_disp, line_ok=lok, sigma2=fl.scale ** 2)
