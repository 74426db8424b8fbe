"""Per-frame front ends (port of pli_slam_tpu.frontend.frame), on the
device the images live on.

`build_frame` (rectified stereo) runs both ORB pyramids, stereo point
association, left line detection with LBD and descriptor-free stereo line
association. `build_frame_rgbd` samples the depth image at the features
and turns it into a virtual right coordinate u - bf/d, so the stereo
machinery downstream applies unchanged. `build_frame_mono` has no depth
channel; with a Kannala-Brandt8 camera its keypoints and line endpoints
are undistorted to the ideal pinhole frame (`undistort_uv`).
`build_frame_fisheye_stereo` serves an unrectified KB8 rig: the left and
right features are associated by epipolar-gated descriptor matching and
DLT triangulation, and the depth becomes a virtual right coordinate.
"""

from __future__ import annotations

import dataclasses

import torch

from pli_slam_tpu_torch.utils.config import SlamConfig
from pli_slam_tpu_torch.ops import lines as line_ops
from pli_slam_tpu_torch.ops import camera as cam_ops
from pli_slam_tpu_torch.ops import matching, orb, stereo
from pli_slam_tpu_torch.ops.camera import Camera
from pli_slam_tpu_torch.ops.lines import LineFeatures
from pli_slam_tpu_torch.ops.orb import Features
from pli_slam_tpu_torch.solve import triangulate as tri


@dataclasses.dataclass(frozen=True)
class FrameData:
    """Everything tracking needs about one frame."""

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


def _sample_depth(depth_img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Depth at the nearest pixel of (sub-pixel) points; `torch.round`
    rounds half to even, as `jnp.round` does."""
    h, w = depth_img.shape
    ui = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    vi = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return depth_img[vi, ui]


def build_frame_rgbd(cam: Camera, cfg: SlamConfig, img: torch.Tensor, depth_img: torch.Tensor) -> FrameData:
    """RGB-D frame: the depth at each feature becomes a virtual right
    coordinate u_r = u - bf/d, and line endpoints get disparities bf/d."""
    fl = orb.extract(img, cfg.orb)
    d = _sample_depth(depth_img, fl.uv)
    ok = fl.valid & (d > 0.0)
    u_r = torch.where(ok, fl.uv[:, 0] - cam.bf / torch.clamp(d, min=1e-6), torch.full_like(d, -1.0))
    depth = torch.where(ok, d, torch.full_like(d, -1.0))

    nl = cfg.lines.n_lines
    if cfg.use_lines:
        ll = line_ops.detect(img, cfg.lines)
        d0 = _sample_depth(depth_img, ll.p0)
        d1 = _sample_depth(depth_img, ll.p1)
        lok = ll.valid & (d0 > 0.0) & (d1 > 0.0)
        line_disp = torch.stack([cam.bf / torch.clamp(d0, min=1e-6), cam.bf / torch.clamp(d1, min=1e-6)], dim=-1)
        line_disp = torch.where(lok[:, None], line_disp, torch.zeros_like(line_disp))
    else:
        ll = LineFeatures.empty(nl, img.device)
        line_disp = torch.zeros((nl, 2), device=img.device)
        lok = torch.zeros(nl, dtype=torch.bool, device=img.device)

    return FrameData(feats=fl, u_right=u_r, stereo_ok=ok, depth=depth,
                     lines=ll, line_disp=line_disp, line_ok=lok, sigma2=fl.scale ** 2)


def undistort_uv(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Observed (fisheye) pixels -> ideal-pinhole pixels with the same
    fx/fy/cx/cy (the reference's keypoint undistortion)."""
    ray = cam_ops.unproject(cam, uv)  # KB8 Newton inversion, z = 1
    return torch.stack([cam.fx * ray[..., 0] + cam.cx, cam.fy * ray[..., 1] + cam.cy], dim=-1)


def build_frame_mono(cam: Camera, cfg: SlamConfig, img: torch.Tensor) -> FrameData:
    """Monocular frame: no stereo or depth channel (landmark depth comes
    from two-view initialization and triangulation later). With a KB8
    `cam` the features and line endpoints are extracted on the raw image
    and their coordinates undistorted to the ideal pinhole frame."""
    dev = img.device
    fl = orb.extract(img, cfg.orb)
    n, nl = fl.uv.shape[0], cfg.lines.n_lines
    ll = line_ops.detect(img, cfg.lines) if cfg.use_lines else LineFeatures.empty(nl, dev)
    if cam.model == cam_ops.KANNALA_BRANDT8:
        fl = dataclasses.replace(fl, uv=undistort_uv(cam, fl.uv))
        if cfg.use_lines:
            ll = dataclasses.replace(ll, p0=undistort_uv(cam, ll.p0), p1=undistort_uv(cam, ll.p1))
    return FrameData(feats=fl, u_right=torch.full((n,), -1.0, device=dev),
                     stereo_ok=torch.zeros(n, dtype=torch.bool, device=dev), depth=torch.full((n,), -1.0, device=dev),
                     lines=ll, line_disp=torch.zeros((nl, 2), device=dev),
                     line_ok=torch.zeros(nl, dtype=torch.bool, device=dev), sigma2=fl.scale ** 2)


def build_frame_fisheye_stereo(cam_l: Camera, cam_r: Camera, cfg: SlamConfig, R_rl: torch.Tensor,
                               t_rl: torch.Tensor, img_l: torch.Tensor, img_r: torch.Tensor) -> FrameData:
    """Fisheye (KB8) stereo frame: a fisheye rig cannot be rectified to
    scanlines. ORB runs on both raw images and each camera's keypoints are
    undistorted to its ideal pinhole frame; left and right are matched
    densely under the epipolar gate of the rig (`T_rl` = (R_rl, t_rl) maps
    left-camera coordinates to right-camera ones), mutual nearest
    neighbours with the ratio test, and each match is DLT-triangulated.
    The depth z becomes a virtual right coordinate u - bf / z. Lines come
    from the left image only and carry no stereo association."""
    dev = img_l.device
    fl = orb.extract(img_l, cfg.orb)
    fr = orb.extract(img_r, cfg.orb)
    uv_l = undistort_uv(cam_l, fl.uv)
    uv_r = undistort_uv(cam_r, fr.uv)
    fl = dataclasses.replace(fl, uv=uv_l)
    pin_l = dataclasses.replace(cam_l, model=cam_ops.PINHOLE)
    pin_r = dataclasses.replace(cam_r, model=cam_ops.PINHOLE)

    # the left view is T_cw = (I, 0), the right one (R_rl, t_rl), in the left camera's frame
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    gate = tri.epipolar_gate(pin_l, eye, zero, R_rl, t_rl, uv_l, uv_r)
    dist = matching.hamming_matrix(fl.desc, fr.desc)
    idx, _, ok = matching.match_nn(dist, fl.valid, fr.valid, gate, max_dist=cfg.match.orb_th_high,
                                   ratio=cfg.match.nn_ratio)
    ok = matching.mutual_consistency(idx, ok, dist, fl.valid, fr.valid, gate)

    j = torch.clamp(idx, min=0).long()
    ray_l = cam_ops.unproject(pin_l, uv_l)
    ray_r = cam_ops.unproject(pin_r, uv_r[j])
    X = tri.triangulate_dlt(eye, zero, R_rl, t_rl, ray_l, ray_r)
    good = tri.triangulation_checks(pin_l, eye, zero, R_rl, t_rl, X, uv_l, uv_r[j], fl.scale ** 2,
                                    fr.scale[j] ** 2, min_parallax_cos=1.0)  # the rig's baseline is the parallax
    z = X[:, 2]
    minus = torch.full_like(z, -1.0)
    depth = torch.where(ok & good & (z > 0.05), z, minus)
    sok = depth > 0
    u_r = torch.where(sok, uv_l[:, 0] - cam_l.bf / torch.clamp(depth, min=1e-6), minus)

    nl = cfg.lines.n_lines
    if cfg.use_lines:
        ll = line_ops.detect(img_l, cfg.lines)
        ll = dataclasses.replace(ll, p0=undistort_uv(cam_l, ll.p0), p1=undistort_uv(cam_l, ll.p1))
    else:
        ll = LineFeatures.empty(nl, dev)
    return FrameData(feats=fl, u_right=u_r, stereo_ok=sok, depth=depth, lines=ll,
                     line_disp=torch.zeros((nl, 2), device=dev), line_ok=torch.zeros(nl, dtype=torch.bool, device=dev),
                     sigma2=fl.scale ** 2)
