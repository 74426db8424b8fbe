"""Rectified stereo point matching with sub-pixel SAD refinement
(port of pli_slam_tpu.ops.stereo).

The reference gathers patches with a vmapped `dynamic_slice`; here the
patch is one index gather with per-patch row/column offsets (the same
clamped window origins).
"""

from __future__ import annotations

import torch

from pli_slam_tpu_torch.ops import matching
from pli_slam_tpu_torch.ops.orb import Features
from pli_slam_tpu_torch.ops.robust import masked_median

SAD_HALF = 5
SAD_SHIFT = 5


def _gather_patch_rows(img, cx, cy, half_h: int, half_w: int) -> torch.Tensor:
    """[N, 2*half_h+1, 2*half_w+1] patches centred at int (cx, cy), window
    origin clamped inside the image (dynamic_slice semantics)."""
    h, w = img.shape
    ph, pw = 2 * half_h + 1, 2 * half_w + 1
    y0 = torch.clamp(cy - half_h, 0, h - ph)
    x0 = torch.clamp(cx - half_w, 0, w - pw)
    ry = torch.arange(ph, device=img.device)
    rx = torch.arange(pw, device=img.device)
    return img[(y0[:, None] + ry[None, :])[:, :, None], (x0[:, None] + rx[None, :])[:, None, :]]


def match_stereo(left: Features, right: Features, img_left, img_right, max_disparity: float,
                 min_disparity: float = 0.1, row_band: float = 2.0, max_dist: float = 60.0):
    """Returns (u_right [N] float32, ok [N] bool) aligned with `left` slots."""
    dist = matching.hamming_matrix(left.desc, right.desc)
    band = row_band * torch.maximum(left.scale[:, None], right.scale[None, :])
    g_row = torch.abs(left.uv[:, 1][:, None] - right.uv[:, 1][None, :]) <= band
    disp = left.uv[:, 0][:, None] - right.uv[:, 0][None, :]
    g_disp = (disp >= min_disparity) & (disp <= max_disparity)
    g_scale = matching.scale_gate(left.octave, right.octave, 1)
    gate = g_row & g_disp & g_scale

    idx_r, best, ok = matching.match_nn(dist, left.valid, right.valid, gate, max_dist=max_dist, ratio=0.85)
    ok = matching.mutual_consistency(idx_r, ok, dist, left.valid, right.valid, gate)

    xl = torch.round(left.uv[:, 0]).long()
    yl = torch.round(left.uv[:, 1]).long()
    xr0 = torch.round(right.uv[idx_r.long(), 0]).long()

    patch_l = _gather_patch_rows(img_left, xl, yl, SAD_HALF, SAD_HALF)
    strip_r = _gather_patch_rows(img_right, xr0, yl, SAD_HALF, SAD_HALF + SAD_SHIFT)
    patch_l = patch_l - patch_l.mean(dim=(1, 2), keepdim=True)

    def sad_at(offset):
        win = strip_r[:, :, offset:offset + 2 * SAD_HALF + 1]
        win = win - win.mean(dim=(1, 2), keepdim=True)
        return torch.sum(torch.abs(patch_l - win), dim=(1, 2))

    sads = torch.stack([sad_at(o) for o in range(2 * SAD_SHIFT + 1)], dim=1)
    best_o = torch.argmin(sads, dim=1)
    center = torch.clamp(best_o, 1, 2 * SAD_SHIFT - 1)
    s_m = torch.gather(sads, 1, (center - 1)[:, None])[:, 0]
    s_0 = torch.gather(sads, 1, center[:, None])[:, 0]
    s_p = torch.gather(sads, 1, (center + 1)[:, None])[:, 0]
    denom = s_m + s_p - 2.0 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m - s_p) / torch.clamp(denom, min=1e-6),
                        torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    u_r = xr0.float() + (center - SAD_SHIFT).float() + delta

    disparity = left.uv[:, 0] - u_r
    ok = ok & (disparity >= min_disparity) & (disparity <= max_disparity)

    best_sad = torch.gather(sads, 1, best_o[:, None])[:, 0]
    med = masked_median(best_sad, ok)
    ok = ok & (best_sad <= 2.1 * med + 1e-6)
    return u_r, ok


def depths_from_stereo(left: Features, u_right, ok, bf: float):
    disparity = left.uv[:, 0] - u_right
    depth = bf / torch.clamp(disparity, min=1e-6)
    return torch.where(ok, depth, torch.full_like(depth, -1.0))
