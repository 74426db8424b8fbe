"""Line-segment detection, LBD-style description and geometric stereo
association (port of the parts of pli_slam_tpu.ops.lines that
`build_frame` uses).

Pipeline as in the reference: Sobel -> directional-NMS edge map ->
gradient-guided Hough voting over the strongest voters -> 3x3 peak NMS
+ top-k -> per-candidate support runs -> matrix NMS -> top-N -> LBD
band statistics binarized by a seeded random projection.

Parity notes:
- top-k selections (voters, peaks, final lines) break ties by the lower
  index, as `jax.lax.top_k` does;
- the reference's `associative_scan` run-length recurrence becomes a
  cummax formulation with identical integer outputs;
- `reduce_window(..., "SAME")` pads floor/ceil for even windows; the
  explicit padding in `_max_window_same` does the same;
- the Hough votes are summed by `indexing.deterministic_index_add`: on the
  CPU in update order, like XLA's CPU scatter; on CUDA in 64-bit fixed
  point, so that two runs on the card give the same lines (float atomics
  add in arrival order). The card's cells are the correctly rounded sums
  and may differ from the CPU's in the last bits, so equal-score peaks may
  swap between the devices. No test compares lines across devices.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import LineConfig
from pli_slam_tpu_torch.ops import image as image_ops
from pli_slam_tpu_torch.ops.fast import max_pool_same
from pli_slam_tpu_torch.ops.indexing import deterministic_index_add, top_k


def _deg2rad_f32(deg: float) -> float:
    return float(np.float32(deg) * np.float32(math.pi / 180.0))


@dataclasses.dataclass(frozen=True)
class LineFeatures:
    """Padded line-segment set in pixel coordinates."""

    p0: torch.Tensor  # [N, 2] float32
    p1: torch.Tensor  # [N, 2] float32
    angle: torch.Tensor  # [N] float32
    length: torch.Tensor  # [N] float32
    response: torch.Tensor  # [N] float32
    desc: torch.Tensor  # [N, 256] int8 ±1
    valid: torch.Tensor  # [N] bool

    def midpoint(self) -> torch.Tensor:
        return 0.5 * (self.p0 + self.p1)

    def line_coeffs(self) -> torch.Tensor:
        """Normalized homogeneous line l = p0 x p1, [N, 3]."""
        h0 = torch.cat([self.p0, torch.ones_like(self.p0[:, :1])], dim=1)
        h1 = torch.cat([self.p1, torch.ones_like(self.p1[:, :1])], dim=1)
        l = torch.linalg.cross(h0, h1, dim=1)
        n = torch.linalg.norm(l[:, :2], dim=1, keepdim=True)
        return l / torch.clamp(n, min=1e-9)

    @staticmethod
    def empty(n: int, device=None) -> "LineFeatures":
        z2 = torch.zeros((n, 2), device=device)
        z = torch.zeros(n, device=device)
        return LineFeatures(p0=z2, p1=z2.clone(), angle=z, length=z.clone(), response=z.clone(),
                            desc=torch.zeros((n, 256), dtype=torch.int8, device=device),
                            valid=torch.zeros(n, dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------


def _edge_map(img: torch.Tensor, grad_threshold: float):
    blurred = image_ops.gaussian_blur(img, sigma=1.0, radius=2)
    gx, gy = image_ops.sobel_gradients(blurred)
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.atan2(gy, gx)
    sector = torch.round(ang / (math.pi / 4.0)).to(torch.int32) % 4
    offs = [(0, 1), (1, 1), (1, 0), (1, -1)]
    sel_p = torch.zeros_like(mag)
    sel_m = torch.zeros_like(mag)
    for s, (dy, dx) in enumerate(offs):
        is_s = sector == s
        sel_p = torch.where(is_s, torch.roll(mag, (-dy, -dx), (0, 1)), sel_p)
        sel_m = torch.where(is_s, torch.roll(mag, (dy, dx), (0, 1)), sel_m)
    edge = (mag >= grad_threshold) & (mag >= sel_p) & (mag >= sel_m)
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    border = (ys >= 2) & (ys < h - 2) & (xs >= 2) & (xs < w - 2)
    return edge & border, gx, gy, mag


def _hough_vote(edge, gx, gy, mag, cfg: LineConfig, h: int, w: int):
    """Gradient-guided Hough accumulator [T, R] over the strongest voters."""
    T = cfg.theta_bins
    diag = math.hypot(h, w)
    R = int(2 * diag / cfg.rho_res) + 3
    by, bx = 2, 2
    hp = h // by * by
    wp = w // bx * bx
    score2 = torch.where(edge, mag, torch.zeros_like(mag))[:hp, :wp]
    blocks = score2.reshape(hp // by, by, wp // bx, bx).permute(0, 2, 1, 3).reshape(hp // by, wp // bx, by * bx)
    arg = torch.argmax(blocks, dim=-1)
    bweight = torch.amax(blocks, dim=-1).reshape(-1)
    cy = torch.arange(arg.shape[0], device=arg.device)[:, None] * by + arg // bx
    cx = torch.arange(arg.shape[1], device=arg.device)[None, :] * bx + arg % bx
    bidx = (cy * w + cx).reshape(-1)
    n_voters = min(cfg.n_voters, bweight.shape[0])
    weight, sel = top_k(bweight, n_voters)
    flat_idx = bidx[sel]
    xs = (flat_idx % w).float()
    ys = (flat_idx // w).float()
    gx_v = gx.reshape(-1)[flat_idx]
    gy_v = gy.reshape(-1)[flat_idx]
    theta = torch.atan2(gy_v, gx_v) % math.pi
    tbin0 = (theta * (T / math.pi)).to(torch.int32) % T
    diag32 = float(np.float32(diag))
    cells = []
    for dt in (-1, 0, 1):
        tb = (tbin0 + dt) % T
        th = (tb.float() + 0.5) * (math.pi / T)
        rho = xs * torch.cos(th) + ys * torch.sin(th)
        rbin = torch.clamp(((rho + diag32) / cfg.rho_res).to(torch.int32), 0, R - 1)
        cells.append(tb * R + rbin)
    acc = deterministic_index_add(torch.zeros(T * R, dtype=torch.float32, device=gx.device), torch.cat(cells),
                          weight.repeat(3))
    return acc.reshape(T, R), diag32, R


def _hough_peaks(acc: torch.Tensor, k: int):
    m = max_pool_same(acc, 3, 3)
    peaks = torch.where((acc >= m) & (acc > 0), acc, torch.zeros_like(acc)).reshape(-1)
    score, idx = top_k(peaks, k)
    R = acc.shape[1]
    return idx // R, idx % R, score


def _longest_run(support: torch.Tensor):
    """Longest True run per row of [K, S] -> (start, end) inclusive
    (start = end = 0 without support). Run length ending at i is
    i - (index of the last False at or before i)."""
    S = support.shape[1]
    pos = torch.arange(S, device=support.device)[None, :].expand(support.shape)
    last_false = torch.cummax(torch.where(support, torch.full_like(pos, -1), pos), dim=1).values
    runs = pos - last_false
    end = torch.argmax(runs, dim=1)
    length = torch.gather(runs, 1, end[:, None])[:, 0]
    start = end - torch.clamp(length - 1, min=0)
    return start, end


def _max_window_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sliding max over the last axis of [K, S], window k, stride 1, XLA
    "SAME" padding with -inf (floor(k-1)/2 before, the rest after)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    xp = torch.nn.functional.pad(x[:, None, :], (lo, hi), value=float("-inf"))
    return torch.nn.functional.max_pool1d(xp, k, stride=1)[:, 0, :]


def _close_gaps(support: torch.Tensor, gap: int) -> torch.Tensor:
    if gap <= 0:
        return support
    x = support.float()
    dil = _max_window_same(x, gap + 1)
    ero = -_max_window_same(-dil, gap + 1)
    return (ero > 0.5) & (dil > 0.5) | support


def detect(img: torch.Tensor, cfg: LineConfig, with_desc: bool = True) -> LineFeatures:
    """Detect up to cfg.n_lines segments in a [H, W] float32 image."""
    h, w = img.shape
    dev = img.device
    edge, gx, gy, mag = _edge_map(img, cfg.grad_threshold)
    acc, diag, _ = _hough_vote(edge, gx, gy, mag, cfg, h, w)
    t_idx, r_idx, peak_score = _hough_peaks(acc, cfg.n_candidates)

    T = cfg.theta_bins
    theta = (t_idx.float() + 0.5) * (math.pi / T)
    rho = (r_idx.float() + 0.5) * cfg.rho_res - diag
    ct, st = torch.cos(theta), torch.sin(theta)
    px, py = rho * ct, rho * st
    big = 1e9

    def axis_range(p, d, lo, hi):
        dd = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
        t0 = (lo - p) / dd
        t1 = (hi - p) / dd
        flat = torch.abs(d) < 1e-6
        tmin = torch.where(flat, torch.full_like(d, -big), torch.minimum(t0, t1))
        tmax = torch.where(flat, torch.full_like(d, big), torch.maximum(t0, t1))
        return tmin, tmax

    tx0, tx1 = axis_range(px, -st, 0.0, w - 1.0)
    ty0, ty1 = axis_range(py, ct, 0.0, h - 1.0)
    t_min = torch.maximum(tx0, ty0)
    t_max = torch.minimum(tx1, ty1)
    span = torch.clamp(t_max - t_min, min=0.0)

    S = cfg.n_samples
    ts = t_min[:, None] + (torch.arange(S, dtype=torch.float32, device=dev)[None, :] + 0.5) / S * span[:, None]
    sx = px[:, None] - st[:, None] * ts
    sy = py[:, None] + ct[:, None] * ts
    n_obins = 32
    obin = torch.floor((torch.atan2(gy, gx) % math.pi) * (n_obins / math.pi)).to(torch.int32)
    obin = torch.clamp(obin, 0, n_obins - 1)
    mag_level = torch.clamp(torch.round(mag / cfg.grad_threshold * 8.0), 0, 63).to(torch.int32)
    code = obin + n_obins * mag_level
    xi = torch.clamp(torch.round(sx).long(), 0, w - 1)
    yi = torch.clamp(torch.round(sy).long(), 0, h - 1)
    code_s = code[yi, xi]
    obin_s = code_s % n_obins
    m_s = torch.div(code_s, n_obins, rounding_mode="floor").float() * (cfg.grad_threshold / 8.0)
    strong_s = code_s >= 4 * n_obins
    tbin_line = torch.floor(theta * (n_obins / math.pi)).to(torch.int32) % n_obins
    d_bin = torch.abs(obin_s - tbin_line[:, None])
    d_bin = torch.minimum(d_bin, n_obins - d_bin)
    tol_bins = max(int(round(cfg.support_angle_deg / (180.0 / n_obins))), 1)
    support = strong_s & (d_bin <= tol_bins)
    support = support & (span[:, None] > 0)
    support = _close_gaps(support, cfg.max_gap)

    s0, s1 = _longest_run(support)
    step_len = span / S
    t0 = t_min + (s0.float() + 0.5) * step_len
    t1 = t_min + (s1.float() + 0.5) * step_len
    p0 = torch.stack([px - st * t0, py + ct * t0], dim=-1)
    p1 = torch.stack([px - st * t1, py + ct * t1], dim=-1)
    length = torch.abs(t1 - t0)

    ar = torch.arange(S, device=dev)[None, :]
    in_run = (ar >= s0[:, None]) & (ar <= s1[:, None])
    resp = torch.sum(torch.where(in_run, m_s, torch.zeros_like(m_s)), dim=1) / torch.clamp(
        torch.sum(in_run, dim=1), min=1)

    min_len = cfg.min_length_frac * min(h, w)
    valid = (length >= min_len) & (peak_score > 0)

    score = torch.where(valid, length * (1.0 + 0.01 * resp), torch.full_like(length, -1.0))
    mid = 0.5 * (p0 + p1)
    d_theta = torch.abs(theta[:, None] - theta[None, :])
    d_theta = torch.minimum(d_theta, math.pi - d_theta)
    nx, ny = ct, st
    perp = torch.abs(mid[:, None, 0] * nx[None, :] + mid[:, None, 1] * ny[None, :] - rho[None, :])
    similar = (d_theta < _deg2rad_f32(4.0)) & (perp < 3.0 * cfg.rho_res)
    ids = torch.arange(score.shape[0], device=dev)
    higher = (score[None, :] > score[:, None]) | (
        (score[None, :] == score[:, None]) & (ids[None, :] < ids[:, None]))
    suppressed = torch.any(similar & higher & valid[None, :], dim=1)
    valid = valid & ~suppressed

    final_score = torch.where(valid, score, torch.full_like(score, -1.0))
    top_s, top_i = top_k(final_score, cfg.n_lines)
    p0 = p0[top_i]
    p1 = p1[top_i]
    length = length[top_i]
    resp = resp[top_i]
    valid = top_s > 0
    seg_angle = torch.atan2(p1[:, 1] - p0[:, 1], p1[:, 0] - p0[:, 0])

    if with_desc:
        desc = lbd_descriptor(img, p0, p1, valid, cfg)
    else:
        desc = torch.zeros((p0.shape[0], 256), dtype=torch.int8, device=dev)
    return LineFeatures(p0=p0, p1=p1, angle=seg_angle, length=length, response=resp, desc=desc, valid=valid)


# ---------------------------------------------------------------------------
# LBD descriptor
# ---------------------------------------------------------------------------

_PROJ_SEED = 7


def _projection_matrix(dim_in: int, dim_out: int = 256) -> np.ndarray:
    rng = np.random.default_rng(_PROJ_SEED)
    return rng.normal(size=(dim_in, dim_out)).astype(np.float32)


def lbd_descriptor(img, p0, p1, valid, cfg: LineConfig) -> torch.Tensor:
    """LBD band statistics + random-projection binarization -> ±1 int8 [N, 256]."""
    dev = img.device
    blurred = image_ops.gaussian_blur(img, sigma=1.0, radius=2)
    gx, gy = image_ops.sobel_gradients(blurred)

    n = p0.shape[0]
    B = cfg.n_bands
    Wb = cfg.band_width
    S = cfg.lbd_samples

    d = p1 - p0
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    dn = d / torch.clamp(length, min=1e-6)
    nn = torch.stack([-dn[:, 1], dn[:, 0]], dim=-1)

    ts = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    half = (B * Wb - 1) / 2.0
    rows_per_band = -(-Wb // 3)
    row_in_band = np.arange(0, Wb, 3, dtype=np.float32)
    offs_np = (np.arange(B, dtype=np.float32)[:, None] * Wb + row_in_band[None, :]).reshape(-1) - half
    offs = torch.as_tensor(offs_np.astype(np.float32), device=dev)

    base = p0[:, None, :] + d[:, None, :] * ts[None, :, None]
    uv = base[:, :, None, :] + nn[:, None, None, :] * offs[None, None, :, None]
    G = torch.stack([gx, gy], dim=-1)
    himg, wimg = gx.shape
    xi = torch.clamp(torch.round(uv[..., 0]).long(), 0, wimg - 1)
    yi = torch.clamp(torch.round(uv[..., 1]).long(), 0, himg - 1)
    g_s = G[yi, xi]
    gx_s = g_s[..., 0]
    gy_s = g_s[..., 1]
    g_par = gx_s * dn[:, None, None, 0] + gy_s * dn[:, None, None, 1]
    g_perp = gx_s * nn[:, None, None, 0] + gy_s * nn[:, None, None, 1]

    sigma_g = half / 2.0 + 1e-6
    wg = torch.exp(-0.5 * (offs / sigma_g) ** 2)[None, None, :]
    zero = torch.zeros((), device=dev)
    feats = torch.stack(
        [
            torch.maximum(g_perp, zero) * wg,
            torch.maximum(-g_perp, zero) * wg,
            torch.maximum(g_par, zero) * wg,
            torch.maximum(-g_par, zero) * wg,
        ],
        dim=-1,
    )
    bands = feats.reshape(n, S, B, rows_per_band, 4).sum(dim=3)
    mean = bands.mean(dim=1)
    std = bands.std(dim=1, correction=0)
    vec = torch.cat([mean, std], dim=-1).reshape(n, B * 8)
    vec = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-6)

    proj = torch.as_tensor(_projection_matrix(B * 8), device=dev)
    bits = torch.matmul(vec, proj) >= 0
    one = torch.ones((), dtype=torch.int8, device=dev)
    desc = torch.where(bits, one, -one)
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


# ---------------------------------------------------------------------------
# Stereo line association (rectified, descriptor-free)
# ---------------------------------------------------------------------------


def vertical_overlap(l0: LineFeatures, l1: LineFeatures) -> torch.Tensor:
    y0min = torch.minimum(l0.p0[:, 1], l0.p1[:, 1])[:, None]
    y0max = torch.maximum(l0.p0[:, 1], l0.p1[:, 1])[:, None]
    y1min = torch.minimum(l1.p0[:, 1], l1.p1[:, 1])[None, :]
    y1max = torch.maximum(l1.p0[:, 1], l1.p1[:, 1])[None, :]
    inter = torch.clamp(torch.minimum(y0max, y1max) - torch.maximum(y0min, y1min), min=0.0)
    shorter = torch.clamp(torch.minimum(y0max - y0min, y1max - y1min), min=1e-6)
    return inter / shorter


def match_stereo_lines_geom(left: LineFeatures, right: LineFeatures, img_l, img_r,
                            min_disparity: float = 0.1, max_disparity: float = 192.0,
                            min_overlap: float = 0.5, max_angle_diff_deg: float = 10.0,
                            n_verify: int = 16, verify_tol: float = 24.0):
    """Returns (disp0 [N], disp1 [N], idx_r [N], ok [N]) aligned with left slots."""
    dev = img_l.device
    lr = right.line_coeffs()
    a, b, c = lr[:, 0], lr[:, 1], lr[:, 2]
    stable = torch.abs(a) > 0.05
    a_safe = torch.where(torch.abs(a) < 1e-6, torch.full_like(a, 1e-6), a)

    def xr_at(y):
        return -(c[None, :] + b[None, :] * y[:, None]) / a_safe[None, :]

    d0p = left.p0[:, 0][:, None] - xr_at(left.p0[:, 1])
    d1p = left.p1[:, 0][:, None] - xr_at(left.p1[:, 1])
    ratio = torch.minimum(d0p, d1p) / torch.clamp(torch.maximum(d0p, d1p), min=1e-6)

    da = torch.abs(left.angle[:, None] - right.angle[None, :])
    da = torch.minimum(da, 2 * math.pi - da)
    da = torch.minimum(da, math.pi - da)
    ov = vertical_overlap(left, right)
    gate = (
        (da <= _deg2rad_f32(max_angle_diff_deg))
        & (ov >= min_overlap)
        & stable[None, :]
        & (d0p > min_disparity) & (d1p > min_disparity)
        & (d0p < max_disparity) & (d1p < max_disparity)
        & (ratio > 0.6)
        & left.valid[:, None] & right.valid[None, :]
    )
    big = torch.full((), 1e9, device=dev)
    g_cost = torch.where(gate, 2.0 * torch.rad2deg(da) + 20.0 * (1.0 - ov), big)
    c1 = torch.argmin(g_cost, dim=1)
    rows = torch.arange(g_cost.shape[0], device=dev)
    g2 = g_cost.clone()
    g2[rows, c1] = 1e9
    c2 = torch.argmin(g2, dim=1)
    cands = torch.stack([c1, c2], dim=1)

    S = n_verify
    ts = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) / S
    pl_ = left.p0[:, None, :] + (left.p1 - left.p0)[:, None, :] * ts[None, :, None]
    h, w = img_l.shape
    xi = torch.clamp(torch.round(pl_[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(pl_[..., 1]).long(), 0, h - 1)
    I_l = img_l[yi, xi]
    ac = a[cands]
    bc = b[cands]
    cc = c[cands]
    ac_safe = torch.where(torch.abs(ac) < 1e-6, torch.full_like(ac, 1e-6), ac)
    xr = -(cc[..., None] + bc[..., None] * pl_[..., 1][:, None, :]) / ac_safe[..., None]
    xri = torch.clamp(torch.round(xr).long(), 0, w - 1)
    I_r = img_r[yi[:, None, :], xri]
    photo = torch.mean(torch.abs(I_l[:, None, :] - I_r), dim=-1)
    g_top = torch.gather(g_cost, 1, cands)
    total = torch.where(g_top < 1e8, photo + 0.5 * g_top, big)
    pick = torch.argmin(total, dim=1)
    idx_r = torch.gather(cands, 1, pick[:, None])[:, 0]
    best = torch.gather(total, 1, pick[:, None])[:, 0]
    best_photo = torch.gather(photo, 1, pick[:, None])[:, 0]
    ok = (best < 1e8) & (best_photo < verify_tol)
    back = torch.argmin(torch.where(gate, g_cost, big), dim=0)
    ok = ok & (back[idx_r] == rows)
    d0 = torch.gather(d0p, 1, idx_r[:, None])[:, 0]
    d1 = torch.gather(d1p, 1, idx_r[:, None])[:, 0]
    return d0, d1, idx_r.to(torch.int32), ok
