"""ORB extraction: pyramid FAST + IC angle + steered pool-BRIEF
(port of pli_slam_tpu.ops.orb).

Same design as the reference: grid-cell top-k, then a per-level top-K;
intensity-centroid moments as separable shifted-add filters; the
seeded pool-BRIEF pattern (shared bit for bit: it is built with numpy
from the same seed). Ties in the per-level top-K (FAST scores are
often equal) are broken by the lower candidate index, as
`jax.lax.top_k` does (see ops.indexing.top_k).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pli_slam_tpu_torch.utils.config import OrbConfig
from pli_slam_tpu_torch.ops import fast as fast_ops
from pli_slam_tpu_torch.ops import image as image_ops
from pli_slam_tpu_torch.ops.indexing import top_k
from pli_slam_tpu_torch.ops.consts import device_const

PATCH_RADIUS = 15
EDGE_MARGIN = 19
_POOL_N = 128


def brief_pattern(seed: int = 1234, n_bits: int = 256, sigma: float = 31.0 / 5.0) -> np.ndarray:
    """The classic seeded Gaussian BRIEF pair pattern: [n_bits, 2, 2] int
    offsets in [-13, 13]. Extraction uses the pool pattern below instead."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -13, 13).astype(np.int32)


def _brief_pool_and_pairs(seed: int = 1234, n_bits: int = 256, sigma: float = 31.0 / 5.0):
    rng = np.random.default_rng(seed)
    pool = np.clip(np.round(rng.normal(0.0, sigma, size=(_POOL_N, 2))), -13, 13)
    pairs = np.empty((n_bits, 2), np.int32)
    seen = set()
    k = 0
    while k < n_bits:
        a, b = rng.integers(0, _POOL_N, 2)
        if a == b or (a, b) in seen or (b, a) in seen:
            continue
        seen.add((a, b))
        pairs[k] = (a, b)
        k += 1
    return pool.astype(np.float32), pairs


_POOL, _PAIRS = _brief_pool_and_pairs()


@dataclasses.dataclass(frozen=True)
class Features:
    """Padded keypoint set in level-0 pixel coordinates."""

    uv: torch.Tensor  # [N, 2] float32
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor  # [N] float32
    octave: torch.Tensor  # [N] int32
    scale: torch.Tensor  # [N] float32
    desc: torch.Tensor  # [N, 256] int8 ±1 (0 rows for invalid)
    valid: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dtype=torch.int32)


def level_feature_counts(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    q = 1.0 / scale_factor
    first = n_features * (1 - q) / (1 - q ** n_levels)
    counts = [int(round(first * q ** lvl)) for lvl in range(n_levels)]
    counts[-1] = max(n_features - sum(counts[:-1]), 0)
    return counts


def _ic_angle_maps(img: torch.Tensor):
    r = PATCH_RADIUS
    ones = [1.0] * (2 * r + 1)
    ramp = [float(v) for v in range(-r, r + 1)]
    col_sum = image_ops._sep_filter(img, ones, -2)
    m10 = image_ops._sep_filter(col_sum, ramp, -1)
    row_sum = image_ops._sep_filter(img, ones, -1)
    m01 = image_ops._sep_filter(row_sum, ramp, -2)
    return m10, m01


def _cell_topk_candidates(score: torch.Tensor, cell: int, k_cell: int):
    """Per-cell top-k by iterative argmax (first index on ties) -> flat (scores, ys, xs)."""
    h, w = score.shape[-2:]
    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    s = torch.nn.functional.pad(score, (0, wp - w, 0, hp - h))
    ncy, ncx = hp // cell, wp // cell
    cells = s.reshape(ncy, cell, ncx, cell).transpose(1, 2).reshape(ncy * ncx, cell * cell)
    nc = ncy * ncx
    col = torch.arange(cell * cell, device=score.device)
    top_s, top_i = [], []
    neg_inf = torch.full((), float("-inf"), device=score.device)
    for _ in range(k_cell):
        i = torch.argmax(cells, dim=-1)
        top_s.append(torch.gather(cells, -1, i[:, None])[:, 0])
        top_i.append(i)
        cells = torch.where(col == i[:, None], neg_inf, cells)
    ts = torch.stack(top_s, dim=-1)
    ti = torch.stack(top_i, dim=-1)
    cid = torch.arange(nc, device=score.device)[:, None]
    ys = (cid // ncx) * cell + ti // cell
    xs = (cid % ncx) * cell + ti % cell
    return ts.reshape(-1), ys.reshape(-1), xs.reshape(-1)


def _extract_level(img: torch.Tensor, k_level: int, cfg: OrbConfig):
    h, w = img.shape
    dev = img.device
    score, _ = fast_ops.detect(img, cfg.fast_threshold, cfg.fast_min_threshold)
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= EDGE_MARGIN) & (ys < h - EDGE_MARGIN) & (xs >= EDGE_MARGIN) & (xs < w - EDGE_MARGIN)
    score = torch.where(inside, score, torch.zeros_like(score))

    cell = 32
    n_cells = (-(-h // cell)) * (-(-w // cell))
    k_cell = max(1, min(8, -(-4 * k_level // max(n_cells, 1))))
    cand_s, cand_y, cand_x = _cell_topk_candidates(score, cell, k_cell)
    top_s, top_i = top_k(cand_s, min(k_level, cand_s.shape[0]))
    kx = cand_x[top_i]
    ky = cand_y[top_i]
    valid = top_s > 0.0

    m10, m01 = _ic_angle_maps(img)
    # a candidate of a cell past the image's edge (a level that is not a whole number of cells, with fewer corners
    # than slots) lies outside it: JAX clamps the gather, so does the port
    ky_in, kx_in = torch.clamp(ky, 0, h - 1), torch.clamp(kx, 0, w - 1)
    angle = torch.atan2(m01[ky_in, kx_in], m10[ky_in, kx_in])

    blurred = image_ops.gaussian_blur(img, sigma=2.0, radius=3)
    pool = device_const("orb_pool", dev, lambda: _POOL)
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = pool[:, 0], pool[:, 1]
    rx = ca[:, None] * px[None] - sa[:, None] * py[None]
    ry = sa[:, None] * px[None] + ca[:, None] * py[None]
    sx = torch.clamp(torch.round(kx[:, None] + rx).long(), 0, w - 1)
    sy = torch.clamp(torch.round(ky[:, None] + ry).long(), 0, h - 1)
    vals = blurred[sy, sx]  # [K, pool]
    # the reference realizes the pair comparisons as one-hot matmuls at
    # HIGHEST precision, which select values exactly: a gather is the same
    pa = device_const("orb_pairs_a", dev, lambda: torch.as_tensor(_PAIRS[:, 0]).long())
    pb = device_const("orb_pairs_b", dev, lambda: torch.as_tensor(_PAIRS[:, 1]).long())
    bits = vals[:, pa] < vals[:, pb]
    one = torch.ones((), dtype=torch.int8, device=dev)
    desc = torch.where(bits, one, -one)
    desc = torch.where(valid[:, None], desc, torch.zeros_like(desc))

    k_have = top_s.shape[0]
    if k_have < k_level:
        pad = k_level - k_have

        def pad0(x):
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)

        kx, ky, top_s, angle, valid, desc = map(pad0, (kx, ky, top_s, angle, valid, desc))
    xy = torch.stack([kx.float(), ky.float()], dim=-1)
    return xy, top_s, angle, valid, desc


def extract(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """Multi-scale ORB; `img` [H, W] float32 in [0, 255]; capacity cfg.n_features."""
    levels = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    counts = level_feature_counts(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    parts = []
    for lvl, (level_img, k_level) in enumerate(zip(levels, counts)):
        if k_level <= 0:
            continue
        xy, resp, angle, valid, desc = _extract_level(level_img, k_level, cfg)
        s = float(np.float32(cfg.scale_factor ** lvl))
        n = xy.shape[0]
        parts.append((xy * s, resp, angle,
                      torch.full((n,), lvl, dtype=torch.int32, device=img.device),
                      torch.full((n,), s, dtype=torch.float32, device=img.device),
                      desc, valid))
    cat = [torch.cat([p[i] for p in parts], dim=0) for i in range(7)]
    return Features(uv=cat[0], response=cat[1], angle=cat[2], octave=cat[3], scale=cat[4], desc=cat[5], valid=cat[6])



def pack_descriptors(desc_pm1: torch.Tensor) -> torch.Tensor:
    """±1 int8 [N, 256] -> packed words [N, 8] (bit i set where desc > 0): the
    reference's uint32 words, held as int32 bit patterns (the port's storage
    for uint32, as worldmap.stores)."""
    bits = (desc_pm1 > 0).to(torch.int64).reshape(desc_pm1.shape[0], 8, 32)
    words = torch.sum(bits << torch.arange(32, device=desc_pm1.device), dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_descriptors(packed: torch.Tensor) -> torch.Tensor:
    """Packed words [N, 8] (int32 bit patterns, or int64 in [0, 2^32)) -> ±1 int8 [N, 256]."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    bits = (words[..., None] >> torch.arange(32, device=packed.device)) & 1
    pm1 = torch.where(bits > 0, 1, -1).to(torch.int8)
    return pm1.reshape(packed.shape[0], 256)
