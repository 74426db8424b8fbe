"""Image ops: Gaussian blur, bilinear resize, pyramids, gradients
(port of pli_slam_tpu.ops.image).

Images are float32 `[H, W]` (single channel), values in [0, 255]. The
filters keep the reference's shifted-add form with `roll` (wrapping
edges) and its summation order, so results agree with the reference
bit for bit where the arithmetic does.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _sep_filter(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """1-D filter along `axis` via shifted adds: out = sum_i taps[i] *
    roll(img, radius - i). `taps` is a 1-D tensor or a sequence of floats."""
    n = len(taps)
    radius = n // 2
    out = torch.zeros_like(img)
    for i in range(n):
        out = out + taps[i] * torch.roll(img, radius - i, dims=axis)
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0, radius: int = 3) -> torch.Tensor:
    k = gaussian_kernel1d(sigma, radius, img.device)
    return _sep_filter(_sep_filter(img, k, -2), k, -1)


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize (half-pixel centers, like cv::resize)."""
    h, w = img.shape
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * np.float32(h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * np.float32(w / out_w) - 0.5
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    top = a * (1 - wx) + b * wx
    bot = c * (1 - wx) + d * wx
    return top * (1 - wy) + bot * wy


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float) -> list[tuple[int, int]]:
    shapes = []
    for lvl in range(n_levels):
        s = scale_factor ** lvl
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float) -> list[torch.Tensor]:
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(bilinear_resize(levels[-1], *shapes[lvl]))
    return levels


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    smooth = (1.0, 2.0, 1.0)
    diff = (-1.0, 0.0, 1.0)
    gx = _sep_filter(_sep_filter(img, smooth, -2), diff, -1)
    gy = _sep_filter(_sep_filter(img, smooth, -1), diff, -2)
    return gx, gy


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample `img` [H, W] at float pixel coordinates uv [..., 2] = (x, y), clamped to the image."""
    h, w = img.shape
    x = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.long(), y0f.long()
    v00, v01 = img[y0, x0], img[y0, x0 + 1]
    v10, v11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest pixel (rounded half to even, as rBRIEF's GET_VALUE) at uv [..., 2] = (x, y), clamped."""
    h, w = img.shape
    x = torch.clamp(torch.round(uv[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(uv[..., 1]).long(), 0, h - 1)
    return img[y, x]
