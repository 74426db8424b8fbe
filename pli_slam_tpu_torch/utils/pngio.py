"""A PNG writer in the standard library (`zlib` and `struct`), for the
dataset layouts that tests and chip_smoke.py write: 8-bit gray (uint8
[H, W]), 16-bit gray (uint16 [H, W]) and 8-bit RGB (uint8 [H, W, 3]), each
row filtered with the chosen PNG filter (0 none, 1 sub, 2 up, 3 average,
4 Paeth; `None` cycles through all five, row by row). The port reads PNGs
with `utils.native_loader.read_png`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_row(kind: int, row: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    """Filter one row of bytes (int16 arrays) with PNG filter `kind`."""
    left = np.concatenate([np.zeros(bpp, np.int16), row[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        ul = np.concatenate([np.zeros(bpp, np.int16), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    else:
        raise ValueError(f"PNG filter type {kind} is not 0-4")
    return ((row - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int | None = 0, level: int = 6) -> None:
    """Write uint8 [H, W] (8-bit gray), uint16 [H, W] (16-bit gray) or uint8
    [H, W, 3] (8-bit RGB) as a PNG; `level` is zlib's (0 gives stored blocks)."""
    img = np.asarray(img)
    if img.dtype == np.uint8 and img.ndim == 2:
        color, depth, data = 0, 8, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        color, depth, data = 0, 16, img.astype(">u2")
    elif img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        color, depth, data = 2, 8, img
    else:
        raise ValueError(f"write_png takes uint8 [H,W], uint16 [H,W] or uint8 [H,W,3], not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    bpp = (3 if color == 2 else 1) * depth // 8
    rows = np.ascontiguousarray(data).view(np.uint8).reshape(h, w * bpp).astype(np.int16)
    out, up = [], np.zeros(w * bpp, np.int16)
    for y in range(h):
        kind = y % 5 if filter_type is None else filter_type
        out.append(bytes([kind]) + _filter_row(kind, rows[y], up, bpp).tobytes())
        up = rows[y]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(b"".join(out), level))
                + _chunk(b"IEND", b""))

