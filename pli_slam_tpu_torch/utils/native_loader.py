"""ctypes bindings for the port's native PNG decoder and stereo prefetcher.

`csrc/slamio.cpp` (the port's own copy of the reference's
native/dataloader.cpp, with its own inflate, so it needs no libpng or zlib)
is compiled with g++ on first use into `build/native/` at the repository
root, one file per source digest. Unlike the reference, which builds into
`native/` and falls back to pillow without a word when the build fails,
the port has no fallback: a failed build raises with the compiler's
message, and every PNG the port reads goes through this library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "csrc" / "slamio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

_lib = None


def build() -> ctypes.CDLL:
    """Compile the library (once per source digest) and bind it. Raises
    RuntimeError with the compiler's output if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libslamio_{digest}.so"
    if not so.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ / c++) found to build the native PNG loader")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, str(SRC), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.remove(tmp)
            raise RuntimeError(f"building the native PNG loader failed ({' '.join(cmd)}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    c_int_p = ctypes.POINTER(ctypes.c_int)
    f_p = ctypes.POINTER(ctypes.c_float)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p, f_p, f_p, ctypes.c_int, ctypes.c_int]
    lib.loader_size.restype = ctypes.c_longlong
    lib.loader_size.argtypes = [ctypes.c_void_p]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_png.restype = ctypes.c_int
    lib.decode_png.argtypes = [ctypes.c_char_p, f_p, ctypes.c_int, ctypes.c_int]
    lib.png_dims.restype = ctypes.c_int
    lib.png_dims.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
    lib.png_info.restype = ctypes.c_int
    lib.png_info.argtypes = [ctypes.c_char_p, c_int_p, c_int_p, c_int_p, c_int_p]
    lib.png_read_raw.restype = ctypes.c_int
    lib.png_read_raw.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_longlong]
    _lib = lib
    return lib


def _check(rc: int, path: str) -> None:
    if rc == -4:
        raise ValueError(f"{path}: PNG format not supported (palette, interlaced, or below 8 bits per sample)")
    if rc != 0:
        raise OSError(f"{path}: cannot decode PNG (rc {rc})")


def read_png(path: str) -> np.ndarray:
    """The PNG's samples as stored: [H, W] for gray, [H, W, C] otherwise,
    uint8 or uint16 — what `np.asarray(PIL.Image.open(path))` gives for
    8-bit gray, gray+alpha, RGB, RGBA and 16-bit gray."""
    lib = build()
    w, h, c, d = (ctypes.c_int() for _ in range(4))
    p = os.fsencode(path)
    _check(lib.png_info(p, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), ctypes.byref(d)), path)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8 if d.value == 8 else np.uint16)
    _check(lib.png_read_raw(p, out.ctypes.data_as(ctypes.c_void_p), out.nbytes), path)
    return out


def decode_png(path: str) -> np.ndarray:
    """One image as 8-bit gray float32 [H, W], as the prefetcher delivers it
    (16-bit samples keep their high byte, colour through libpng's weights)."""
    lib = build()
    w, h = ctypes.c_int(), ctypes.c_int()
    p = os.fsencode(path)
    _check(lib.png_dims(p, ctypes.byref(w), ctypes.byref(h)), path)
    out = np.empty((h.value, w.value), np.float32)
    _check(lib.decode_png(p, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), w.value, h.value), path)
    return out


class StereoPrefetcher:
    """Stereo pairs decoded ahead by `n_workers` C++ threads into a bounded
    ring of `ring` frames; iterating yields (left, right) float32 [H, W] in order."""

    def __init__(self, left_paths: list[str], right_paths: list[str], width: int, height: int,
                 n_workers: int = 2, ring: int = 8):
        self._lib = build()
        self._handle = self._lib.loader_create(
            "\n".join(left_paths).encode(), "\n".join(right_paths).encode(), n_workers, ring)
        if not self._handle:
            raise RuntimeError(f"loader_create failed: {len(left_paths)} left and {len(right_paths)} right paths")
        self.width = width
        self.height = height

    def __len__(self):
        return int(self._lib.loader_size(self._handle))

    def __iter__(self):
        f_p = ctypes.POINTER(ctypes.c_float)
        while True:
            left = np.empty((self.height, self.width), np.float32)
            right = np.empty((self.height, self.width), np.float32)
            rc = self._lib.loader_next(self._handle, left.ctypes.data_as(f_p), right.ctypes.data_as(f_p),
                                       self.width, self.height)
            if rc == -1:
                return
            if rc != 0:
                raise RuntimeError(f"native decode failed (rc {rc})")
            yield left, right

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
