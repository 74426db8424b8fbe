"""The port's PNG codec and native prefetcher against pillow and the
reference (mirrors tests/test_native_loader.py).

`utils.pngio.write_png` writes 8-bit gray, 16-bit gray and 8-bit RGB with
each PNG row filter (and all five cycling row by row), at zlib levels that
give stored, fixed-Huffman and dynamic-Huffman blocks; the port's decoder
(`csrc/slamio.cpp`, built with g++ into build/native/) must read back
exactly what was written and exactly what pillow and the reference's
`_read_png` read, for these files and for pillow's own. The gray path of
the prefetcher must equal the reference's libpng loader where that one
builds. Tolerance: exact everywhere.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from pli_slam_tpu.utils import euroc as ref_euroc
from pli_slam_tpu.utils import native_loader as ref_native
from pli_slam_tpu_torch.utils import euroc, native_loader, pngio

torch.set_num_threads(1)

CASES = [((48, 64), np.uint8), ((37, 53), np.uint16), ((29, 31, 3), np.uint8)]


def _image(rng, shape, dtype):
    return rng.integers(0, 256 if dtype == np.uint8 else 65536, size=shape).astype(dtype)


@pytest.mark.parametrize("shape, dtype", CASES, ids=["gray8", "gray16", "rgb8"])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4, None], ids=["none", "sub", "up", "avg", "paeth", "cycle"])
def test_decoder_bit_exact(tmp_path, rng, shape, dtype, filter_type):
    for level in (0, 1, 9):  # stored, and compressed blocks (fixed and dynamic codes)
        img = _image(rng, shape, dtype)
        path = str(tmp_path / f"img{level}.png")
        pngio.write_png(path, img, filter_type, level)
        mine, pil = native_loader.read_png(path), np.asarray(Image.open(path))
        assert mine.dtype == pil.dtype and mine.shape == pil.shape
        np.testing.assert_array_equal(mine, img)
        np.testing.assert_array_equal(mine, pil)
        ref = ref_euroc._read_png(path)
        got = euroc._read_png(path)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_decoder_reads_pillow_files(tmp_path, rng):
    """Pillow's encoder (its own filter choice), RGBA and gray+alpha too;
    a smooth 752x480 image exercises long back-references."""
    imgs = [_image(rng, s, d) for s, d in CASES]
    imgs.append((np.add.outer(np.arange(480), np.arange(752)) // 7 % 256).astype(np.uint8))
    modes = [None] * len(imgs) + ["RGBA", "LA"]
    imgs += [_image(rng, (20, 30, 4), np.uint8), _image(rng, (20, 30, 2), np.uint8)]
    for k, (img, mode) in enumerate(zip(imgs, modes)):
        path = str(tmp_path / f"pil{k}.png")
        Image.fromarray(img, mode).save(path)
        np.testing.assert_array_equal(native_loader.read_png(path), np.asarray(Image.open(path)))


def test_gray_decode_matches_reference_loader(tmp_path, rng):
    """`decode_png` (the prefetcher's gray path): 8-bit gray as is, 16-bit by
    its high byte, RGB by libpng's fixed-point weights, as the reference's
    libpng build gives them."""
    if not ref_native.available():
        pytest.skip("the reference's native loader (libpng) does not build here")
    for k, (shape, dtype) in enumerate(CASES):
        path = str(tmp_path / f"g{k}.png")
        pngio.write_png(path, _image(rng, shape, dtype), None)
        np.testing.assert_array_equal(native_loader.decode_png(path), ref_native.decode_png(path))


def test_unsupported_and_corrupt_files_raise(tmp_path, rng):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(rng, (8, 8), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError):
        native_loader.read_png(path)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    with pytest.raises(OSError):
        native_loader.read_png(str(bad))


def test_prefetcher_streams_in_order(tmp_path):
    n = 12
    lefts, rights, truth = [], [], []
    for i in range(n):
        left, right = np.full((32, 40), i * 3, np.uint8), np.full((32, 40), i * 3 + 1, np.uint8)
        lp, rp = str(tmp_path / f"l{i}.png"), str(tmp_path / f"r{i}.png")
        pngio.write_png(lp, left, i % 5)
        pngio.write_png(rp, right)
        lefts.append(lp)
        rights.append(rp)
        truth.append((left, right))
    pf = native_loader.StereoPrefetcher(lefts, rights, 40, 32, n_workers=3, ring=4)
    assert len(pf) == n
    got = list(pf)
    assert len(got) == n
    for (left, right), (tl, tr) in zip(got, truth):
        assert left.dtype == np.float32
        np.testing.assert_array_equal(left.astype(np.uint8), tl)
        np.testing.assert_array_equal(right.astype(np.uint8), tr)
    pf.close()


def test_prefetcher_rejects_mismatched_lists():
    with pytest.raises(RuntimeError):
        native_loader.StereoPrefetcher(["a.png"], [], 10, 10)


def test_library_builds_from_source_into_build_dir():
    lib = native_loader.build()
    assert lib is native_loader.build()
    built = list(native_loader.BUILD_DIR.glob("libslamio_*.so"))
    assert built and native_loader.BUILD_DIR.parts[-2:] == ("build", "native")
