"""Native C++ loader: PNG decode parity with PIL, prefetch ordering."""

import os

import numpy as np
import pytest

from legoslam.native import loader


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """A fake KITTI sequence directory with deterministic images."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for cam in (0, 1):
        os.makedirs(root / f"image_{cam}")
    imgs = []
    for i in range(6):
        l = rng.integers(0, 256, size=(64, 96)).astype(np.uint8)
        r = rng.integers(0, 256, size=(64, 96)).astype(np.uint8)
        _write_png(str(root / "image_0" / f"{i:06d}.png"), l)
        _write_png(str(root / "image_1" / f"{i:06d}.png"), r)
        imgs.append((l, r))
    return str(root), imgs


def test_available():
    assert loader.available(), "native loader failed to build (g++/libpng expected)"


def test_decode_matches_pil(kitti_dir):
    root, imgs = kitti_dir
    got = loader.decode_png(os.path.join(root, "image_0", "000000.png"))
    assert got is not None
    np.testing.assert_array_equal(got, imgs[0][0].astype(np.float32))


def test_decode_half_is_even_subsample(kitti_dir):
    root, imgs = kitti_dir
    got = loader.decode_png(os.path.join(root, "image_0", "000001.png"), half=True)
    want = imgs[1][0][::2, ::2].astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_prefetch_in_order(kitti_dir):
    root, imgs = kitti_dir
    pl = loader.PrefetchLoader(root, count=6, half=False, workers=3, prefetch=4)
    for i in range(6):
        out = pl.next()
        assert out is not None
        idx, l, r = out
        assert idx == i
        np.testing.assert_array_equal(l, imgs[i][0].astype(np.float32))
        np.testing.assert_array_equal(r, imgs[i][1].astype(np.float32))
    assert pl.next() is None
    pl.close()


def test_prefetch_half(kitti_dir):
    root, imgs = kitti_dir
    pl = loader.PrefetchLoader(root, count=3, half=True)
    idx, l, r = pl.next()
    np.testing.assert_array_equal(l, imgs[0][0][::2, ::2].astype(np.float32))
    pl.close()
