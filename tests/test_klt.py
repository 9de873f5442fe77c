import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.ops import detect, interp, klt, pyramid
from tests import reference_klt


def synth_image(rng, H=96, W=128, n_blobs=40):
    """Smooth random blob image with texture everywhere."""
    img = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:H, 0:W]
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        amp = rng.uniform(30, 120)
        sig = rng.uniform(2, 6)
        img += amp * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * sig**2))
    return np.clip(img, 0, 255).astype(np.float32)


def shift_image(img, dx, dy):
    """Bilinear shifted image: out(x, y) = img(x - dx, y - dy)."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W]
    sx = np.clip(xs - dx, 0, W - 1)
    sy = np.clip(ys - dy, 0, H - 1)
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    x1 = np.minimum(x0 + 1, W - 1)
    y1 = np.minimum(y0 + 1, H - 1)
    fx, fy = sx - x0, sy - y0
    return (
        (1 - fx) * (1 - fy) * img[y0, x0]
        + fx * (1 - fy) * img[y0, x1]
        + (1 - fx) * fy * img[y1, x0]
        + fx * fy * img[y1, x1]
    ).astype(np.float32)


def test_sample_patches_matches_reference_bilinear(rng):
    img = synth_image(rng)
    centers = rng.uniform([5, 5], [120, 90], size=(32, 2)).astype(np.float32)
    patches = np.asarray(interp.sample_patches_matmul(jnp.asarray(img), jnp.asarray(centers), 7))
    for n in range(0, 32, 7):
        for oy in range(7):
            for ox in range(7):
                want = reference_klt.get_pixel_value(img, centers[n, 0] + ox - 3, centers[n, 1] + oy - 3)
                np.testing.assert_allclose(patches[n, oy, ox], want, rtol=1e-4, atol=1e-2)


def test_sample_patches_boundary_clamp(rng):
    img = synth_image(rng)
    centers = np.array([[0.0, 0.0], [127.0, 95.0], [-3.0, 50.0], [130.0, 2.0]], np.float32)
    patches = np.asarray(interp.sample_patches_matmul(jnp.asarray(img), jnp.asarray(centers), 7))
    assert np.all(np.isfinite(patches))
    for n in range(len(centers)):
        for oy in range(7):
            for ox in range(7):
                want = reference_klt.get_pixel_value(img, centers[n, 0] + ox - 3, centers[n, 1] + oy - 3)
                np.testing.assert_allclose(patches[n, oy, ox], want, rtol=1e-4, atol=1e-2)


def test_pyramid_down2_matches_reference(rng):
    img = synth_image(rng, H=97, W=129)  # odd dims exercise truncation
    got = np.asarray(pyramid.down2(jnp.asarray(img)))
    want = reference_klt.down2(img)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("inverse", [False, True])
def test_klt_level_recovers_shift(rng, inverse):
    img1 = synth_image(rng)
    shift = (1.7, -1.2)
    img2 = shift_image(img1, *shift)
    kp1 = rng.uniform([10, 10], [115, 85], size=(64, 2)).astype(np.float32)
    cfg = klt.KLTConfig(inverse=inverse)
    kp2, ok = klt.klt_level(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(kp1), jnp.asarray(kp1),
        jnp.ones(64, bool), cfg,
    )
    kp2, ok = np.asarray(kp2), np.asarray(ok)
    assert ok.mean() > 0.8
    flow = kp2[ok] - kp1[ok]
    err = np.abs(flow - np.asarray(shift))
    assert np.median(err[:, 0]) < 0.2 and np.median(err[:, 1]) < 0.2, flow[:5]


@pytest.mark.parametrize("inverse", [False, True])
def test_klt_pyramid_recovers_large_shift(rng, inverse):
    img1 = synth_image(rng, H=160, W=224)
    shift = (9.4, -6.3)
    img2 = shift_image(img1, *shift)
    kp1 = rng.uniform([20, 20], [200, 140], size=(64, 2)).astype(np.float32)
    cfg = klt.KLTConfig(inverse=inverse)
    kp2, ok = klt.track(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(kp1), jnp.asarray(kp1),
        jnp.ones(64, bool), cfg,
    )
    kp2, ok = np.asarray(kp2), np.asarray(ok)
    assert ok.mean() > 0.7
    flow = kp2[ok] - kp1[ok]
    err = np.abs(flow - np.asarray(shift))
    assert np.median(err[:, 0]) < 0.25 and np.median(err[:, 1]) < 0.25


def test_klt_matches_numpy_reference_port(rng):
    """Batched device KLT vs the NumPy port of algorithm.cpp on the same data."""
    img1 = synth_image(rng, H=80, W=112)
    img2 = shift_image(img1, 2.3, 1.1)
    kp1 = rng.uniform([12, 12], [100, 68], size=(12, 2)).astype(np.float32)
    got, got_ok = klt.track(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(kp1), jnp.asarray(kp1),
        jnp.ones(12, bool), klt.KLTConfig(),
    )
    want, want_ok = reference_klt.klt_4layer(img1, img2, kp1, kp1)
    got, got_ok = np.asarray(got), np.asarray(got_ok)
    # The implementations may disagree on individual hard lanes (different fp
    # paths change break iterations); compare on lanes both deem good.
    both = got_ok & want_ok
    assert both.mean() > 0.7
    np.testing.assert_allclose(got[both], want[both], atol=0.35)


def test_klt_invalid_lanes_pass_through(rng):
    img1 = synth_image(rng)
    img2 = shift_image(img1, 1.0, 0.0)
    kp1 = rng.uniform([10, 10], [115, 85], size=(8, 2)).astype(np.float32)
    valid = np.array([True, False] * 4)
    kp2, ok = klt.track(
        jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(kp1), jnp.asarray(kp1),
        jnp.asarray(valid), klt.KLTConfig(),
    )
    assert not np.any(np.asarray(ok)[~valid])


def test_detect_finds_corners(rng):
    # Checkerboard: corners at cell boundaries.
    H, W = 96, 128
    cell = 16
    ys, xs = np.mgrid[0:H, 0:W]
    img = (((ys // cell) + (xs // cell)) % 2 * 200.0).astype(np.float32)
    pos, valid = detect.detect(jnp.asarray(img), detect.GFTTConfig(max_corners=40, min_distance=8))
    pos, valid = np.asarray(pos), np.asarray(valid)
    assert valid.sum() >= 20
    # All detections near grid crossings.
    p = pos[valid]
    assert np.all(np.abs(((p + cell / 2) % cell) - cell / 2) <= 2.5)


def test_detect_respects_mask(rng):
    img = synth_image(rng)
    existing = np.array([[40.0, 40.0], [90.0, 60.0]], np.float32)
    mask = detect.occupancy_mask(img.shape, jnp.asarray(existing), jnp.ones(2, bool), half=10)
    pos, valid = detect.detect(jnp.asarray(img), detect.GFTTConfig(max_corners=50, min_distance=5), exclude_mask=mask)
    pos, valid = np.asarray(pos), np.asarray(valid)
    for e in existing:
        d = np.abs(pos[valid] - e).max(axis=1)
        assert np.all(d > 9.0), (e, pos[valid][d <= 9.0])


def test_detect_jits(rng):
    img = jnp.asarray(synth_image(rng))
    f = jax.jit(lambda im: detect.detect(im))
    pos, valid = f(img)
    assert pos.shape == (150, 2)
