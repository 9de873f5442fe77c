"""The Pallas (Triton) anchored-KLT kernel against the XLA formulation.

The kernel (ops/klt_pallas.py) must reproduce ops/klt.py's anchored level
loop: same clamped bilinear taps, GN update, divergence/convergence/NaN
semantics and level-to-level restarts.  Here it runs in Pallas interpret
mode; chip_smoke.py compares the compiled kernel on the GPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from legoslam.ops import klt as klt_ops
from legoslam.ops import klt_pallas, pyramid as pyr_ops
from tests import reference_klt
from tests.cuda_lowering import lower_for_cuda

kernel = functools.partial(klt_pallas.klt_pyramid_anchored_pallas, interpret=True)


def _scene(rng, H=188, W=620, n=128, margin=15.0):
    base = jnp.asarray(rng.uniform(0, 1, (12, 39)), jnp.float32)
    img1 = jax.image.resize(base, (H, W), "bilinear") * 255.0
    img2 = jnp.roll(img1, (1, 2), (0, 1))
    kp1 = jnp.stack([
        jnp.asarray(rng.uniform(margin, W - margin, n), jnp.float32),
        jnp.asarray(rng.uniform(margin, H - margin, n), jnp.float32),
    ], axis=-1)
    valid = jnp.asarray(rng.uniform(size=n) > 0.1)
    return img1, img2, kp1, valid


def _problem(rng, levels=3, inverse=False, **scene_kw):
    img1, img2, kp1, valid = _scene(rng, **scene_kw)
    cfg = klt_ops.KLTConfig(levels=levels, inverse=inverse)
    anchors = klt_ops.extract_anchors(tuple(pyr_ops.build_pyramid(img1, levels)), kp1, cfg)
    pyr2 = tuple(pyr_ops.build_pyramid(img2, levels))
    return cfg, anchors, kp1, pyr2, valid


def _xla(cfg, anchors, kp1, pyr2, guess, valid):
    return klt_ops._pyramid_anchored_xla(anchors, kp1, pyr2, guess, valid, cfg)


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_matches_xla(rng, inverse):
    """All three levels of the 188x620 pyramid, kernel vs XLA."""
    cfg, anchors, kp1, pyr2, valid = _problem(rng, inverse=inverse)
    guess = kp1 + jnp.asarray([1.5, 0.5])
    ref_kp2, ref_ok = _xla(cfg, anchors, kp1, pyr2, guess, valid)
    pal_kp2, pal_ok = kernel(anchors, kp1, pyr2, guess, valid, inverse=inverse)
    ref_ok, pal_ok = np.asarray(ref_ok), np.asarray(pal_ok)
    assert (ref_ok == pal_ok).mean() > 0.97
    both = ref_ok & pal_ok
    assert both.sum() > 0.7 * np.asarray(valid).sum()
    np.testing.assert_allclose(np.asarray(pal_kp2)[both], np.asarray(ref_kp2)[both], atol=5e-3)


@pytest.mark.parametrize("n", [37, 8])
def test_kernel_pads_lanes_to_block(rng, n):
    """N that is not a multiple of the block (or smaller than it) gives the
    same lanes as the same keypoints inside a full block."""
    cfg, anchors, kp1, pyr2, valid = _problem(rng, n=48)
    guess = kp1 + jnp.asarray([0.7, -0.4])
    full_kp2, full_ok = kernel(anchors, kp1, pyr2, guess, valid, block=16)
    part_kp2, part_ok = kernel(anchors[:n], kp1[:n], pyr2, guess[:n], valid[:n], block=16)
    assert part_kp2.shape == (n, 2) and part_ok.shape == (n,)
    np.testing.assert_array_equal(np.asarray(part_ok), np.asarray(full_ok)[:n])
    np.testing.assert_array_equal(np.asarray(part_kp2), np.asarray(full_kp2)[:n])


def test_invalid_lanes_pass_through(rng):
    """Invalid lanes come back at their initial guess, never successful."""
    cfg, anchors, kp1, pyr2, valid = _problem(rng, n=64)
    guess = kp1 + jnp.asarray([2.0, 1.0])
    kp2, ok = kernel(anchors, kp1, pyr2, guess, valid)
    inv = ~np.asarray(valid)
    assert inv.any()
    assert not np.asarray(ok)[inv].any()
    np.testing.assert_array_equal(np.asarray(kp2)[inv], np.asarray(guess)[inv])


def test_border_clamp_against_numpy_reference(rng):
    """Keypoints within a few pixels of (and beyond) the border: the
    single-level kernel follows the NumPy port of the reference tracker, whose
    clamped GetPixelValue the kernel's gathered taps must reproduce."""
    H, W = 60, 90
    base = jnp.asarray(rng.uniform(0, 1, (8, 12)), jnp.float32)
    img1 = jax.image.resize(base, (H, W), "bilinear") * 255.0
    img2 = jnp.roll(img1, (1, 1), (0, 1))
    n = 32
    kp1 = np.stack([
        np.concatenate([rng.uniform(-2, 4, n // 2), rng.uniform(W - 5, W + 1, n // 2)]),
        rng.uniform(-2, H + 1, n),
    ], -1).astype(np.float32)
    cfg = klt_ops.KLTConfig(levels=1)
    anchors = klt_ops.extract_anchors((img1,), jnp.asarray(kp1), cfg)
    valid = jnp.ones((n,), bool)
    got, got_ok = kernel(anchors, jnp.asarray(kp1), (img2,), jnp.asarray(kp1), valid)
    want, want_ok = reference_klt.klt_1layer(
        np.asarray(img1, np.float64), np.asarray(img2, np.float64), kp1, kp1
    )
    got, got_ok = np.asarray(got), np.asarray(got_ok)
    assert (got_ok == want_ok).mean() > 0.9
    both = got_ok & want_ok
    assert both.sum() >= n // 4
    np.testing.assert_allclose(got[both], want[both], atol=0.05)


def test_kernel_lowers_for_cuda(rng):
    """The kernel names the Triton route and lowers for CUDA, with valid
    Triton IR, from a CPU-only process."""
    cfg, anchors, kp1, pyr2, valid = _problem(rng, n=32)
    for inverse in (False, True):
        text, n_modules = lower_for_cuda(
            lambda a, u, p, g, v: klt_pallas.klt_pyramid_anchored_pallas(a, u, p, g, v, inverse=inverse),
            anchors, kp1, pyr2, kp1, valid,
        )
        assert "__gpu$xla.gpu.triton" in text and n_modules == 1


def test_kernel_choice_by_platform(rng):
    """klt_pyramid_anchored takes the kernel when lowered for CUDA and the
    XLA loop elsewhere; on CPU it equals the XLA loop plus the ZNCC gate."""
    cfg, anchors, kp1, pyr2, valid = _problem(rng, n=32)
    fn = jax.jit(lambda a, u, p, g, v: klt_ops.klt_pyramid_anchored(a, u, p, g, v, cfg))
    traced = fn.trace(anchors, kp1, pyr2, kp1, valid)
    assert "__gpu$xla.gpu.triton" in traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "triton" not in traced.lower(lowering_platforms=("cpu",)).as_text()
    kp2, ok = fn(anchors, kp1, pyr2, kp1, valid)
    ref_kp2, ref_ok = _xla(cfg, anchors, kp1, pyr2, kp1, valid)
    np.testing.assert_array_equal(np.asarray(kp2), np.asarray(ref_kp2))
    assert not (np.asarray(ok) & ~np.asarray(ref_ok)).any()
