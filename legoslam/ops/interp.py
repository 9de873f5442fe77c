"""Bilinear patch sampling, batched over keypoints.

The reference's `GetPixelValue` (include/legoslam/algorithm.h:40-57) does one
clamped bilinear lookup per (keypoint, pixel, GN-iteration) on the host.
Here an axis-aligned (P x P) unit-spacing patch is sampled around every
keypoint at once.  Because the patch grid is axis-aligned, the
interpolation is separable: each patch is ``Ry @ I @ Rx^T`` where Ry/Rx are
per-keypoint 2-tap interpolation matrices.  Materializing those as dense
one-hot rows turns the gather into two matmuls ("gather via one-hot
matmul"), with XLA fusing the weight construction; they must run at full
f32 precision (utils/jax_setup.py full_f32_matmuls).

A `dynamic_slice`-based variant is provided for comparison/benchmarking; the
public entry point picks the matmul path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _tap_weights(coord: jnp.ndarray, size: int, patch: int):
    """First-tap indices and fractional weights for a patch axis.

    Args:
      coord: (N,) patch-start coordinates (can be fractional / out of range).
      size: image extent along this axis.
      patch: number of samples along this axis.

    Returns (idx0 (N, patch) int32 clamped, frac (N,) in [0, 1]).

    Clamping mirrors GetPixelValue's boundary behavior (algorithm.h:42-45):
    samples beyond the border collapse onto the edge pixel.
    """
    offs = jnp.arange(patch, dtype=coord.dtype)
    pos = coord[:, None] + offs[None, :]          # (N, patch)
    pos = jnp.clip(pos, 0.0, size - 1.0)
    idx0 = jnp.floor(pos)
    frac = pos - idx0
    return idx0.astype(jnp.int32), frac


def _axis_matrix(coord: jnp.ndarray, size: int, patch: int) -> jnp.ndarray:
    """(N, patch, size) dense 2-tap interpolation rows along one axis."""
    idx0, frac = _tap_weights(coord, size, patch)
    idx1 = jnp.minimum(idx0 + 1, size - 1)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1, size), 2)
    w0 = (iota == idx0[..., None]).astype(coord.dtype) * (1.0 - frac)[..., None]
    w1 = (iota == idx1[..., None]).astype(coord.dtype) * frac[..., None]
    return w0 + w1


def sample_patches_matmul(img: jnp.ndarray, centers: jnp.ndarray, patch: int) -> jnp.ndarray:
    """Bilinear-sample (patch x patch) windows centered at `centers`.

    Args:
      img: (H, W) float image.
      centers: (N, 2) patch centers as (x, y) pixel coordinates.
      patch: odd patch side length (static).

    Returns (N, patch, patch) patches, rows indexed by y, columns by x.
    """
    H, W = img.shape
    half = (patch - 1) / 2.0
    Ry = _axis_matrix(centers[:, 1] - half, H, patch)  # (N, P, H)
    Rx = _axis_matrix(centers[:, 0] - half, W, patch)  # (N, P, W)
    n = centers.shape[0]
    # (N*P, H) @ (H, W): one large matmul, then small batched contractions.
    rows = (Ry.reshape(n * patch, H) @ img).reshape(n, patch, W)
    return jnp.einsum("nyw,nxw->nyx", rows, Rx)


def sample_patches_gather(img: jnp.ndarray, centers: jnp.ndarray, patch: int) -> jnp.ndarray:
    """Same contract as `sample_patches_matmul` via vmapped dynamic_slice.

    Integer (patch+1)^2 windows are cut with `dynamic_slice` (start clamped to
    the image by XLA semantics) and interpolated with four shifted weights.
    Out-of-range behavior matches border clamping only approximately at the
    far edge; the matmul path is the reference implementation.
    """
    H, W = img.shape
    half = (patch - 1) / 2.0
    start = jnp.stack([centers[:, 1] - half, centers[:, 0] - half], axis=-1)
    start = jnp.clip(start, 0.0, jnp.asarray([H - patch - 1, W - patch - 1], img.dtype))
    i0 = jnp.floor(start)
    frac = start - i0

    def one(i0_row, f):
        win = jax.lax.dynamic_slice(img, (i0_row[0].astype(jnp.int32), i0_row[1].astype(jnp.int32)), (patch + 1, patch + 1))
        fy, fx = f[0], f[1]
        top = (1 - fx) * win[:patch, :patch] + fx * win[:patch, 1:]
        bot = (1 - fx) * win[1:, :patch] + fx * win[1:, 1:]
        return (1 - fy) * top + fy * bot

    return jax.vmap(one)(i0, frac)


sample_patches = sample_patches_matmul
