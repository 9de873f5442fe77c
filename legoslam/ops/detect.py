"""Shi-Tomasi (GFTT) corner detection as fixed-shape device ops.

Replaces the reference's `cv::GFTTDetector` (created frontend_g2o.cpp:16 with
max=num_features, qualityLevel=0.01, minDistance=20) and its masked
re-detection that blanks +-10 px boxes around existing features
(frontend_g2o.cpp:279-297).  The pipeline is pure convs + elementwise math:

  Sobel gradients -> 3x3 box-summed structure tensor -> min-eigenvalue
  response -> quality threshold -> max-pool NMS (the batched equivalent of
  OpenCV's greedy min-distance pass) -> top-k.

Fixed output capacity: always returns `max_corners` slots with a validity
mask, so detection jits once regardless of how many corners exist.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class GFTTConfig(NamedTuple):
    max_corners: int = 150       # num_features (frontend_g2o.cpp:16)
    quality_level: float = 0.01
    min_distance: int = 20
    block_size: int = 3          # OpenCV GFTT default
    border: int = 4              # keep KLT halo patches inside the image


def _sobel(img: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """3x3 Sobel gradients with replicate padding, via separable passes."""
    p = jnp.pad(img, 1, mode="edge")
    # smooth [1 2 1] along one axis, diff [-1 0 1] along the other
    sx = p[:, 2:] - p[:, :-2]
    ix = sx[:-2, :] + 2.0 * sx[1:-1, :] + sx[2:, :]
    sy = p[2:, :] - p[:-2, :]
    iy = sy[:, :-2] + 2.0 * sy[:, 1:-1] + sy[:, 2:]
    return ix, iy


def _box_sum(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """k x k box sum with zero padding (same shape)."""
    r = k // 2
    p = jnp.pad(x, r)
    c = jnp.cumsum(jnp.cumsum(p, axis=0), axis=1)
    c = jnp.pad(c, ((1, 0), (1, 0)))
    H, W = x.shape
    return (
        c[k : k + H, k : k + W]
        - c[0:H, k : k + W]
        - c[k : k + H, 0:W]
        + c[0:H, 0:W]
    )


def _maxpool(x: jnp.ndarray, k: int) -> jnp.ndarray:
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (k, k), (1, 1), "SAME")


def min_eig_response(img: jnp.ndarray, block_size: int = 3) -> jnp.ndarray:
    """Min eigenvalue of the structure tensor (cv::cornerMinEigenVal)."""
    ix, iy = _sobel(img)
    sxx = _box_sum(ix * ix, block_size)
    syy = _box_sum(iy * iy, block_size)
    sxy = _box_sum(ix * iy, block_size)
    tr = 0.5 * (sxx + syy)
    det_part = jnp.sqrt(jnp.maximum(0.25 * (sxx - syy) ** 2 + sxy * sxy, 0.0))
    return tr - det_part


def occupancy_mask(
    shape: Tuple[int, int], positions: jnp.ndarray, valid: jnp.ndarray, half: int
) -> jnp.ndarray:
    """(H, W) bool mask, True inside +-half boxes around valid positions.

    The scatter+maxpool equivalent of the reference's cv::rectangle mask
    painting (frontend_g2o.cpp:280-284).
    """
    H, W = shape
    xi = jnp.clip(jnp.round(positions[:, 0]).astype(jnp.int32), 0, W - 1)
    yi = jnp.clip(jnp.round(positions[:, 1]).astype(jnp.int32), 0, H - 1)
    ind = jnp.zeros((H, W), jnp.float32).at[yi, xi].max(valid.astype(jnp.float32))
    return _maxpool(ind, 2 * half + 1) > 0.5


def detect(
    img: jnp.ndarray,
    cfg: GFTTConfig = GFTTConfig(),
    exclude_mask: jnp.ndarray | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Detect up to `cfg.max_corners` corners.

    Args:
      img: (H, W) float image.
      exclude_mask: optional (H, W) bool, True where detection is forbidden.

    Returns (positions (max_corners, 2) float (x, y), valid (max_corners,)).
    """
    H, W = img.shape
    resp = min_eig_response(img, cfg.block_size)

    b = cfg.border
    row = jnp.arange(H)[:, None]
    col = jnp.arange(W)[None, :]
    ok = (row >= b) & (row < H - b) & (col >= b) & (col < W - b)
    if exclude_mask is not None:
        ok = ok & ~exclude_mask
    resp = jnp.where(ok, resp, -jnp.inf)

    # Quality gate relative to the strongest corner (OpenCV semantics).
    thr = cfg.quality_level * jnp.max(resp)
    # NMS: local maxima within half the min-distance radius.  OpenCV's greedy
    # pass suppresses only around already-*selected* (stronger) corners, so a
    # strict local-max test over the full (2*min_distance+1) window would be
    # far more restrictive than the reference detector; the half-radius
    # window preserves its spatial spread while staying a single max-pool.
    nms = resp >= _maxpool(resp, cfg.min_distance + 1)
    resp = jnp.where(nms & (resp > thr) & jnp.isfinite(resp), resp, -jnp.inf)

    vals, idx = jax.lax.top_k(resp.reshape(-1), cfg.max_corners)
    ys = (idx // W).astype(img.dtype)
    xs = (idx % W).astype(img.dtype)
    return jnp.stack([xs, ys], axis=-1), jnp.isfinite(vals)
