"""Pyramid KLT optical flow, batched over keypoints.

Re-designs the reference's hand-made Gauss-Newton LK tracker
(src/algorithm.cpp:37-125 single level, :128-206 4-level pyramid): per
keypoint, 10 GN iterations over a 7x7 patch with central-difference image
gradients, a 2x2 normal-equation solve, divergence break on cost increase,
convergence break at |update| < 1e-2, and the inverse-compositional variant
that freezes J (and H) from the reference image at iteration 0.

Where the reference fans keypoints out over a thread pool
(`cv::parallel_for_`, algorithm.h:105-120), here every keypoint is a lane of
a batched device computation: patches for all keypoints are bilinearly
sampled at once (ops/interp.py), the GN math is elementwise, and the
10-iteration loop with per-lane active masks replaces per-keypoint early
exits (the masked equivalent of `break`).  On the GPU the anchored tracker
runs as one Pallas kernel instead (ops/klt_pallas.py).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.ops import interp, klt_pallas, pyramid


class KLTConfig(NamedTuple):
    half_patch: int = 3        # algorithm.cpp:40 (7x7 window)
    iterations: int = 10       # algorithm.cpp:42
    eps: float = 1e-2          # algorithm.cpp:113 convergence threshold
    levels: int = 4            # algorithm.cpp:135
    scale: float = 0.5         # algorithm.cpp:136
    inverse: bool = False      # forward mode default (frontend_g2o.cpp:473)


def _gn_loop(iterations: int, body, init):
    """Run the per-lane GN body until every lane goes inactive (or the
    iteration cap).  The reference breaks per keypoint (algorithm.cpp:102-115);
    batched lanes exit together once the last one converges — on real frames
    that is typically 3-5 of the 10 allowed iterations, and the early exit
    skips the rest of this deeply sequential loop."""

    def cond(st):
        i, carry = st
        return (i < iterations) & jnp.any(carry[3])

    def wrapped(st):
        i, carry = st
        return i + 1, body(i, carry)

    _, out = jax.lax.while_loop(cond, wrapped, (jnp.asarray(0, jnp.int32), init))
    return out


def _grad_patches(big: jnp.ndarray):
    """Split a (N, P+2, P+2) halo patch into value/grad-x/grad-y (N, P, P).

    Central differences at unit spacing (algorithm.cpp:69-79, half step 1).
    """
    val = big[:, 1:-1, 1:-1]
    gx = 0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])
    gy = 0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])
    return val, gx, gy


def klt_level(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    kp1: jnp.ndarray,
    kp2: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: KLTConfig = KLTConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-level GN flow (algorithm.cpp:37-125), batched.

    Args:
      img1, img2: (H, W) float32 images (same shape).
      kp1: (N, 2) reference keypoints (x, y).
      kp2: (N, 2) initial guesses in img2 (the has_initial path).
      valid: (N,) lanes to track (invalid lanes pass through unchanged).

    Returns (kp2_out (N, 2), success (N,)).
    """
    patch = 2 * cfg.half_patch + 1
    halo = patch + 2
    H, W = img2.shape
    dtype = img1.dtype

    d0 = kp2 - kp1

    if cfg.inverse:
        big1 = interp.sample_patches(img1, kp1, halo)
        p1, gx1, gy1 = _grad_patches(big1)
        # J = -grad(img1), H frozen (algorithm.cpp:74-87).
        Jx_fix, Jy_fix = -gx1, -gy1
        H00 = jnp.sum(Jx_fix * Jx_fix, axis=(1, 2))
        H01 = jnp.sum(Jx_fix * Jy_fix, axis=(1, 2))
        H11 = jnp.sum(Jy_fix * Jy_fix, axis=(1, 2))
    else:
        p1 = interp.sample_patches(img1, kp1, patch)

    def body(_, st):
        d, last_cost, succ, active = st
        big2 = interp.sample_patches(img2, kp1 + d, halo)
        p2, gx2, gy2 = _grad_patches(big2)
        err = p1 - p2
        cost = jnp.sum(err * err, axis=(1, 2))

        if cfg.inverse:
            Jx, Jy = Jx_fix, Jy_fix
            h00, h01, h11 = H00, H01, H11
        else:
            Jx, Jy = -gx2, -gy2
            h00 = jnp.sum(Jx * Jx, axis=(1, 2))
            h01 = jnp.sum(Jx * Jy, axis=(1, 2))
            h11 = jnp.sum(Jy * Jy, axis=(1, 2))

        bx = jnp.sum(-err * Jx, axis=(1, 2))
        by = jnp.sum(-err * Jy, axis=(1, 2))
        det = h00 * h11 - h01 * h01
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
        ux = (h11 * bx - h01 * by) * inv_det
        uy = (h00 * by - h01 * bx) * inv_det
        upd = jnp.stack([ux, uy], axis=-1)

        bad = ~jnp.all(jnp.isfinite(upd), axis=-1) | (jnp.abs(det) <= 1e-12)
        diverged = last_cost < cost  # only meaningful after iter 0; last_cost starts at +inf
        apply = active & ~bad & ~diverged
        d = jnp.where(apply[:, None], d + upd, d)
        last_cost = jnp.where(apply, cost, last_cost)
        # NaN/singular marks failure (algorithm.cpp:94-100); divergence and
        # convergence just stop iterating with success kept.
        succ = jnp.where(active & bad, False, jnp.where(apply, True, succ))
        converged = jnp.sum(upd * upd, axis=-1) < cfg.eps * cfg.eps
        active = apply & ~converged
        return d, last_cost, succ, active

    inf = jnp.full(kp1.shape[:1], jnp.inf, dtype)
    d, _, succ, _ = _gn_loop(cfg.iterations, body, (d0, inf, valid, valid))
    kp2_out = kp1 + d
    in_img = (
        (kp2_out[:, 0] >= 0) & (kp2_out[:, 0] < W) & (kp2_out[:, 1] >= 0) & (kp2_out[:, 1] < H)
    )  # IsPtInImg (algorithm.h:60-66)
    return kp2_out, succ & in_img & valid


def klt_pyramid(
    pyr1: List[jnp.ndarray],
    pyr2: List[jnp.ndarray],
    kp1: jnp.ndarray,
    kp2_init: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: KLTConfig = KLTConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coarse-to-fine 4-level tracking (algorithm.cpp:128-206).

    Args:
      pyr1, pyr2: image pyramids (level 0 finest), from `pyramid.build_pyramid`.
      kp1: (N, 2) keypoints in pyr1 level 0.
      kp2_init: (N, 2) initial guesses in pyr2 level 0.
      valid: (N,) lanes to track.

    Returns (kp2 (N, 2), success (N,)).
    """
    levels = cfg.levels
    scale_top = cfg.scale ** (levels - 1)
    kp1_pyr = kp1 * scale_top
    kp2_pyr = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        kp2_pyr, success = klt_level(pyr1[level], pyr2[level], kp1_pyr, kp2_pyr, valid, cfg)
        if level > 0:
            # Upscale; failed lanes restart from kp1 at the next level
            # (algorithm.cpp:192-201).
            kp1_pyr = kp1_pyr / cfg.scale
            kp2_pyr = jnp.where(success[:, None], kp2_pyr / cfg.scale, kp1_pyr)
    return kp2_pyr, success


def track(
    img1: jnp.ndarray,
    img2: jnp.ndarray,
    kp1: jnp.ndarray,
    kp2_init: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: KLTConfig = KLTConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Convenience: build pyramids and track (LKOpticalFlow4Layer)."""
    pyr1 = pyramid.build_pyramid(img1, cfg.levels)
    pyr2 = pyramid.build_pyramid(img2, cfg.levels)
    return klt_pyramid(pyr1, pyr2, kp1, kp2_init, valid, cfg)


# ---------------------------------------------------------------------------
# Anchored tracking: match fixed keyframe templates instead of the previous
# frame.  Frame-to-frame tracking (the reference's scheme,
# frontend_g2o.cpp:453-492) re-templates every frame, so feature positions
# random-walk ~0.05 px/frame and the whole tracked cloud drifts off its
# landmarks between keyframes; anchoring the template at the keyframe where
# the feature was (re)detected makes per-frame tracking drift-free.
# ---------------------------------------------------------------------------

def extract_anchors(pyr, kp: jnp.ndarray, cfg: KLTConfig = KLTConfig()) -> jnp.ndarray:
    """Sample per-level halo patches around kp: (N, levels, P+2, P+2)."""
    halo = 2 * cfg.half_patch + 3
    out = []
    for level in range(cfg.levels):
        s = cfg.scale**level
        out.append(interp.sample_patches(pyr[level], kp * s, halo))
    return jnp.stack(out, axis=1)


def klt_level_anchored(
    anchor: jnp.ndarray,
    img2: jnp.ndarray,
    kp1: jnp.ndarray,
    kp2: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: KLTConfig = KLTConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Single-level GN flow against fixed template patches.

    `anchor` is (N, P+2, P+2) halo patches (one pyramid level of
    `extract_anchors`); `kp1` only anchors the flow origin (kp2 = kp1 + d).
    """
    patch = 2 * cfg.half_patch + 1
    halo = patch + 2
    H, W = img2.shape
    d0 = kp2 - kp1

    p1, gx1, gy1 = _grad_patches(anchor)
    if cfg.inverse:
        Jx_fix, Jy_fix = -gx1, -gy1
        H00 = jnp.sum(Jx_fix * Jx_fix, axis=(1, 2))
        H01 = jnp.sum(Jx_fix * Jy_fix, axis=(1, 2))
        H11 = jnp.sum(Jy_fix * Jy_fix, axis=(1, 2))

    def body(_, st):
        d, last_cost, succ, active = st
        big2 = interp.sample_patches(img2, kp1 + d, halo)
        p2, gx2, gy2 = _grad_patches(big2)
        err = p1 - p2
        cost = jnp.sum(err * err, axis=(1, 2))
        if cfg.inverse:
            Jx, Jy = Jx_fix, Jy_fix
            h00, h01, h11 = H00, H01, H11
        else:
            Jx, Jy = -gx2, -gy2
            h00 = jnp.sum(Jx * Jx, axis=(1, 2))
            h01 = jnp.sum(Jx * Jy, axis=(1, 2))
            h11 = jnp.sum(Jy * Jy, axis=(1, 2))
        bx = jnp.sum(-err * Jx, axis=(1, 2))
        by = jnp.sum(-err * Jy, axis=(1, 2))
        det = h00 * h11 - h01 * h01
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
        upd = jnp.stack([(h11 * bx - h01 * by) * inv_det, (h00 * by - h01 * bx) * inv_det], axis=-1)
        bad = ~jnp.all(jnp.isfinite(upd), axis=-1) | (jnp.abs(det) <= 1e-12)
        diverged = last_cost < cost
        apply = active & ~bad & ~diverged
        d = jnp.where(apply[:, None], d + upd, d)
        last_cost = jnp.where(apply, cost, last_cost)
        succ = jnp.where(active & bad, False, jnp.where(apply, True, succ))
        converged = jnp.sum(upd * upd, axis=-1) < cfg.eps * cfg.eps
        active = apply & ~converged
        return d, last_cost, succ, active

    inf = jnp.full(kp1.shape[:1], jnp.inf, kp1.dtype)
    d, _, succ, _ = _gn_loop(cfg.iterations, body, (d0, inf, valid, valid))
    kp2_out = kp1 + d
    in_img = (
        (kp2_out[:, 0] >= 0) & (kp2_out[:, 0] < W) & (kp2_out[:, 1] >= 0) & (kp2_out[:, 1] < H)
    )
    return kp2_out, succ & in_img & valid


def klt_pyramid_anchored(
    anchors: jnp.ndarray,
    anchor_uv: jnp.ndarray,
    pyr2,
    kp2_init: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: KLTConfig = KLTConfig(),
    min_zncc: float = 0.5,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coarse-to-fine tracking of anchored templates.

    Args:
      anchors: (N, levels, P+2, P+2) from `extract_anchors`.
      anchor_uv: (N, 2) template positions in the anchor image (flow origin).
      kp2_init: (N, 2) initial guesses in the current image (e.g. landmark
        projections under the motion prior).
      min_zncc: final appearance gate between template core and the matched
        patch (replaces forward-backward checks: the anchor image itself is
        not kept, only its patches).
    """
    levels = cfg.levels
    anchors = anchors[:, :levels]
    pyr2 = tuple(pyr2[:levels])

    def kernel(anchors, anchor_uv, pyr2, kp2_init, valid):
        return klt_pallas.klt_pyramid_anchored_pallas(
            anchors, anchor_uv, pyr2, kp2_init, valid,
            iterations=cfg.iterations, eps=cfg.eps, inverse=cfg.inverse, scale=cfg.scale,
        )

    def xla(anchors, anchor_uv, pyr2, kp2_init, valid):
        return _pyramid_anchored_xla(anchors, anchor_uv, pyr2, kp2_init, valid, cfg)

    kp2_pyr, success = jax.lax.platform_dependent(
        anchors, anchor_uv, pyr2, kp2_init, valid, cuda=kernel, default=xla
    )
    if min_zncc > 0:
        patch = 2 * cfg.half_patch + 1
        core = anchors[:, 0, 1:-1, 1:-1]
        cur = interp.sample_patches(pyr2[0], kp2_pyr, patch)
        c0 = core - jnp.mean(core, axis=(1, 2), keepdims=True)
        c1 = cur - jnp.mean(cur, axis=(1, 2), keepdims=True)
        num = jnp.sum(c0 * c1, axis=(1, 2))
        den = jnp.sqrt(jnp.sum(c0 * c0, axis=(1, 2)) * jnp.sum(c1 * c1, axis=(1, 2)) + 1e-6)
        success = success & (num / den > min_zncc)
    return kp2_pyr, success


def _pyramid_anchored_xla(anchors, anchor_uv, pyr2, kp2_init, valid, cfg: KLTConfig):
    """The level loop of `klt_pyramid_anchored` in plain XLA ops (the
    reference the Pallas kernel is tested against)."""
    levels = cfg.levels
    scale_top = cfg.scale ** (levels - 1)
    kp1_pyr = anchor_uv * scale_top
    kp2_pyr = kp2_init * scale_top
    guess_pyr = kp2_init * scale_top
    success = valid
    for level in range(levels - 1, -1, -1):
        kp2_pyr, success = klt_level_anchored(
            anchors[:, level], pyr2[level], kp1_pyr, kp2_pyr, valid, cfg
        )
        if level > 0:
            kp1_pyr = kp1_pyr / cfg.scale
            guess_pyr = guess_pyr / cfg.scale
            # Failed lanes restart from the initial guess at the next level.
            kp2_pyr = jnp.where(success[:, None], kp2_pyr / cfg.scale, guess_pyr)
    return kp2_pyr, success
