"""Scanline stereo matching for a rectified rig.

The reference finds right-image correspondences with the same general 2-D
pyramid KLT it uses for temporal tracking (frontend_g2o.cpp:495-535), seeded
at zero disparity for new features.  For large disparities that estimator
systematically under-shoots, which biases triangulated depths long — so this
module replaces it (config `stereo_matcher: scanline`; the reference-faithful
KLT path remains available) with a rectified-stereo pipeline built around a
per-keypoint *strip*:

1. one rectangular matmul-gather samples a (P x S) strip of the right image
   whose rows align with the keypoint's row and whose S columns span the
   whole disparity search range — every candidate window is then just a
   slice, so the dense cost volume costs no further image reads;
2. ZNCC over all integer-disparity windows (contrast/offset invariant; SSD is
   background-dominated on sparse texture), uniqueness-gated, with parabolic
   subpixel interpolation;
3. Gauss-Newton refinement of the continuous disparity *inside the strip*
   (2-tap column interpolation — no resampling of the image).

Everything is fixed-shape and jits once; the whole matcher is two
matmul-gathers plus elementwise work.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.ops import interp


class ScanlineConfig(NamedTuple):
    half_patch: int = 3
    refine_iterations: int = 6
    uniqueness: float = 0.85     # best/second-best (1-ZNCC) ratio gate (< passes)
    min_zncc: float = 0.75       # final acceptance score at the refined match
    # kept for config compatibility; the strip scan is always dense at level 0
    num_candidates: int = 0
    scan_level: int = 0
    levels: int = 4
    scale: float = 0.5


def _zncc(pl, pr, axes=(-2, -1)):
    """Zero-mean normalized cross-correlation over patch axes."""
    pl0 = pl - jnp.mean(pl, axis=axes, keepdims=True)
    pr0 = pr - jnp.mean(pr, axis=axes, keepdims=True)
    num = jnp.sum(pl0 * pr0, axis=axes)
    den = jnp.sqrt(jnp.sum(pl0 * pl0, axis=axes) * jnp.sum(pr0 * pr0, axis=axes) + 1e-6)
    return num / den


def sample_strip(img: jnp.ndarray, kp: jnp.ndarray, rows: int, cols: int, x_start_off: float) -> jnp.ndarray:
    """(N, rows, cols) strip: rows centered on kp_y, columns starting at
    kp_x + x_start_off, unit spacing — a rectangular matmul-gather."""
    H, W = img.shape
    half_r = (rows - 1) / 2.0
    Ry = interp._axis_matrix(kp[:, 1] - half_r, H, rows)   # (N, rows, H)
    Rx = interp._axis_matrix(kp[:, 0] + x_start_off, W, cols)  # (N, cols, W)
    n = kp.shape[0]
    r = (Ry.reshape(n * rows, H) @ img).reshape(n, rows, W)
    return jnp.einsum("nyw,nxw->nyx", r, Rx)


def match(
    pyr_l,
    pyr_r,
    kp: jnp.ndarray,
    valid: jnp.ndarray,
    d_min: float,
    d_max: float,
    cfg: ScanlineConfig = ScanlineConfig(),
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full scanline match.

    Args:
      pyr_l, pyr_r: image pyramids (only level 0 is used).
      kp: (N, 2) left-image keypoints.
      valid: (N,) lanes to match.
      d_min, d_max: static disparity search range (from the rig's depth
        gates: d = fx * baseline / z).

    Returns (uv_right (N, 2), ok (N,)).
    """
    img_l, img_r = pyr_l[0], pyr_r[0]
    P = 2 * cfg.half_patch + 1
    half = cfg.half_patch
    d_lo = int(math.floor(d_min)) - 1
    d_hi = int(math.ceil(d_max)) + 1
    D = d_hi - d_lo + 1              # integer disparity candidates
    S = D + P - 1 + 2                # strip width (+1 halo col each side)

    patch_l = interp.sample_patches(img_l, kp, P)          # (N, P, P)
    # Strip columns j hold x = kp_x + x0 + j with x0 = -(d_hi + half + 1):
    # the window whose *left* column sits at strip col (1 + j) is centered at
    # kp_x - (d_hi - j), i.e. integer disparity d = d_hi - j.
    x0 = -(d_hi + half + 1)
    strip = sample_strip(img_r, kp, P, S, float(x0))       # (N, P, S)

    # Dense integer ZNCC cost over all D window positions WITHOUT the
    # (N, P, D, P) stacked-window tensor (a D-way stack of slices is pure
    # copies that dominated this op when measured).  With the left
    # patch zero-meaned, zncc numerator = sum_k sum_y pl0[.,y,k] *
    # strip[.,y,1+j+k]: P shifted multiply-adds.  Window sums / sum-squares
    # for the denominator come from prefix sums along the strip.
    pl_mean = jnp.mean(patch_l, axis=(1, 2), keepdims=True)
    pl0 = patch_l - pl_mean
    norm_l = jnp.sqrt(jnp.sum(pl0 * pl0, axis=(1, 2)))     # (N,)
    cross = sum(
        jnp.sum(pl0[:, :, k : k + 1] * strip[:, :, 1 + k : 1 + k + D], axis=1)
        for k in range(P)
    )                                                       # (N, D)
    col_sum = jnp.sum(strip, axis=1)                        # (N, S)
    col_sq = jnp.sum(strip * strip, axis=1)
    zero = jnp.zeros((kp.shape[0], 1), strip.dtype)
    cum = jnp.concatenate([zero, jnp.cumsum(col_sum, axis=1)], axis=1)
    cumq = jnp.concatenate([zero, jnp.cumsum(col_sq, axis=1)], axis=1)
    win_sum = cum[:, 1 + P : 1 + P + D] - cum[:, 1 : 1 + D]
    win_sq = cumq[:, 1 + P : 1 + P + D] - cumq[:, 1 : 1 + D]
    var_r = jnp.maximum(win_sq - win_sum * win_sum / (P * P), 0.0)
    den = norm_l[:, None] * jnp.sqrt(var_r) + 1e-6
    cost = 1.0 - cross / den                                # (N, D)

    best_j = jnp.argmin(cost, axis=1)
    c_best = jnp.min(cost, axis=1)
    # Uniqueness: second-best outside +-2 px of the winner.
    jj = jnp.arange(D)[None, :]
    near = jnp.abs(jj - best_j[:, None]) <= 2
    c_second = jnp.min(jnp.where(near, jnp.inf, cost), axis=1)
    ambiguous = c_best > cfg.uniqueness * c_second

    # Parabolic subpixel seed.
    jp = jnp.clip(best_j - 1, 0, D - 1)
    jn = jnp.clip(best_j + 1, 0, D - 1)
    cp = jnp.take_along_axis(cost, jp[:, None], 1)[:, 0]
    cn = jnp.take_along_axis(cost, jn[:, None], 1)[:, 0]
    denom = cp - 2.0 * c_best + cn
    off = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (cp - cn) / jnp.where(denom != 0, denom, 1.0), 0.0)
    off = jnp.clip(off, -1.0, 1.0)
    # Continuous window-start coordinate within the strip (disparity d sits at
    # strip coordinate u = 1 + d_hi - d).
    u0 = 1.0 + best_j.astype(kp.dtype) + off

    # Gauss-Newton on u inside the strip (the x-only restriction of the
    # reference's GN loop, algorithm.cpp:58-115; d(err)/du = -strip gradient).
    # One fractional (P+2)-column halo window per iteration, read with a
    # 2-tap one-hot einsum over the strip columns (small batched matmul
    # instead of a gather); value and central-difference gradient
    # both come from the halo.
    col2 = jnp.arange(P + 2, dtype=kp.dtype)[None, :]
    iota_s = jnp.arange(S, dtype=kp.dtype)[None, None, :]

    def sample_halo(u):
        pos = jnp.clip(u[:, None] + col2 - 1.0, 0.0, S - 2.0)  # (N, P+2) col starts
        i0 = jnp.floor(pos)
        f = (pos - i0)[:, None, :]                          # (N, 1, P+2)
        w0 = (iota_s == i0[:, :, None]).astype(kp.dtype)    # (N, P+2, S) one-hot
        v0 = jnp.einsum("nys,nks->nyk", strip, w0)
        v1 = jnp.einsum("nys,nks->nyk", strip, jnp.roll(w0, 1, axis=2))
        return (1.0 - f) * v0 + f * v1                      # (N, P, P+2)

    def sample_win(u):
        return sample_halo(u)[:, :, 1:-1]

    def body(_, st):
        u, last_cost, active = st
        halo = sample_halo(u)
        win = halo[:, :, 1:-1]
        gx = 0.5 * (halo[:, :, 2:] - halo[:, :, :-2])
        err = patch_l - win
        c = jnp.sum(err * err, axis=(1, 2))
        h = jnp.sum(gx * gx, axis=(1, 2))
        # err = patch_l - win(u); d(err)/du = -gx  =>  GN step +sum(err*gx)/h
        b = jnp.sum(err * gx, axis=(1, 2))
        upd = jnp.where(h > 1e-9, b / jnp.where(h > 0, h, 1.0), 0.0)
        diverged = last_cost < c
        apply = active & ~diverged & jnp.isfinite(upd)
        u = jnp.where(apply, u + upd, u)
        last_cost = jnp.where(apply, c, last_cost)
        active = apply & (jnp.abs(upd) >= 1e-2)
        return u, last_cost, active

    inf = jnp.full(kp.shape[:1], jnp.inf, kp.dtype)
    ok0 = valid & ~ambiguous

    def loop_cond(st):
        i, carry = st
        return (i < cfg.refine_iterations) & jnp.any(carry[2])

    _, (u, _, _) = jax.lax.while_loop(
        loop_cond,
        lambda st: (st[0] + 1, body(st[0], st[1])),
        (jnp.asarray(0, jnp.int32), (u0, inf, ok0)),
    )

    d = (1.0 + d_hi) - u
    score = 1.0 - _zncc(patch_l, sample_win(u))
    x_r = kp[:, 0] - d
    W = img_r.shape[1]
    in_range = (d > d_min * 0.5) & (d < d_max * 1.5) & (x_r >= 0) & (x_r < W)
    ok = ok0 & (score < 1.0 - cfg.min_zncc) & in_range
    return jnp.stack([x_r, kp[:, 1]], axis=-1), ok
