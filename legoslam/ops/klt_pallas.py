"""Pallas kernel (Triton route): anchored pyramid KLT, every level in one launch.

The XLA formulation (ops/klt.py klt_pyramid_anchored) runs each pyramid
level as a data-dependent `while_loop` of up to 10 Gauss-Newton iterations,
each about 25 small ops.  On the GPU every iteration costs several kernel
launches and a device-to-host read of the loop predicate, while the math is a
few hundred FLOPs per keypoint.  Here one program tracks a block of keypoints
through all levels, coarse to fine, with each level's whole GN loop in
registers:

- A keypoint's 7x7 core patch is one row of `lanes` (49 used, padded to a
  power of two and masked).  Each lane takes the five clamped bilinear
  samples its value and central-difference gradients need, as gathered loads
  from the level image in device memory.  The whole pyramid (about 0.6 MB at
  188x620) stays resident in L2; there is no one-hot product and no matmul.
- Each block leaves a level's loop as soon as all its lanes stop.

Semantics match ops/klt.py klt_level_anchored exactly: divergence break on a
cost increase, convergence at |update| < eps, NaN/singular-Hessian failure,
the border clamp of ops/interp.py, and failed lanes restarting from the
initial guess at the next finer level.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


# A block of 4 keypoints x 64 lanes on 4 warps: the fastest of blocks 1-32 x
# 1-4 warps on an H100 within run-to-run spread, and 128 blocks for 512 lanes
# keep most SMs busy (PERF.md).
_BLOCK, _NUM_WARPS = 4, 4


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _sample(img_ref, sx, sy):
    """Clamped bilinear lookup at (sx, sy), with the clamp, tap and summation
    order of ops/interp.py sample_patches_matmul (rows over y, then x)."""
    H, W = img_ref.shape
    px = jnp.clip(sx, 0.0, W - 1.0)
    py = jnp.clip(sy, 0.0, H - 1.0)
    fx0 = jnp.floor(px)
    fy0 = jnp.floor(py)
    ax = px - fx0
    ay = py - fy0
    x0 = fx0.astype(jnp.int32)
    y0 = fy0.astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, W - 1)
    y1 = jnp.minimum(y0 + 1, H - 1)
    r0 = (1.0 - ay) * img_ref[y0, x0] + ay * img_ref[y1, x0]
    r1 = (1.0 - ay) * img_ref[y0, x1] + ay * img_ref[y1, x1]
    return (1.0 - ax) * r0 + ax * r1


def _klt_kernel(*refs, levels: int, patch: int, iterations: int, eps: float,
                inverse: bool, scale: float):
    imgs = refs[:levels]                      # coarsest first
    p1_refs = refs[levels:2 * levels]
    k = 2 * levels
    if inverse:
        gx_refs = refs[k:k + levels]
        gy_refs = refs[k + levels:k + 2 * levels]
        k += 2 * levels
    ax_ref, ay_ref, guess_x_ref, guess_y_ref, valid_ref, out_x, out_y, out_ok = refs[k:]

    B, lanes = p1_refs[0].shape
    half = float(patch + 1) / 2.0             # halo (patch + 2) half-width
    lane = jax.lax.broadcasted_iota(jnp.int32, (B, lanes), 1)
    used = lane < patch * patch
    mask = used.astype(jnp.float32)
    # Core pixel (oy, ox) is halo pixel (oy + 1, ox + 1).
    hx = (lane % patch + 1).astype(jnp.float32)
    hy = (lane // patch + 1).astype(jnp.float32)

    valid = valid_ref[...] != 0
    s_top = scale ** (levels - 1)
    k1x = ax_ref[...] * s_top
    k1y = ay_ref[...] * s_top
    gux = guess_x_ref[...] * s_top
    guy = guess_y_ref[...] * s_top
    k2x, k2y = gux, guy
    ok = valid

    for li in range(levels):
        img = imgs[li]
        H, W = img.shape
        p1 = p1_refs[li][...]
        if inverse:
            jx_fix = -gx_refs[li][...] * mask
            jy_fix = -gy_refs[li][...] * mask
            H00 = jnp.sum(jx_fix * jx_fix, axis=1)
            H01 = jnp.sum(jx_fix * jy_fix, axis=1)
            H11 = jnp.sum(jy_fix * jy_fix, axis=1)

        def cond(st):
            i, _, _, _, _, active = st
            return (i < iterations) & (jnp.sum(active.astype(jnp.int32)) > 0)

        def body(st, img=img, p1=p1, k1x=k1x, k1y=k1y):
            i, dx, dy, last_cost, succ, active = st
            bx0 = ((k1x + dx) - half)[:, None]
            by0 = ((k1y + dy) - half)[:, None]
            sx = bx0 + hx
            sy = by0 + hy
            p2 = _sample(img, sx, sy)
            err = (p1 - p2) * mask
            cost = jnp.sum(err * err, axis=1)
            if inverse:
                jx, jy = jx_fix, jy_fix
                h00, h01, h11 = H00, H01, H11
            else:
                gx2 = 0.5 * (_sample(img, bx0 + (hx + 1.0), sy) - _sample(img, bx0 + (hx - 1.0), sy))
                gy2 = 0.5 * (_sample(img, sx, by0 + (hy + 1.0)) - _sample(img, sx, by0 + (hy - 1.0)))
                jx = -gx2 * mask
                jy = -gy2 * mask
                h00 = jnp.sum(jx * jx, axis=1)
                h01 = jnp.sum(jx * jy, axis=1)
                h11 = jnp.sum(jy * jy, axis=1)
            bx = jnp.sum(-err * jx, axis=1)
            by = jnp.sum(-err * jy, axis=1)
            det = h00 * h11 - h01 * h01
            nonsing = jnp.abs(det) > 1e-12
            inv_det = jnp.where(nonsing, 1.0 / jnp.where(det != 0, det, 1.0), 0.0)
            ux = (h11 * bx - h01 * by) * inv_det
            uy = (h00 * by - h01 * bx) * inv_det
            bad = ~(jnp.isfinite(ux) & jnp.isfinite(uy)) | ~nonsing
            diverged = last_cost < cost
            apply = active & ~bad & ~diverged
            dx = jnp.where(apply, dx + ux, dx)
            dy = jnp.where(apply, dy + uy, dy)
            last_cost = jnp.where(apply, cost, last_cost)
            succ = jnp.where(active & bad, False, jnp.where(apply, True, succ))
            active = apply & ~((ux * ux + uy * uy) < eps * eps)
            return i + 1, dx, dy, last_cost, succ, active

        inf = jnp.full(k1x.shape, jnp.inf, jnp.float32)
        _, dx, dy, _, succ, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), k2x - k1x, k2y - k1y, inf, valid, valid)
        )
        k2x = k1x + dx
        k2y = k1y + dy
        in_img = (k2x >= 0) & (k2x < W) & (k2y >= 0) & (k2y < H)
        ok = succ & in_img & valid
        if li < levels - 1:
            k1x = k1x / scale
            k1y = k1y / scale
            gux = gux / scale
            guy = guy / scale
            k2x = jnp.where(ok, k2x / scale, gux)
            k2y = jnp.where(ok, k2y / scale, guy)

    out_x[...] = k2x
    out_y[...] = k2y
    out_ok[...] = ok.astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("iterations", "eps", "inverse", "scale", "block", "interpret"),
)
def klt_pyramid_anchored_pallas(
    anchors: jnp.ndarray,
    anchor_uv: jnp.ndarray,
    pyr2: Sequence[jnp.ndarray],
    kp2_init: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    iterations: int = 10,
    eps: float = 1e-2,
    inverse: bool = False,
    scale: float = 0.5,
    block: int = _BLOCK,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Coarse-to-fine anchored tracking, before the appearance gate.

    Same contract as the level loop of ops/klt.py klt_pyramid_anchored:
    anchors (N, levels, P+2, P+2) halo templates (finest first), anchor_uv
    (N, 2) flow origins at level 0, pyr2 the current pyramid (finest first,
    `levels` of them used), kp2_init (N, 2) initial guesses, valid (N,).
    Returns (kp2 (N, 2), success (N,)) at level 0.
    """
    N, levels, halo, _ = anchors.shape
    patch = halo - 2
    lanes = _next_pow2(patch * patch)
    f32 = jnp.float32

    def flat(x):  # (N, levels, P, P) -> per level (N, lanes), coarsest first
        x = x.reshape(N, levels, patch * patch).astype(f32)
        x = jnp.pad(x, ((0, 0), (0, 0), (0, lanes - patch * patch)))
        return [x[:, li] for li in range(levels - 1, -1, -1)]

    core = anchors[:, :, 1:-1, 1:-1]
    inputs = [p.astype(f32) for p in pyr2[:levels][::-1]] + flat(core)
    if inverse:
        gx = 0.5 * (anchors[:, :, 1:-1, 2:] - anchors[:, :, 1:-1, :-2])
        gy = 0.5 * (anchors[:, :, 2:, 1:-1] - anchors[:, :, :-2, 1:-1])
        inputs += flat(gx) + flat(gy)
    vecs = [anchor_uv[:, 0], anchor_uv[:, 1], kp2_init[:, 0], kp2_init[:, 1]]
    vecs = [v.astype(f32) for v in vecs] + [valid.astype(jnp.int32)]

    B = min(block, _next_pow2(N))
    pad = (-N) % B
    Np = N + pad
    n_img = levels
    row_inputs = [jnp.pad(x, ((0, pad), (0, 0))) for x in inputs[n_img:]]
    vecs = [jnp.pad(v, (0, pad)) for v in vecs]

    img_specs = [pl.BlockSpec(im.shape, lambda i: (0, 0)) for im in inputs[:n_img]]
    row_spec = pl.BlockSpec((B, lanes), lambda i: (i, 0))
    vec_spec = pl.BlockSpec((B,), lambda i: (i,))
    kernel = functools.partial(
        _klt_kernel, levels=levels, patch=patch, iterations=iterations, eps=eps,
        inverse=inverse, scale=scale,
    )
    kx, ky, ok = pl.pallas_call(
        kernel,
        grid=(Np // B,),
        in_specs=img_specs + [row_spec] * len(row_inputs) + [vec_spec] * len(vecs),
        out_specs=[vec_spec] * 3,
        out_shape=[
            jax.ShapeDtypeStruct((Np,), f32),
            jax.ShapeDtypeStruct((Np,), f32),
            jax.ShapeDtypeStruct((Np,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="klt_pyramid_anchored",
    )(*inputs[:n_img], *row_inputs, *vecs)
    kp2 = jnp.stack([kx[:N], ky[:N]], axis=-1).astype(kp2_init.dtype)
    return kp2, ok[:N] != 0
