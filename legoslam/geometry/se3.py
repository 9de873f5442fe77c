"""Batched SE(3) / SO(3) operations in pure JAX.

The reference stores poses as Sophus `SE3` objects and updates them by
left-multiplicative tangent increments ``T <- Exp(delta) * T``
(reference: include/legoslam/lego_types.h:61-91).  Here a pose is a plain
``(..., 4, 4)`` array (row-major homogeneous transform, camera-from-world
``T_cw`` throughout the pipeline) and the tangent is ``(..., 6)`` ordered
``[rho, phi]`` (translation part first), matching Sophus' convention so the
reference's analytic reprojection Jacobians carry over unchanged.

All functions broadcast over leading batch dimensions, preserve the input
dtype, and are safe under ``jit``/``vmap`` (small-angle branches use masked
`where`, not data-dependent control flow).
"""

from __future__ import annotations

import jax.numpy as jnp

# Below this rotation angle (radians) the Taylor expansions of the Rodrigues /
# left-Jacobian coefficient functions are used instead of the trig forms.  The
# threshold is sized for float32: the 4th-order Taylor error at 0.05 rad is
# ~1e-10 (below fp32 eps), while the trig forms are already stable there
# thanks to the half-angle formulations below.
_SMALL_ANGLE = 0.05


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of ``(..., 3)`` vectors -> ``(..., 3, 3)``."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    rows = [
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def _rot_coeffs(theta_sq: jnp.ndarray):
    """Rodrigues coefficients A = sin t / t, B = (1 - cos t)/t^2, C = (t - sin t)/t^3.

    Float32-stable: B uses the half-angle form 0.5 * (sin(t/2)/(t/2))^2,
    avoiding the catastrophic 1 - cos(t) cancellation, and C uses
    (1 - sinc t)/t^2 whose single subtraction is O(t^2)-sized — safe above
    the 0.05 rad threshold where t^2 >> fp32 eps.  Below it, 4th-order Taylor.
    """
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < _SMALL_ANGLE**2
    # Guard the denominators; the guarded lanes are overwritten by `where`.
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    half = 0.5 * safe
    sinc = jnp.sin(safe) / safe
    sinc_half = jnp.sin(half) / half
    t2, t4 = theta_sq, theta_sq * theta_sq
    a = jnp.where(small, 1.0 - t2 / 6.0 + t4 / 120.0, sinc)
    b = jnp.where(small, 0.5 - t2 / 24.0 + t4 / 720.0, 0.5 * sinc_half * sinc_half)
    c = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0, (1.0 - sinc) / (safe * safe))
    return a, b, c


def so3_exp(phi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map so(3) -> SO(3) for ``(..., 3)`` -> ``(..., 3, 3)``."""
    theta_sq = jnp.sum(phi * phi, axis=-1)
    a, b, _ = _rot_coeffs(theta_sq)
    K = hat(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Log map SO(3) -> so(3) for ``(..., 3, 3)`` -> ``(..., 3)``.

    Accurate for angles in [0, pi); the pipeline only takes logs of relative
    transforms between nearby keyframes (reference: src/map.cpp:43), so the
    near-pi branch uses the stable symmetric-part formula.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    # Antisymmetric part -> axis * sin(theta)
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    small = theta < _SMALL_ANGLE
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    sin_t = jnp.sin(safe)
    # theta / sin(theta), with Taylor 1 + t^2/6 near 0.
    scale = jnp.where(small, 1.0 + theta * theta / 6.0, safe / sin_t)
    phi = scale[..., None] * w
    # Near pi, sin(theta) -> 0 and the antisymmetric part loses the axis;
    # recover it from the diagonal of the symmetric part.
    near_pi = cos_t < -1.0 + 1e-6
    diag = jnp.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), 0.0, None)
    axis = jnp.sqrt(axis_sq)
    # Fix signs from the off-diagonal antisymmetric part.
    axis = axis * jnp.where(w >= 0, 1.0, -1.0)
    phi_pi = axis * theta[..., None]
    return jnp.where(near_pi[..., None], phi_pi, phi)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Exponential map se(3) -> SE(3): ``(..., 6)`` [rho, phi] -> ``(..., 4, 4)``."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta_sq = jnp.sum(phi * phi, axis=-1)
    a, b, c = _rot_coeffs(theta_sq)
    K = hat(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    t = jnp.einsum("...ij,...j->...i", V, rho)
    return _rt_to_mat(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """Log map SE(3) -> se(3): ``(..., 4, 4)`` -> ``(..., 6)`` [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta_sq = jnp.sum(phi * phi, axis=-1)
    K = hat(phi)
    KK = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape)
    # V^{-1} = I - K/2 + coeff * K^2,  coeff = (1 - (t/2) cot(t/2)) / t^2.
    # Float32-stable: 1 - (t/2)cot(t/2) is O(t^2/12), so the subtraction is
    # safe above the small-angle threshold; Taylor below it.
    theta = jnp.sqrt(theta_sq)
    small = theta_sq < _SMALL_ANGLE**2
    safe = jnp.where(small, jnp.ones_like(theta), theta)
    half = 0.5 * safe
    half_cot = half * jnp.cos(half) / jnp.sin(half)
    coeff = jnp.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_cot) / (safe * safe),
    )
    V_inv = eye - 0.5 * K + coeff[..., None, None] * KK
    rho = jnp.einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inv(T: jnp.ndarray) -> jnp.ndarray:
    """Inverse of ``(..., 4, 4)`` rigid transforms without a general solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _rt_to_mat(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def _rt_to_mat(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble ``(..., 4, 4)`` from rotation ``(..., 3, 3)`` and translation."""
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros_like(top[..., :1, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def transform(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply ``(..., 4, 4)`` transforms to ``(..., 3)`` points."""
    return jnp.einsum("...ij,...j->...i", T[..., :3, :3], p) + T[..., :3, 3]


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def so3_project(R: jnp.ndarray, iterations: int = 2) -> jnp.ndarray:
    """Project ``(..., 3, 3)`` near-rotations onto SO(3).

    Newton iteration for the polar factor, ``R <- R (3I - R^T R) / 2``:
    quadratically convergent for ||R^T R - I|| < 1, no SVD (batched matmuls only).

    This projection is load-bearing, not cosmetic.  The reference keeps poses
    in Sophus `SE3` objects (quaternion + translation), which renormalize on
    every operation; a raw 4x4-matrix representation has no such guard.  In
    float32, each frame's pose compositions (`rel @ T_cur`, `Exp(d) @ T`)
    deposit ~1e-7 of non-orthonormality, and the per-frame recurrence
    `rel = T_new @ inv(T_cur)`, `T_prior = rel @ T_cur` *amplifies* the skew
    (inv() uses the transpose, which is only the inverse on SO(3)) by ~2.4x
    per frame: 1e-7 grows to 1e-2 by frame ~15 and tracking collapses — the
    round-1 long-horizon drift.  Projecting at every retract keeps the error
    at machine epsilon forever.
    """
    eye = jnp.broadcast_to(jnp.eye(3, dtype=R.dtype), R.shape)
    for _ in range(iterations):
        R = R @ (1.5 * eye - 0.5 * (jnp.swapaxes(R, -1, -2) @ R))
    return R


def se3_orthonormalize(T: jnp.ndarray, iterations: int = 2) -> jnp.ndarray:
    """Re-project the rotation block of ``(..., 4, 4)`` transforms onto SO(3)."""
    return _rt_to_mat(so3_project(T[..., :3, :3], iterations), T[..., :3, 3])


def retract(T: jnp.ndarray, delta: jnp.ndarray) -> jnp.ndarray:
    """Left-multiplicative manifold update ``Exp(delta) @ T``.

    Matches the reference's `VertexPose::add` (lego_types.h:61-91), including
    its NaN/Inf guard: a non-finite update leaves the pose unchanged.  The
    result is re-projected onto SE(3) (see `so3_project` for why).
    """
    finite = jnp.all(jnp.isfinite(delta), axis=-1)
    delta = jnp.where(finite[..., None], delta, jnp.zeros_like(delta))
    return se3_orthonormalize(se3_exp(delta) @ T)


def adjoint(T: jnp.ndarray) -> jnp.ndarray:
    """Adjoint of ``(..., 4, 4)`` transforms for [rho, phi] tangents:
    Ad(T) = [[R, hat(t) R], [0, R]] (..., 6, 6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    tR = hat(t) @ R
    zero = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([zero, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def rot_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrices ``(..., 3, 3)`` -> unit quaternions ``(..., 4)`` (x, y, z, w).

    Branch-free Shepperd-style selection of the numerically largest component,
    used for TUM-format trajectory export.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions from the four diagonal pivots.
    qw = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11], axis=-1)
    qw = jnp.sqrt(jnp.clip(qw, 1e-12, None)) * 0.5
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    cand = jnp.stack(
        [
            jnp.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0), w0], axis=-1),
            jnp.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1), (m21 - m12) / (4 * x1)], axis=-1),
            jnp.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2), (m02 - m20) / (4 * y2)], axis=-1),
            jnp.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3, (m10 - m01) / (4 * z3)], axis=-1),
        ],
        axis=-2,
    )
    pivot = jnp.argmax(jnp.stack([tr, m00, m11, m22], axis=-1), axis=-1)
    q = jnp.take_along_axis(cand, pivot[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
