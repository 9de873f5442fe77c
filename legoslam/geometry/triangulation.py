"""Batched multi-view DLT triangulation.

Re-designs `legoslam::triangulation` (include/legoslam/algorithm.h:11-34):
stack the two DLT rows per view, take the null vector of the DLT matrix, and
gate on the singular-value ratio sigma_last / sigma_second_last < 1e-3 plus
finiteness.  Where the reference loops one point at a time on the host
(cv-style SVD per point), this runs the whole candidate batch on device.

The default implementation avoids `jnp.linalg.svd` entirely: batched
iterative SVD of (N, 2V, 4) matrices is a long sequential device program at
N=512 (it dominated the keyframe branch when measured), while everything the
gate and the null vector need is available in closed form from S = A^T A
(4x4 symmetric PSD):

- null vector: adj(S) = prod(nonzero eigenvalues) * v4 v4^T for a rank-3 S,
  so the column of the adjugate with the largest diagonal entry IS the
  smallest-eigenvector direction — 16 cofactors, pure elementwise math;
- sigma_4^2: the Rayleigh quotient of that vector;
- sigma_1..3^2: deflate the characteristic quartic by the known smallest
  eigenvalue (synthetic division by (x - e4)) and solve the remaining cubic
  with the trigonometric method — again closed-form elementwise math.

The whole thing fuses into one elementwise XLA kernel (~0.05 ms), ~60x
faster than the SVD path, which is kept as `method="svd"` for validation
(tests assert gate/point agreement).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sym_invariants(S: jnp.ndarray):
    """Characteristic-polynomial invariants of a batched symmetric 4x4.

    Returns (c1, c2, c3, c4, adjS) for det(xI - S) = x^4 - c1 x^3 + c2 x^2
    - c3 x + c4, with adjS the (N, 4, 4) adjugate (c3 = tr(adjS)).

    Everything is explicit cofactor arithmetic — no matmuls.  A batched
    (N,4,4) matmul chain (the Cayley-Hamilton form of the adjugate) may run
    its f32 inputs at reduced pass precision (TF32 on a GPU by default),
    which destroys exactly the trailing digits the sing-ratio gate lives on;
    the elementwise form stays in full f32.
    """
    c1 = jnp.trace(S, axis1=-2, axis2=-1)

    def m(i, j):
        return S[..., i, j]

    # Sum of principal 2x2 minors.
    c2 = (
        m(0, 0) * m(1, 1) - m(0, 1) ** 2
        + m(0, 0) * m(2, 2) - m(0, 2) ** 2
        + m(0, 0) * m(3, 3) - m(0, 3) ** 2
        + m(1, 1) * m(2, 2) - m(1, 2) ** 2
        + m(1, 1) * m(3, 3) - m(1, 3) ** 2
        + m(2, 2) * m(3, 3) - m(2, 3) ** 2
    )

    def det3(r0, r1, r2, q0, q1, q2):
        """3x3 minor from rows (r0,r1,r2) and columns (q0,q1,q2)."""
        return (
            m(r0, q0) * (m(r1, q1) * m(r2, q2) - m(r1, q2) * m(r2, q1))
            - m(r0, q1) * (m(r1, q0) * m(r2, q2) - m(r1, q2) * m(r2, q0))
            + m(r0, q2) * (m(r1, q0) * m(r2, q1) - m(r1, q1) * m(r2, q0))
        )

    rows = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    # adj(S)[i, j] = (-1)^{i+j} * minor(j, i); S symmetric => adj symmetric,
    # so build the upper triangle and mirror.
    adj = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(i, 4):
            sign = 1.0 if (i + j) % 2 == 0 else -1.0
            cof = sign * det3(*rows[j], *rows[i])
            adj[i][j] = cof
            adj[j][i] = cof
    adjS = jnp.stack([jnp.stack(r, axis=-1) for r in adj], axis=-2)
    c3 = adj[0][0] + adj[1][1] + adj[2][2] + adj[3][3]
    # det via expansion along row 0 with the first-row cofactors
    # (adj[j][0] = cofactor C_{0j} by symmetry of S).
    c4 = (
        m(0, 0) * adj[0][0] + m(0, 1) * adj[1][0]
        + m(0, 2) * adj[2][0] + m(0, 3) * adj[3][0]
    )
    return c1, c2, c3, c4, adjS


def _cubic_roots_desc(d1: jnp.ndarray, d2: jnp.ndarray, d3: jnp.ndarray):
    """Real roots of x^3 - d1 x^2 + d2 x - d3 (all real for our deflated
    PSD spectrum), returned (largest, middle, smallest).  Trigonometric
    method on the depressed cubic."""
    a = -d1
    b = d2
    c = -d3
    q = (a * a - 3.0 * b) / 9.0
    r = (2.0 * a**3 - 9.0 * a * b + 27.0 * c) / 54.0
    q = jnp.maximum(q, 0.0)
    sq = jnp.sqrt(q)
    denom = jnp.where(q > 0, sq**3, 1.0)
    cosT = jnp.clip(r / denom, -1.0, 1.0)
    th = jnp.arccos(cosT)
    shift = -a / 3.0
    r0 = -2.0 * sq * jnp.cos(th / 3.0) + shift
    r1 = -2.0 * sq * jnp.cos((th + 2.0 * jnp.pi) / 3.0) + shift
    r2 = -2.0 * sq * jnp.cos((th - 2.0 * jnp.pi) / 3.0) + shift
    hi = jnp.maximum(jnp.maximum(r0, r1), r2)
    lo = jnp.minimum(jnp.minimum(r0, r1), r2)
    mid = r0 + r1 + r2 - hi - lo
    return hi, mid, lo


def _null_and_sigmas(A: jnp.ndarray):
    """Smallest-right-singular direction and (s1, s3, s4) of batched (N, R, 4).

    Everything is derived from S = A^T A in closed form (module docstring).
    Returns (v (N, 4) unnormalized-scale-free, s1, s3, s4) with s* >= 0.
    """
    # HIGHEST: keep true f32 products (a DEFAULT f32 matmul may use TF32).
    S = jnp.einsum("nri,nrj->nij", A, A, precision=jax.lax.Precision.HIGHEST)
    c1, c2, c3, c4, adjS = _sym_invariants(S)

    # Null direction: best column of the adjugate (diag(adjS) >= 0 in exact
    # arithmetic; the largest diagonal marks the best-conditioned column).
    diag = jnp.diagonal(adjS, axis1=-2, axis2=-1)
    col = jnp.argmax(diag, axis=-1)
    v = jnp.take_along_axis(adjS, col[..., None, None].repeat(4, axis=-2), axis=-1)[..., 0]
    vn2 = jnp.sum(v * v, axis=-1)
    safe = vn2 > 0
    v = jnp.where(safe[..., None], v, jnp.asarray([0.0, 0.0, 0.0, 1.0], A.dtype))
    vn2 = jnp.where(safe, vn2, 1.0)

    # e4 = |A v|^2 / |v|^2: algebraically the Rayleigh quotient of S, but a
    # sum of squares — no cancellation, unlike v^T S v which loses ~eps*|S|
    # absolute accuracy (that noise is the same order as e4 itself at the
    # sing-ratio gate).
    Av = jnp.einsum("nri,ni->nr", A, v, precision=jax.lax.Precision.HIGHEST)
    e4 = jnp.sum(Av * Av, axis=-1) / vn2

    # Deflate the quartic x^4 - c1x^3 + c2x^2 - c3x + c4 by (x - e4).
    d1 = c1 - e4
    d2 = c2 - e4 * d1
    # d3 = c3 - e4*d2, but for tiny e4 this cancels badly; both forms agree
    # to O(e4^2) and the cubic cares about relative accuracy of d3 ~ e1e2e3.
    d3 = c3 - e4 * d2
    e1, _, e3 = _cubic_roots_desc(d1, d2, jnp.maximum(d3, 0.0))
    e1 = jnp.maximum(e1, 0.0)
    e3 = jnp.maximum(e3, 0.0)
    return v, jnp.sqrt(e1), jnp.sqrt(e3), jnp.sqrt(e4)


def triangulate(
    poses: jnp.ndarray,
    pts_norm: jnp.ndarray,
    sing_ratio_thr: float = 1e-3,
    method: str = "fast",
):
    """Triangulate N points seen in V views.

    Args:
      poses: (V, 4, 4) camera-from-world transforms for each view.
      pts_norm: (N, V, 2) normalized camera coordinates (x/z, y/z) per view.
      sing_ratio_thr: acceptance threshold on sigma_4 / sigma_3 of the DLT
        matrix (well-constrained null space), as in algorithm.h:30.
      method: "fast" (closed-form, default) or "svd" (jnp.linalg reference).

    Returns:
      pt_world: (N, 3) triangulated points (undefined where ~ok).
      ok: (N,) bool validity (finite and ratio-gated).
    """
    m = poses[:, :3, :]  # (V, 3, 4)
    x = pts_norm[..., 0][..., None]  # (N, V, 1)
    y = pts_norm[..., 1][..., None]
    row0 = x * m[None, :, 2, :] - m[None, :, 0, :]  # (N, V, 4)
    row1 = y * m[None, :, 2, :] - m[None, :, 1, :]
    A = jnp.concatenate([row0, row1], axis=-2)  # (N, 2V, 4) rows interleaved by block

    if method == "svd":
        _, s, vh = jnp.linalg.svd(A, full_matrices=False)
        v_last = vh[..., -1, :]  # (N, 4) null-space direction
        s1, s3, s4 = s[..., 0], s[..., 2], s[..., 3]
    else:
        v_last, s1, s3, s4 = _null_and_sigmas(A)

    pt = v_last[..., :3] / (v_last[..., 3:4])

    finite = jnp.all(jnp.isfinite(pt), axis=-1)
    ratio_ok = s4 / jnp.maximum(s3, jnp.finfo(A.dtype).tiny) < jnp.asarray(
        sing_ratio_thr, A.dtype
    )
    # Rank gate (addition over the reference): a rank-deficient DLT system has a
    # >1-dimensional null space, which makes the ratio gate pass spuriously
    # (sigma_3 ~ 0 as well) — e.g. two identical views. The reference only
    # catches these downstream via depth gates (frontend_g2o.cpp:328-331).
    # The fast path resolves s3 only down to ~sqrt(f32 eps)*s1 ~ 2.4e-4
    # (cofactor cancellation), so its gate sits at 1e-2 — 40x above that
    # noise floor and 19x below the smallest s3/s1 seen in genuine stereo
    # geometry (min 0.19 over depths 1..200 m at a 0.54 m baseline).
    rank_ok = s3 > (1e-6 if method == "svd" else 1e-2) * s1
    return pt, finite & ratio_ok & rank_ok


def triangulate_stereo(
    rig_left_pose,
    rig_right_pose,
    uv_norm_left,
    uv_norm_right,
    sing_ratio_thr: float = 1e-3,
    method: str = "fast",
):
    """Two-view convenience wrapper used by stereo init / new-landmark birth.

    Args:
      rig_left_pose, rig_right_pose: (4, 4) camera-from-rig extrinsics.
      uv_norm_left, uv_norm_right: (N, 2) normalized camera coordinates.

    Returns (pt_rig (N,3), ok (N,)) with points in the rig (left cam) frame.
    """
    poses = jnp.stack([rig_left_pose, rig_right_pose], axis=0)
    pts = jnp.stack([uv_norm_left, uv_norm_right], axis=1)
    return triangulate(poses, pts, sing_ratio_thr, method=method)
