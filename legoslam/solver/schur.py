"""Block-sparse Hessian assembly and Schur-complement reduction for BA.

Re-designs `lego::Problem`'s dense pipeline (src/lego/base/problem.cpp):
`buildHessian` (:273-358) becomes batched edge math + segment-sums into block
arrays; `solveLinearEquation`'s Schur elimination of landmark blocks
(:362-431) becomes a batched 3x3 block inverse plus two einsum contractions.  The reference's pose-first/landmark-second ordering
and its per-landmark diagonal-block inversion trick (:390-400) are
preserved; the damping placement follows the *default* reference binary
(g2o: full-diagonal damping, landmark blocks included — see
`damp_landmark_diag`), not the vendored LEGO solver's pose-only placement,
which is unstable in float32.

Shapes: K poses (6 DoF each), L landmarks (3 DoF), E edges, each edge joining
exactly one pose and one landmark through one of C camera extrinsics.  The
cross-block array H_pl is kept dense at (K, L, 6, 3) — with a sliding window
of ~16 keyframes and a few thousand active landmarks that is only a few MB
and makes the reduction two big matmuls instead of host-side sparsity.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from legoslam.solver import reprojection, robust


class BAGraph(NamedTuple):
    """Static-shape bundle-adjustment graph (constant during one solve).

    Masks express structure the reference expresses by object presence:
    `e_valid` (edge exists & inlier), `point_valid` (landmark slot occupied),
    `pose_fixed` (reference `BaseVertex::setFixed`).
    """

    e_pose: jnp.ndarray    # (E,) int32 pose index per edge
    e_point: jnp.ndarray   # (E,) int32 landmark index per edge
    e_cam: jnp.ndarray     # (E,) int32 extrinsic index per edge
    e_uv: jnp.ndarray      # (E, 2) pixel measurement
    e_valid: jnp.ndarray   # (E,) bool
    exts: jnp.ndarray      # (C, 4, 4) camera-from-rig extrinsics
    intr: reprojection.Intrinsics
    pose_fixed: jnp.ndarray   # (K,) bool
    point_valid: jnp.ndarray  # (L,) bool


class BABlocks(NamedTuple):
    """Assembled normal equations in block form."""

    Hpp: jnp.ndarray   # (K, 6, 6) pose diagonal blocks
    Hll: jnp.ndarray   # (L, 3, 3) landmark diagonal blocks
    Hpl: jnp.ndarray   # (K, L, 6, 3) cross blocks
    bp: jnp.ndarray    # (K, 6)
    bl: jnp.ndarray    # (L, 3)


def edge_mask(graph: BAGraph) -> jnp.ndarray:
    return graph.e_valid & graph.point_valid[graph.e_point]


def edge_terms(graph: BAGraph, poses: jnp.ndarray, points: jnp.ndarray, kernel: str, delta: float):
    """Per-edge residuals/Jacobians/robust weights, masked.

    Returns (r, J_pose, J_point, drho, W, valid). Fixed poses get zero pose
    Jacobians (problem.cpp:297: fixed vertices are skipped in assembly).
    """
    T = poses[graph.e_pose]
    pw = points[graph.e_point]
    ext = graph.exts[graph.e_cam]
    r, Jp, Jl = reprojection.projection_edge(graph.intr, T, ext, pw, graph.e_uv)
    valid = edge_mask(graph)
    r = jnp.where(valid[:, None], r, 0.0)
    drho, W = robust.robust_information(kernel, r, delta)
    W = jnp.where(valid[:, None, None], W, 0.0)
    drho = jnp.where(valid, drho, 0.0)
    Jp = jnp.where((valid & ~graph.pose_fixed[graph.e_pose])[:, None, None], Jp, 0.0)
    Jl = jnp.where(valid[:, None, None], Jl, 0.0)
    return r, Jp, Jl, drho, W, valid


def robust_chi(graph: BAGraph, poses: jnp.ndarray, points: jnp.ndarray, kernel: str, delta: float) -> jnp.ndarray:
    """0.5 * sum of robust chi2 over valid edges (problem.cpp:470-479)."""
    T = poses[graph.e_pose]
    pw = points[graph.e_point]
    ext = graph.exts[graph.e_cam]
    r, _, _ = reprojection.projection_edge(graph.intr, T, ext, pw, graph.e_uv)
    chi = robust.robust_chi2(kernel, r, delta)
    return 0.5 * jnp.sum(jnp.where(edge_mask(graph), chi, 0.0))


def edge_chi2(graph: BAGraph, poses: jnp.ndarray, points: jnp.ndarray, kernel: str, delta: float) -> jnp.ndarray:
    """Per-edge robust chi2 (for outlier classification, backend_lego.cpp:170-176)."""
    T = poses[graph.e_pose]
    pw = points[graph.e_point]
    ext = graph.exts[graph.e_cam]
    r, _, _ = reprojection.projection_edge(graph.intr, T, ext, pw, graph.e_uv)
    return robust.robust_chi2(kernel, r, delta)


def build_blocks(graph: BAGraph, poses: jnp.ndarray, points: jnp.ndarray, kernel: str, delta: float) -> BABlocks:
    """buildHessian (problem.cpp:273-358) as one-hot matmul reductions.

    Per-edge blocks reduce into pose/landmark segments through one-hot
    assignment matrices contracted as matmuls instead of `segment_sum`
    scatter-adds (the largest is (K, E, 18) x (E, L) for the cross blocks,
    a few GFLOP).
    """
    K = poses.shape[0]
    L = points.shape[0]
    dtype = points.dtype
    r, Jp, Jl, drho, W, valid = edge_terms(graph, poses, points, kernel, delta)

    JpW = jnp.einsum("eia,eij->eaj", Jp, W)       # (E, 6, 2) J^T W
    JlW = jnp.einsum("eia,eij->eaj", Jl, W)       # (E, 3, 2)
    Hpp_e = jnp.einsum("eaj,ejb->eab", JpW, Jp)   # (E, 6, 6)
    Hll_e = jnp.einsum("eaj,ejb->eab", JlW, Jl)   # (E, 3, 3)
    Hpl_e = jnp.einsum("eaj,ejb->eab", JpW, Jl)   # (E, 6, 3)
    # b -= drho * J^T * Lambda * r with Lambda = I (problem.cpp:329)
    bp_e = -drho[:, None] * jnp.einsum("eia,ei->ea", Jp, r)
    bl_e = -drho[:, None] * jnp.einsum("eia,ei->ea", Jl, r)

    onehot_p = (graph.e_pose[:, None] == jnp.arange(K)[None, :]).astype(dtype)   # (E, K)
    onehot_l = (graph.e_point[:, None] == jnp.arange(L)[None, :]).astype(dtype)  # (E, L)
    E = graph.e_pose.shape[0]
    Hpp = (onehot_p.T @ Hpp_e.reshape(E, 36)).reshape(K, 6, 6)
    Hll = (onehot_l.T @ Hll_e.reshape(E, 9)).reshape(L, 3, 3)
    bp = onehot_p.T @ bp_e
    bl = onehot_l.T @ bl_e
    # Cross blocks: mask the per-edge block by its pose, reduce over landmarks.
    Vk = Hpl_e.reshape(E, 18)[None, :, :] * onehot_p.T[:, :, None]   # (K, E, 18)
    Hpl = jnp.einsum("el,kev->klv", onehot_l, Vk).reshape(K, L, 6, 3)
    return BABlocks(Hpp=Hpp, Hll=Hll, Hpl=Hpl, bp=bp, bl=bl)


def _inv3x3_masked(A: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse; zero where invalid or near-singular.

    The reference calls Eigen `.inverse()` on each landmark block
    (problem.cpp:396-400) and relies on blocks being well-conditioned; here a
    zeroed inverse makes unconstrained landmarks contribute nothing and
    receive a zero update, which is the masked-array equivalent of those
    vertices not existing.
    """
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    ok = valid & (jnp.abs(det) > 1e-20)
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], -1),
            jnp.stack([co10, co11, co12], -1),
            jnp.stack([co20, co21, co22], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def damp_landmark_diag(diag: jnp.ndarray, lam, strategy: str) -> jnp.ndarray:
    """LM damping of landmark diagonal entries.

    The vendored LEGO solver inverts the landmark blocks *undamped*
    (problem.cpp:390-400, damping only H_pp_schur at :410-417) — safe in its
    all-double arithmetic, but in float32 a weakly-constrained landmark's
    near-singular 3x3 produces a garbage Schur term that no pose-side lambda
    can repair (every LM step rejects, lambda escalates to overflow).  The
    reference's *default checked-in binary* is the g2o pair
    (src/CMakeLists.txt:10-16), and g2o's Levenberg algorithm damps every
    vertex block including landmarks — that placement is reproduced here.
    """
    if strategy == "strategy1":
        return diag + lam * diag
    return diag + lam


def schur_reduce(blocks: BABlocks, point_valid: jnp.ndarray, lam=0.0, strategy: str = "default"):
    """Eliminate landmark blocks (problem.cpp:380-404), damping the landmark
    diagonal per `damp_landmark_diag` first.

    Returns (S (6K, 6K) reduced pose system — pose-diagonal damping NOT yet
    applied, see `damp_and_solve` —, bs (6K,), Hll_inv (L, 3, 3) of the
    *damped* blocks, reused for back-substitution).
    """
    K = blocks.Hpp.shape[0]
    rng3 = jnp.arange(3)
    Hll_d = blocks.Hll.at[:, rng3, rng3].set(
        damp_landmark_diag(blocks.Hll[:, rng3, rng3], lam, strategy)
    )
    Hll_inv = _inv3x3_masked(Hll_d, point_valid)
    T1 = jnp.einsum("klab,lbc->klac", blocks.Hpl, Hll_inv)      # Hpl @ Hll^-1
    S_off = jnp.einsum("klab,mlcb->kmac", T1, blocks.Hpl)       # (K, K, 6, 6)
    S = -S_off
    S = S.at[jnp.arange(K), jnp.arange(K)].add(blocks.Hpp)
    S = S.transpose(0, 2, 1, 3).reshape(6 * K, 6 * K)
    bs = blocks.bp - jnp.einsum("klab,lb->ka", T1, blocks.bl)
    return S, bs.reshape(-1), Hll_inv


def back_substitute(blocks: BABlocks, Hll_inv: jnp.ndarray, dx_p: jnp.ndarray) -> jnp.ndarray:
    """delta_landmark = Hll^-1 (bl - Hlp dx_p) (problem.cpp:426-429)."""
    K = blocks.Hpp.shape[0]
    dxp = dx_p.reshape(K, 6)
    rhs = blocks.bl - jnp.einsum("klab,ka->lb", blocks.Hpl, dxp)
    return jnp.einsum("lab,lb->la", Hll_inv, rhs)


def damp_and_solve(
    S: jnp.ndarray, bs: jnp.ndarray, lam: jnp.ndarray, strategy: str = "default",
    method: str = "cholesky",
) -> jnp.ndarray:
    """Apply the LM damping strategy to the reduced system and solve it.

    default: additive S_ii += lambda (problem.cpp:410-412)
    strategy1: multiplicative S_ii += lambda * S_ii (problem.cpp:414-417)
    method: "cholesky" (Eigen LDLT analogue, problem.cpp:420) or "pcg"
    (problem.cpp:422 / :584-614).

    A unit diagonal is added where the system has no support (fixed poses /
    empty slots) so the dense solve stays well-posed and those unknowns get
    a zero update — the masked-array equivalent of absent vertices.
    """
    diag = jnp.diagonal(S)
    if strategy == "strategy1":
        damped = diag + lam * diag
    else:
        damped = diag + lam
    no_support = jnp.abs(diag) <= 1e-12
    damped = damped + jnp.where(no_support, 1.0, 0.0)
    n = S.shape[0]
    S = S.at[jnp.arange(n), jnp.arange(n)].set(damped)
    if method == "pcg":
        from legoslam.solver import pcg

        return pcg.pcg_solve(S, bs)
    factor = jax.scipy.linalg.cho_factor(S, lower=True)
    return jax.scipy.linalg.cho_solve(factor, bs)
