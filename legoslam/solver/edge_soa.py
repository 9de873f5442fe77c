"""Structure-of-arrays BA engine: the component-major fast path for the LM loop.

Functionally identical to the block pipeline in solver/schur.py (both
re-design `lego::Problem::buildHessian`/`solveLinearEquation`,
src/lego/base/problem.cpp:273-431), but laid out component-major:

The block pipeline keeps per-edge quantities as (E, 2, 6) / (E, 6, 6) /
(E, 2, 2) tensors, whose tiny minor dimensions make each einsum its own
badly-shaped kernel — the measured cost of one LM iteration was ~50x its
FLOP count on the machine this engine was first tuned on.

Here every per-edge scalar lives in its own (E,) vector ("component"), with E
as the lane dimension: residuals are 2 components, the pose Jacobian 12, the
point Jacobian 6, the weight matrix 3.  All edge math then becomes fused
elementwise code, the pose/landmark gathers become small one-hot matmuls or
1-D takes, and the only large ops left are the assembly contractions
(components @ one-hot).

The assembled system is kept packed the same way — Hpp (36, K), Hll (9, L),
Hpl (6K, 3, L) — through the Schur reduction (problem.cpp:362-431), so no
layout change ever touches the inner loop.  Outputs match solver/schur.py to
float tolerance; tests/test_edge_soa.py pins the equivalence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.geometry import se3
from legoslam.solver import robust, schur

_EPS = 1e-18  # reference divide guard (lego_types.h:143)


class GraphSoA(NamedTuple):
    """Per-solve constants derived from a `schur.BAGraph`."""

    graph: schur.BAGraph
    onehot_p: jnp.ndarray    # (K, E) pose one-hot (transposed, for gathers)
    onehot_l: jnp.ndarray    # (E, L) landmark one-hot (for assembly reductions)
    w_cam: jnp.ndarray       # (E,) 0.0 = left extrinsic, 1.0 = right
    u: jnp.ndarray           # (E,) measurement u
    v: jnp.ndarray           # (E,) measurement v
    valid: jnp.ndarray       # (E,) edge valid & landmark slot valid
    fixed_e: jnp.ndarray     # (E,) pose fixed per edge


class SoABlocks(NamedTuple):
    """Packed normal equations (component-major; additive across edge shards)."""

    Hpp: jnp.ndarray   # (36, K) pose diagonal blocks, component i*6+j
    Hll: jnp.ndarray   # (9, L) landmark diagonal blocks, component c*3+d
    Hpl: jnp.ndarray   # (6K, 3, L) cross blocks, row k*6+a, mid b
    bp: jnp.ndarray    # (6, K)
    bl: jnp.ndarray    # (3, L)


def make_soa_graph(graph: schur.BAGraph, assembly: bool = True) -> GraphSoA:
    """Derive the SoA constants. `assembly=False` skips the (E, L) landmark
    one-hot (only needed by `soa_build`, not the chi/residual paths)."""
    if graph.exts.shape[0] != 2:
        # `_edge_core` blends the per-edge extrinsic as a linear interpolation
        # of exts[0]/exts[1] by e_cam — only valid for a 2-camera rig with
        # e_cam in {0, 1}.  Other rigs must use engine="blocks".
        raise ValueError(
            f"SoA engine supports exactly 2 cameras, got {graph.exts.shape[0]}; "
            "use solve_ba(..., engine='blocks')"
        )
    K = graph.pose_fixed.shape[0]
    L = graph.point_valid.shape[0]
    dtype = graph.e_uv.dtype
    onehot_p = (jnp.arange(K, dtype=jnp.int32)[:, None] == graph.e_pose[None, :]).astype(dtype)
    if assembly:
        onehot_l = (graph.e_point[:, None] == jnp.arange(L, dtype=jnp.int32)[None, :]).astype(dtype)
    else:
        onehot_l = None
    valid = graph.e_valid & graph.point_valid[graph.e_point]
    return GraphSoA(
        graph=graph,
        onehot_p=onehot_p,
        onehot_l=onehot_l,
        w_cam=graph.e_cam.astype(dtype),
        u=graph.e_uv[:, 0],
        v=graph.e_uv[:, 1],
        valid=valid,
        fixed_e=graph.pose_fixed[graph.e_pose],
    )


def _edge_core(gs: GraphSoA, poses: jnp.ndarray, points: jnp.ndarray):
    """Residuals + Jacobian components for every edge, as (E,) vectors.

    Implements `EdgeProjection` (lego_types.h:188-261) component-wise:
    p_rig = T_cw p_w, p_cam = ext p_rig, r = z - pi(K p_cam), the analytic
    2x6 pose Jacobian at the post-extrinsic point, and
    J_point = J_pose[:, :3] (R_ext R_cw).
    """
    g = gs.graph
    K = poses.shape[0]
    # Pose components via one-hot matmul: (12, K) @ (K, E) -> (12, E).
    pack = poses[:, :3, :].reshape(K, 12).T
    Tcomp = pack @ gs.onehot_p
    R00, R01, R02, t0 = Tcomp[0], Tcomp[1], Tcomp[2], Tcomp[3]
    R10, R11, R12, t1 = Tcomp[4], Tcomp[5], Tcomp[6], Tcomp[7]
    R20, R21, R22, t2 = Tcomp[8], Tcomp[9], Tcomp[10], Tcomp[11]
    # Point components.  When the landmark one-hot exists (the solve path,
    # which runs this once per LM attempt), gather by contraction: three
    # 1-D takes per iteration were once the largest cost of the window solve.
    # The one-hot has exactly one 1.0 per row, so there is no summation
    # cancellation and the contraction reproduces the take bit-accurately —
    # PROVIDED it runs at full f32 precision (utils/jax_setup.py
    # full_f32_matmuls) and every landmark slot is finite (0 * NaN = NaN would propagate
    # to all edges through the contraction, unlike a take).  Dead slots are
    # sanitized here so the invariant holds regardless of the caller.
    if gs.onehot_l is not None:
        pts = jnp.where(jnp.isfinite(points), points, 0.0)
        pcomp = gs.onehot_l @ pts  # (E, 3) plain GEMM
        pwx, pwy, pwz = pcomp[:, 0], pcomp[:, 1], pcomp[:, 2]
    else:
        idx = g.e_point
        pwx = jnp.take(points[:, 0], idx)
        pwy = jnp.take(points[:, 1], idx)
        pwz = jnp.take(points[:, 2], idx)

    prx = R00 * pwx + R01 * pwy + R02 * pwz + t0
    pry = R10 * pwx + R11 * pwy + R12 * pwz + t1
    prz = R20 * pwx + R21 * pwy + R22 * pwz + t2

    # Extrinsic: blend the two static 4x4s per edge (scalars x (E,) weights).
    w = gs.w_cam
    ext = g.exts  # (2, 4, 4) static values on device
    def ebl(i, j):
        return (1.0 - w) * ext[0, i, j] + w * ext[1, i, j]
    E00, E01, E02, e0 = ebl(0, 0), ebl(0, 1), ebl(0, 2), ebl(0, 3)
    E10, E11, E12, e1 = ebl(1, 0), ebl(1, 1), ebl(1, 2), ebl(1, 3)
    E20, E21, E22, e2 = ebl(2, 0), ebl(2, 1), ebl(2, 2), ebl(2, 3)

    X = E00 * prx + E01 * pry + E02 * prz + e0
    Y = E10 * prx + E11 * pry + E12 * prz + e1
    Z = E20 * prx + E21 * pry + E22 * prz + e2

    fx, fy, cx, cy = g.intr.fx, g.intr.fy, g.intr.cx, g.intr.cy
    zinv = 1.0 / (Z + _EPS)
    ru = gs.u - (fx * X * zinv + cx)
    rv = gs.v - (fy * Y * zinv + cy)

    zinv2 = zinv * zinv
    # 2x6 pose Jacobian rows (lego_types.h:147-178).
    Ju = (
        -fx * zinv,
        jnp.zeros_like(X),
        fx * X * zinv2,
        fx * X * Y * zinv2,
        -fx - fx * X * X * zinv2,
        fx * Y * zinv,
    )
    Jv = (
        jnp.zeros_like(X),
        -fy * zinv,
        fy * Y * zinv2,
        fy + fy * Y * Y * zinv2,
        -fy * X * Y * zinv2,
        -fy * X * zinv,
    )
    # R_hat = R_ext @ R_cw per edge (9 components).
    Rh = [
        [
            E00 * R00 + E01 * R10 + E02 * R20,
            E00 * R01 + E01 * R11 + E02 * R21,
            E00 * R02 + E01 * R12 + E02 * R22,
        ],
        [
            E10 * R00 + E11 * R10 + E12 * R20,
            E10 * R01 + E11 * R11 + E12 * R21,
            E10 * R02 + E11 * R12 + E12 * R22,
        ],
        [
            E20 * R00 + E21 * R10 + E22 * R20,
            E20 * R01 + E21 * R11 + E22 * R21,
            E20 * R02 + E21 * R12 + E22 * R22,
        ],
    ]
    # J_point[a, c] = sum_d J[a, d] R_hat[d, c]  (lego_types.h:251-253).
    Jlu = tuple(Ju[0] * Rh[0][c] + Ju[1] * Rh[1][c] + Ju[2] * Rh[2][c] for c in range(3))
    Jlv = tuple(Jv[0] * Rh[0][c] + Jv[1] * Rh[1][c] + Jv[2] * Rh[2][c] for c in range(3))
    return ru, rv, Ju, Jv, Jlu, Jlv


def soa_edge_chi2(gs: GraphSoA, poses, points, kernel: str, delta: float) -> jnp.ndarray:
    """Per-edge robust chi2 (schur.edge_chi2 equivalent)."""
    ru, rv, *_ = _edge_core(gs, poses, points)
    rho0, _, _ = robust.rho(kernel, ru * ru + rv * rv, delta)
    return rho0


def soa_robust_chi(gs: GraphSoA, poses, points, kernel: str, delta: float) -> jnp.ndarray:
    """0.5 * masked sum of robust chi2 (schur.robust_chi equivalent)."""
    chi = soa_edge_chi2(gs, poses, points, kernel, delta)
    return 0.5 * jnp.sum(jnp.where(gs.valid, chi, 0.0))


def soa_build(gs: GraphSoA, poses, points, kernel: str, delta: float,
              with_chi: bool = False, assembly_dtype=None):
    """Assemble the packed normal equations (buildHessian, problem.cpp:273-358).

    `with_chi=True` additionally returns the robust chi at the same point —
    rho0 falls out of the one robust-kernel evaluation the assembly already
    does, so the LM driver can fuse its per-attempt chi test with the
    re-linearization and pay ONE edge sweep per attempt instead of two
    (lm.lm_optimize chi_build path).  Returns blocks or (blocks, chi).

    `assembly_dtype=jnp.bfloat16` runs the two landmark-axis one-hot
    contractions (Hll and the (18K, E) x (E, L) Hpl product — ~97% of the
    assembly FLOPs, 6 GFLOP at production shape) with bfloat16 inputs and
    float32 accumulation instead of full-f32 products.  Per-edge math, residuals, chi, bp/bl and the Hpp pose blocks
    stay float32.  The ~0.4% relative error this puts on Hll/Hpl entries only
    perturbs the LM *step* (the model Hessian), never the objective: chi is
    still measured in f32 and bad steps roll back, so the solver stays exact,
    trading at most an extra iteration near convergence (A/B-tested in
    tests/test_edge_soa.py::test_bf16_assembly_reaches_f32_optimum)."""
    K = poses.shape[0]
    ru, rv, Ju, Jv, Jlu, Jlv = _edge_core(gs, poses, points)

    # Masking identical to schur.edge_terms: residual zeroed on invalid edges
    # *before* the robust kernel, Jacobians zeroed per their vertex masks.
    vm = gs.valid
    ru = jnp.where(vm, ru, 0.0)
    rv = jnp.where(vm, rv, 0.0)
    e2 = ru * ru + rv * rv
    rho0, rho1, rho2 = robust.rho(kernel, e2, delta)
    keep = rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1  # PSD guard (base_edge.cpp:55)
    two_r2 = jnp.where(keep, 2.0 * rho2, 0.0)
    W00 = jnp.where(vm, rho1 + two_r2 * ru * ru, 0.0)
    W01 = jnp.where(vm, two_r2 * ru * rv, 0.0)
    W11 = jnp.where(vm, rho1 + two_r2 * rv * rv, 0.0)
    drho = jnp.where(vm, rho1, 0.0)

    pose_m = vm & ~gs.fixed_e
    Ju = tuple(jnp.where(pose_m, j, 0.0) for j in Ju)
    Jv = tuple(jnp.where(pose_m, j, 0.0) for j in Jv)
    Jlu = tuple(jnp.where(vm, j, 0.0) for j in Jlu)
    Jlv = tuple(jnp.where(vm, j, 0.0) for j in Jlv)

    # J^T W rows.
    JWu = tuple(Ju[i] * W00 + Jv[i] * W01 for i in range(6))
    JWv = tuple(Ju[i] * W01 + Jv[i] * W11 for i in range(6))
    JWlu = tuple(Jlu[c] * W00 + Jlv[c] * W01 for c in range(3))
    JWlv = tuple(Jlu[c] * W01 + Jlv[c] * W11 for c in range(3))

    # Per-edge block components -> assembly contractions.
    Hpp_e = jnp.stack([JWu[i] * Ju[j] + JWv[i] * Jv[j] for i in range(6) for j in range(6)])
    Hll_e = jnp.stack([JWlu[c] * Jlu[d] + JWlv[c] * Jlv[d] for c in range(3) for d in range(3)])
    bp_e = jnp.stack([-drho * (Ju[i] * ru + Jv[i] * rv) for i in range(6)])
    bl_e = jnp.stack([-drho * (Jlu[c] * ru + Jlv[c] * rv) for c in range(3)])

    Hpp = Hpp_e @ gs.onehot_p.T          # (36, K)
    bp = bp_e @ gs.onehot_p.T            # (6, K)

    acc = jnp.float32 if assembly_dtype is not None else None
    def lmm(A, B):
        # landmark-axis contraction, optionally in reduced precision
        if assembly_dtype is None:
            return A @ B
        return jax.lax.dot(
            A.astype(assembly_dtype), B.astype(assembly_dtype),
            preferred_element_type=acc,
        ).astype(A.dtype)

    Hll = Hll_e @ gs.onehot_l            # (9, L)  (f32: bf16 here buys ~3%
    #   of the assembly FLOPs but traded badly in compile time)
    bl = bl_e @ gs.onehot_l              # (3, L)

    # Cross blocks: mask the 18 components by pose lane, one matmul over E.
    Hpl_e = jnp.stack(
        [JWu[a] * Jlu[b] + JWv[a] * Jlv[b] for a in range(6) for b in range(3)]
    )  # (18, E)
    P1 = (Hpl_e[None] * gs.onehot_p[:, None, :]).reshape(K * 18, -1)  # (18K, E)
    Hpl = lmm(P1, gs.onehot_l).reshape(K, 6, 3, -1).reshape(K * 6, 3, -1)  # (6K, 3, L)
    blocks = SoABlocks(Hpp=Hpp, Hll=Hll, Hpl=Hpl, bp=bp, bl=bl)
    if with_chi:
        # Matches soa_robust_chi: invalid edges have r = 0 => rho0 = 0 for
        # every kernel, so masking before vs after rho is equivalent.
        return blocks, 0.5 * jnp.sum(jnp.where(vm, rho0, 0.0))
    return blocks


def _inv3x3_comps(Hll: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of (9, L) packed 3x3 blocks (cf. schur._inv3x3_masked)."""
    a, b, c, d, e, f, g, h, i = (Hll[k] for k in range(9))
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
    return jnp.stack([co00, co01, co02, co10, co11, co12, co20, co21, co22]) * inv_det


def soa_schur_reduce(blocks: SoABlocks, point_valid: jnp.ndarray, lam=0.0, strategy: str = "default"):
    """Schur elimination of the landmark blocks (problem.cpp:380-404), with
    the landmark diagonal damped first (schur.damp_landmark_diag — the g2o
    default-build placement; see that docstring for why float32 needs it).

    Returns (S (6K, 6K) pose-diag-undamped, bs (6K,), damped Hll_inv (9, L))."""
    KP = blocks.Hpp.shape[1]
    L = blocks.Hll.shape[1]
    diag_idx = jnp.asarray([0, 4, 8])
    Hll_d = blocks.Hll.at[diag_idx].set(
        schur.damp_landmark_diag(blocks.Hll[diag_idx], lam, strategy)
    )
    inv = _inv3x3_comps(Hll_d, point_valid)  # (9, L), row-major [b*3+c]
    # T1[m, c, :] = sum_b Hpl[m, b, :] * inv[b, c, :]
    T1 = jnp.stack(
        [sum(blocks.Hpl[:, b, :] * inv[b * 3 + c] for b in range(3)) for c in range(3)],
        axis=1,
    )  # (6K, 3, L)
    T1f = T1.reshape(6 * KP, 3 * L)
    Hplf = blocks.Hpl.reshape(6 * KP, 3 * L)
    S_off = T1f @ Hplf.T
    HppB = blocks.Hpp.T.reshape(KP, 6, 6)
    eyeK = jnp.eye(KP, dtype=blocks.Hpp.dtype)
    BD = (eyeK[:, None, :, None] * HppB[:, :, None, :]).reshape(6 * KP, 6 * KP)
    S = BD - S_off
    bs = blocks.bp.T.reshape(-1) - T1f @ blocks.bl.reshape(-1)
    return S, bs, inv


def soa_back_substitute(blocks: SoABlocks, Hll_inv: jnp.ndarray, dx_p: jnp.ndarray) -> jnp.ndarray:
    """delta_landmark = Hll^-1 (bl - Hlp dx_p) (problem.cpp:426-429); (L, 3)."""
    KP = blocks.Hpp.shape[1]
    L = blocks.Hll.shape[1]
    rhs = blocks.bl - (blocks.Hpl.reshape(6 * KP, 3 * L).T @ dx_p.reshape(-1)).reshape(3, L)
    dxl = jnp.stack(
        [sum(Hll_inv[c * 3 + d] * rhs[d] for d in range(3)) for c in range(3)]
    )  # (3, L)
    return dxl.T


def soa_blocks_diag(blocks: SoABlocks) -> jnp.ndarray:
    """[diag(Hpp); diag(Hll)] in the same order as lm.solve_ba's aux diag."""
    dp = blocks.Hpp[jnp.asarray([0, 7, 14, 21, 28, 35])]  # (6, K)
    dl = blocks.Hll[jnp.asarray([0, 4, 8])]               # (3, L)
    return jnp.concatenate([dp.T.reshape(-1), dl.T.reshape(-1)])


def to_bablocks(blocks: SoABlocks) -> schur.BABlocks:
    """Unpack to the block layout (for tests / interop)."""
    KP = blocks.Hpp.shape[1]
    L = blocks.Hll.shape[1]
    return schur.BABlocks(
        Hpp=blocks.Hpp.T.reshape(KP, 6, 6),
        Hll=blocks.Hll.T.reshape(L, 3, 3),
        Hpl=blocks.Hpl.reshape(KP, 6, 3, L).transpose(0, 3, 1, 2),
        bp=blocks.bp.T,
        bl=blocks.bl.T,
    )
