"""Pallas kernel (Triton route): the whole motion-only pose estimation.

`Frontend::EstimateCurrentPose` (frontend_g2o.cpp:157-245) is 4 outlier-
reclassification rounds around a 10-iteration Levenberg solve over <= E
pose-only reprojection edges.  The XLA formulation (solver/lm.py
estimate_pose) runs each LM iteration as about 35 small ops inside a
`while_loop`; on the GPU that is 40 sequential rounds of kernel launches and
loop-predicate reads for a few hundred FLOPs per edge.  Here one program does
all of it: the edges live in registers as (E,) vectors, the 21 normal-
equation sums and the chi2 sums are block reductions, and the 6x6 Cholesky,
the SE(3) retraction with its Newton-polar SO(3) projection, the Nielsen
lambda schedule and the chi2-based outlier reclassification are scalar code.

Semantics mirror solver/lm.py estimate_pose (default Nielsen strategy): same
build/solve/retract/accept rules, masking and constants.  The deliberate
differences are the 6x6 solve (Cholesky here, LU there; identical for these
SPD systems to float tolerance) and that a rejected step rebuilds the
unchanged normal equations instead of keeping them (same result, branchless).
tests/test_pose_pallas.py pins the equivalence.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from legoslam.geometry.se3 import _SMALL_ANGLE

_EPS = 1e-9  # reprojection._EPS (z-divide guard)
# 4 warps: E=512 edges as 4 values a thread; 1, 2 and 8 warps measured slower
# on an H100 (PERF.md).
_NUM_WARPS = 4


def _mat3_mul(A, B):
    return [[sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)] for i in range(3)]


def _mat3_vec(A, v):
    return [sum(A[i][k] * v[k] for k in range(3)) for i in range(3)]


def _so3_project(R, iterations=2):
    """se3.so3_project on a 3x3 list of scalars: R <- R (1.5 I - 0.5 R^T R)."""
    for _ in range(iterations):
        M = [[sum(R[k][i] * R[k][j] for k in range(3)) for j in range(3)] for i in range(3)]
        S = [[(1.5 if i == j else 0.0) - 0.5 * M[i][j] for j in range(3)] for i in range(3)]
        R = _mat3_mul(R, S)
    return R


def _se3_exp_rt(dx):
    """se3.se3_exp on 6 scalars [rho, phi] -> (R 3x3, t 3) lists, with the
    coefficients of se3._rot_coeffs."""
    rho, phi = dx[:3], dx[3:]
    t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2]
    small = t2 < _SMALL_ANGLE**2
    safe = jnp.where(small, 1.0, jnp.sqrt(t2))
    half = 0.5 * safe
    sinc = jnp.sin(safe) / safe
    sinc_half = jnp.sin(half) / half
    t4 = t2 * t2
    a = jnp.where(small, 1.0 - t2 / 6.0 + t4 / 120.0, sinc)
    b = jnp.where(small, 0.5 - t2 / 24.0 + t4 / 720.0, 0.5 * sinc_half * sinc_half)
    c = jnp.where(small, 1.0 / 6.0 - t2 / 120.0 + t4 / 5040.0, (1.0 - sinc) / (safe * safe))
    zero = jnp.zeros_like(t2)
    K = [[zero, -phi[2], phi[1]], [phi[2], zero, -phi[0]], [-phi[1], phi[0], zero]]
    KK = _mat3_mul(K, K)
    R = [[(1.0 if i == j else 0.0) + a * K[i][j] + b * KK[i][j] for j in range(3)] for i in range(3)]
    V = [[(1.0 if i == j else 0.0) + b * K[i][j] + c * KK[i][j] for j in range(3)] for i in range(3)]
    return R, _mat3_vec(V, rho)


def _chol6_solve(H, b, lam):
    """(H + damping) x = b, unrolled over scalars; schur.damp_and_solve's
    additive damping with a unit diagonal where a coordinate has no support."""
    A = [[H[i][j] for j in range(6)] for i in range(6)]
    for i in range(6):
        d = H[i][i]
        # (a bool-to-float convert of a scalar does not lower on this route)
        A[i][i] = jnp.where(jnp.abs(d) <= 1e-12, d + lam + 1.0, d + lam)
    L = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _pose_kernel(
    pwx_ref, pwy_ref, pwz_ref, u_ref, v_ref, valid_ref, params_ref,
    T_out, inlier_out,
    *, chi2_th: float, iterations: int, outer_iterations: int,
    drop_kernel_after: int, exclude_outliers: bool, tau: float,
    max_diag_cap: float, diff_chi_threshold: float, false_cnt_threshold: int,
):
    f32 = jnp.float32
    pwx, pwy, pwz = pwx_ref[...], pwy_ref[...], pwz_ref[...]
    u, v = u_ref[...], v_ref[...]
    valid = valid_ref[...].astype(f32)
    # params: fx, fy, cx, cy, then the 12 entries of the initial [R | t].
    fx, fy, cx, cy = (params_ref[k] for k in range(4))
    T0 = [params_ref[4 + k] for k in range(12)]
    d2 = chi2_th * chi2_th

    def split(T):
        return [T[4 * i:4 * i + 3] for i in range(3)], [T[4 * i + 3] for i in range(3)]

    def edge_terms(T):
        R, t = split(T)
        X = R[0][0] * pwx + R[0][1] * pwy + R[0][2] * pwz + t[0]
        Y = R[1][0] * pwx + R[1][1] * pwy + R[1][2] * pwz + t[1]
        Z = R[2][0] * pwx + R[2][1] * pwy + R[2][2] * pwz + t[2]
        zinv = 1.0 / (Z + _EPS)
        ru = u - (fx * X * zinv + cx)
        rv = v - (fy * Y * zinv + cy)
        zinv2 = zinv * zinv
        zero = jnp.zeros_like(X)
        Ju = (-fx * zinv, zero, fx * X * zinv2,
              fx * X * Y * zinv2, -fx - fx * X * X * zinv2, fx * Y * zinv)
        Jv = (zero, -fy * zinv, fy * Y * zinv2,
              fy + fy * Y * Y * zinv2, -fy * X * Y * zinv2, -fy * X * zinv)
        return ru, rv, Ju, Jv

    def huber(e2, robust: bool):
        """(rho0, rho1, rho2) of robust.rho(HUBER or TRIVIAL, e2, chi2_th)."""
        if not robust:
            return e2, jnp.ones_like(e2), jnp.zeros_like(e2)
        sqrte = jnp.sqrt(jnp.maximum(e2, 1e-20))
        inl = e2 <= d2
        rho0 = jnp.where(inl, e2, 2.0 * sqrte * chi2_th - d2)
        rho1 = jnp.where(inl, 1.0, chi2_th / sqrte)
        rho2 = jnp.where(inl, 0.0, -0.5 * (chi2_th / sqrte) / jnp.maximum(e2, 1e-20))
        return rho0, rho1, rho2

    def build(T, use, robust):
        """Normal equations (H 6x6, b 6) of lm.solve_pose's build."""
        ru, rv, Ju, Jv = edge_terms(T)
        ru = ru * use
        rv = rv * use
        e2 = ru * ru + rv * rv
        _, rho1, rho2 = huber(e2, robust)
        keep = rho1 + 2.0 * rho2 * e2 > 1e-5 * rho1   # robust.py PSD guard
        two_r2 = jnp.where(keep, 2.0 * rho2, 0.0)
        W00 = (rho1 + two_r2 * ru * ru) * use
        W01 = (two_r2 * ru * rv) * use
        W11 = (rho1 + two_r2 * rv * rv) * use
        drho = rho1 * use
        JWu = [Ju[i] * W00 + Jv[i] * W01 for i in range(6)]
        JWv = [Ju[i] * W01 + Jv[i] * W11 for i in range(6)]
        H = [[None] * 6 for _ in range(6)]
        for i in range(6):
            for j in range(i, 6):
                H[i][j] = H[j][i] = jnp.sum(JWu[i] * Ju[j] + JWv[i] * Jv[j])
        b = [jnp.sum(-drho * (Ju[i] * ru + Jv[i] * rv)) for i in range(6)]
        return H, b

    def chi_at(T, use, robust):
        ru, rv, _, _ = edge_terms(T)
        ru = ru * use
        rv = rv * use
        rho0, _, _ = huber(ru * ru + rv * rv, robust)
        return 0.5 * jnp.sum(rho0 * use)

    def retract(T, dx):
        """se3.retract: Exp(dx) @ T, re-orthonormalized; a non-finite dx
        leaves T unchanged."""
        finite = jnp.isfinite(dx[0])
        for k in range(1, 6):
            finite = finite & jnp.isfinite(dx[k])
        dx = [jnp.where(finite, dx[k], 0.0) for k in range(6)]
        Re, te = _se3_exp_rt(dx)
        R, t = split(T)
        Rn = _so3_project(_mat3_mul(Re, R), 2)
        tn = [_mat3_vec(Re, t)[i] + te[i] for i in range(3)]
        return [x for i in range(3) for x in Rn[i] + [tn[i]]]

    outlier = jnp.zeros_like(valid)
    T = T0
    for rnd in range(outer_iterations):
        robust = rnd <= drop_kernel_after
        use = valid * (1.0 - outlier) if exclude_outliers else valid

        H0, _ = build(T0, use, robust)
        maxd = jnp.abs(H0[0][0])
        for i in range(1, 6):
            maxd = jnp.maximum(maxd, jnp.abs(H0[i][i]))
        lam0 = tau * jnp.minimum(maxd, max_diag_cap)
        chi0 = chi_at(T0, use, robust)

        def cond(st):
            _, _, _, _, _, it, _, stop = st
            return ~stop & (it < iterations)

        def body(st, use=use, robust=robust):
            Tc, chi, last_chi, lam, ni, it, false_cnt, _ = st
            H, b = build(Tc, use, robust)
            dx = _chol6_solve(H, b, lam)
            cand = retract(Tc, dx)
            temp_chi = chi_at(cand, use, robust)
            scale = 0.0
            for k in range(6):
                scale = scale + dx[k] * (lam * dx[k] + b[k])
            scale = 0.5 * scale + 1e-10
            rho_val = (chi - temp_chi) / scale
            accept = (rho_val > 0) & (scale > 0) & jnp.isfinite(temp_chi)
            alpha = jnp.minimum(1.0 - (2.0 * rho_val - 1.0) ** 3, 2.0 / 3.0)
            lam_acc = lam * jnp.maximum(1.0 / 3.0, alpha)
            Tn = [jnp.where(accept, cand[k], Tc[k]) for k in range(12)]
            chi_n = jnp.where(accept, temp_chi, chi)
            false_n = jnp.where(accept, 0, false_cnt + 1)
            outer_done = accept | (false_n >= false_cnt_threshold)
            stop_n = outer_done & (last_chi - chi_n < diff_chi_threshold)
            return (
                Tn, chi_n, jnp.where(outer_done, chi_n, last_chi),
                jnp.where(accept, lam_acc, lam * ni),
                jnp.where(accept, 2.0, ni * 2.0),
                jnp.where(outer_done, it + 1, it),
                jnp.where(outer_done, 0, false_n),
                stop_n,
            )

        st0 = (T0, chi0, jnp.asarray(1e20, f32), lam0, jnp.asarray(2.0, f32),
               jnp.int32(0), jnp.int32(0), jnp.bool_(False))
        T = jax.lax.while_loop(cond, body, st0)[0]

        # Reclassify by per-edge robust chi2 (lm.pose_edge_chi2: unmasked).
        ru, rv, _, _ = edge_terms(T)
        chis, _, _ = huber(ru * ru + rv * rv, robust)
        outlier = jnp.where(chis > chi2_th, 1.0, 0.0)

    for k in range(12):
        T_out[k] = T[k]
    inlier_out[...] = (valid * (1.0 - outlier)).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=(
        "chi2_th", "iterations", "outer_iterations", "drop_kernel_after",
        "exclude_outliers", "tau", "max_diag_cap", "diff_chi_threshold",
        "false_cnt_threshold", "interpret",
    ),
)
def estimate_pose_pallas(
    intrinsics: jnp.ndarray,
    T_init: jnp.ndarray,
    p_world: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    chi2_th: float = 5.991,
    iterations: int = 10,
    outer_iterations: int = 4,
    drop_kernel_after: int = 2,
    exclude_outliers: bool = True,
    tau: float = 1e-5,
    max_diag_cap: float = 5e10,
    diff_chi_threshold: float = 1e-5,
    false_cnt_threshold: int = 10,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in for solver/lm.py estimate_pose with the default LM strategy.

    intrinsics: (4,) [fx, fy, cx, cy]; T_init (4, 4); p_world (E, 3);
    uv (E, 2); valid (E,).  Returns (T, inlier (E,), n_inliers).
    """
    E = p_world.shape[0]
    Ep = 1 << max(E - 1, 0).bit_length()
    f32 = jnp.float32

    def vec(x):
        return jnp.pad(x.astype(f32), (0, Ep - E))

    params = jnp.concatenate([
        intrinsics.astype(f32), T_init[:3].reshape(12).astype(f32), jnp.zeros((16,), f32)
    ])
    kernel = functools.partial(
        _pose_kernel,
        chi2_th=float(chi2_th), iterations=int(iterations),
        outer_iterations=int(outer_iterations),
        drop_kernel_after=int(drop_kernel_after),
        exclude_outliers=bool(exclude_outliers), tau=float(tau),
        max_diag_cap=float(max_diag_cap),
        diff_chi_threshold=float(diff_chi_threshold),
        false_cnt_threshold=int(false_cnt_threshold),
    )
    T12, inlier = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((16,), f32),
            jax.ShapeDtypeStruct((Ep,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="estimate_pose",
    )(
        vec(p_world[:, 0]), vec(p_world[:, 1]), vec(p_world[:, 2]),
        vec(uv[:, 0]), vec(uv[:, 1]), jnp.pad(valid.astype(jnp.int32), (0, Ep - E)),
        params,
    )
    T = jnp.concatenate([T12[:12].reshape(3, 4), jnp.asarray([[0.0, 0.0, 0.0, 1.0]], f32)])
    inlier = inlier[:E] != 0
    return T.astype(T_init.dtype), inlier, jnp.sum(inlier.astype(jnp.int32))
