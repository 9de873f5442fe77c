"""Levenberg-Marquardt driver as a functional `lax.while_loop`.

Re-designs `lego::Problem::solve` (src/lego/base/problem.cpp:156-230) and its
helpers: lambda initialization from the Hessian diagonal (:470-504), the
Nielsen "default" update and the multiplicative "strategy1" update
(:520-581), the inner try-lambda loop with rollback (:189-206, false count
threshold 10), and the chi-difference stop rule (:210-218).

The object-graph solve loop becomes a single while_loop whose body performs
one lambda attempt; accepted steps rebuild the normal equations at the new
linearization point (the reference's `buildHessian` call at :199), rejected
ones keep the old blocks (the functional equivalent of `rollbackStates`).

Two instantiations are provided: full pose+landmark BA over a `schur.BAGraph`
(used by the backend) and a motion-only pose solve (used by the frontend's
`EstimateCurrentPose`).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.geometry import se3
from legoslam.solver import reprojection, robust, schur


class LMConfig(NamedTuple):
    iterations: int = 10
    strategy: str = "default"        # "default" (Nielsen) | "strategy1"
    tau: float = 1e-5                # problem.cpp:495
    diff_chi_threshold: float = 1e-5  # problem.h:165
    false_cnt_threshold: int = 10    # problem.cpp:178
    init_lambda: float = -1.0        # <0: compute from Hessian diagonal
    max_diag_cap: float = 5e10       # problem.cpp:494
    linear_solver: str = "cholesky"  # "cholesky" | "pcg" (problem.cpp:377-422)
    trace: bool = False              # record per-iteration (chi, lambda) like
                                     # the reference's solve printout
                                     # (problem.cpp:180-184)
    # "f32" | "bf16": precision of the landmark-axis assembly contractions
    # (edge_soa.soa_build assembly_dtype — see its docstring).  Affects only
    # the model Hessian; chi and the accept/rollback loop stay f32.
    assembly_precision: str = "f32"


class LMFunctions(NamedTuple):
    """Problem-specific callbacks over an opaque state pytree.

    build(state) -> aux (assembled normal equations; must contain what solve/
      dot_scale/max_diag need), chi(state) -> scalar 0.5*robust-chi2,
    solve(aux, lam) -> dx pytree, retract(state, dx) -> state,
    dot_scale(aux, dx, lam) -> scalar denominator of rho,
    max_diag(aux) -> scalar max |H_ii|.
    """

    build: Callable[[Any], Any]
    chi: Callable[[Any], jnp.ndarray]
    solve: Callable[[Any, jnp.ndarray], Any]
    retract: Callable[[Any, Any], Any]
    dot_scale: Callable[[Any, Any, jnp.ndarray], jnp.ndarray]
    max_diag: Callable[[Any], jnp.ndarray]
    # Optional fused chi_build(state) -> (chi, aux): when the problem can
    # produce the assembled system and the robust chi from ONE residual
    # sweep (edge_soa.soa_build(with_chi=True)), the driver evaluates each
    # candidate with a single sweep and keeps the assembly if accepted,
    # instead of a chi sweep followed by a build sweep.  Rejected attempts
    # then waste the Jacobian part of the sweep, but acceptance dominates in
    # practice and the edge sweeps are op-bound, not FLOP-bound (PROFILE.md).
    chi_build: Any = None


class LMResult(NamedTuple):
    state: Any
    chi: jnp.ndarray
    lam: jnp.ndarray
    iterations: jnp.ndarray
    attempts: jnp.ndarray
    # (iterations, 2) per-outer-iteration [chi, lambda] when LMConfig.trace,
    # else (0, 2) — the reference's "iter/chi/lambda" solve log
    # (problem.cpp:180-184) as data instead of stdout.
    trace: jnp.ndarray = jnp.zeros((0, 2))


def lm_optimize(fns: LMFunctions, state0: Any, cfg: LMConfig) -> LMResult:
    dtype = jnp.result_type(*[x for x in jax.tree_util.tree_leaves(state0)])
    if fns.chi_build is not None:
        chi0, aux0 = fns.chi_build(state0)
    else:
        aux0 = fns.build(state0)
        chi0 = fns.chi(state0)

    if cfg.strategy == "strategy1":
        lam0 = jnp.asarray(1e-5, dtype)  # problem.cpp:500-503
    elif cfg.init_lambda >= 0:
        lam0 = jnp.asarray(cfg.init_lambda, dtype)
    else:
        max_diag = jnp.minimum(fns.max_diag(aux0), jnp.asarray(cfg.max_diag_cap, dtype))
        lam0 = jnp.asarray(cfg.tau, dtype) * max_diag

    carry0 = dict(
        state=state0,
        aux=aux0,
        chi=chi0,
        last_chi=jnp.asarray(1e20, dtype),
        lam=lam0,
        ni=jnp.asarray(2.0, dtype),
        it=jnp.asarray(0, jnp.int32),
        false_cnt=jnp.asarray(0, jnp.int32),
        attempts=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(False),
        trace=jnp.full((cfg.iterations if cfg.trace else 0, 2), jnp.nan, dtype),
    )

    def cond(c):
        return (~c["stop"]) & (c["it"] < cfg.iterations)

    def body(c):
        with jax.named_scope("lm_linear_solve"):
            dx = fns.solve(c["aux"], c["lam"])
        with jax.named_scope("lm_retract"):
            cand = fns.retract(c["state"], dx)
        if fns.chi_build is not None:
            with jax.named_scope("lm_chi_build"):
                temp_chi, aux_cand = fns.chi_build(cand)
        else:
            temp_chi = fns.chi(cand)
            aux_cand = None
        scale = fns.dot_scale(c["aux"], dx, c["lam"]) + jnp.asarray(1e-10, dtype)
        rho_val = (c["chi"] - temp_chi) / scale
        # `scale` is the predicted cost decrease 0.5 dx^T(lam dx + b); for an
        # exact solve of a PSD system it is >= 0, but when the f32 linear
        # solve of an ill-conditioned H produces a garbage dx at small lambda,
        # it can come out NEGATIVE — and `rho_val > 0` alone would then accept
        # a chi-INCREASING step (observed: a 46-pose graph chain jumping chi
        # 7.2 -> 395 on one thread partitioning and converging on another).
        # Requiring scale > 0 restores monotone descent: junk steps are
        # rejected, lambda grows, and the better-conditioned damped system
        # produces a real step.  (problem.cpp:520-545 has the same latent
        # flaw in f64, where it never fires.)
        accept = (rho_val > 0) & (scale > 0) & jnp.isfinite(temp_chi)

        if cfg.strategy == "strategy1":
            lam_acc = jnp.maximum(c["lam"] / 9.0, 1e-7)   # problem.cpp:569-571
            lam_rej = jnp.minimum(c["lam"] * 11.0, 1e7)   # problem.cpp:576
            ni_acc, ni_rej = c["ni"], c["ni"]
        else:
            alpha = 1.0 - (2.0 * rho_val - 1.0) ** 3       # problem.cpp:541-544
            alpha = jnp.minimum(alpha, 2.0 / 3.0)
            factor = jnp.maximum(jnp.asarray(1.0 / 3.0, dtype), alpha)
            lam_acc = c["lam"] * factor
            ni_acc = jnp.asarray(2.0, dtype)
            lam_rej = c["lam"] * c["ni"]
            ni_rej = c["ni"] * 2.0

        # Accepted step re-linearizes (problem.cpp:199); rejected keeps blocks
        # (the functional rollback).
        if fns.chi_build is not None:
            # The candidate's assembly already exists — just select it.
            state_n, aux_n = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b),
                (cand, aux_cand), (c["state"], c["aux"]),
            )
        else:
            state_n, aux_n = jax.lax.cond(
                accept,
                lambda: (cand, fns.build(cand)),
                lambda: (c["state"], c["aux"]),
            )
        chi_n = jnp.where(accept, temp_chi, c["chi"])
        false_n = jnp.where(accept, 0, c["false_cnt"] + 1)
        exhausted = false_n >= cfg.false_cnt_threshold
        outer_done = accept | exhausted
        it_n = c["it"] + jnp.where(outer_done, 1, 0).astype(jnp.int32)
        # Chi-difference stop rule, evaluated when an outer iteration completes
        # (problem.cpp:210-218). An exhausted inner loop leaves chi unchanged
        # only if a previous outer iteration already ran; mirroring the
        # reference, the comparison uses last_chi from the previous outer step.
        stop_n = outer_done & (c["last_chi"] - chi_n < cfg.diff_chi_threshold)
        last_chi_n = jnp.where(outer_done, chi_n, c["last_chi"])
        trace_n = c["trace"]
        if cfg.trace:
            row = jnp.stack([chi_n, c["lam"]]).astype(trace_n.dtype)
            idx = jnp.clip(c["it"], 0, cfg.iterations - 1)
            trace_n = jnp.where(
                outer_done, trace_n.at[idx].set(row), trace_n
            )
        return dict(
            state=state_n,
            aux=aux_n,
            chi=chi_n,
            last_chi=last_chi_n,
            lam=jnp.where(accept, lam_acc, lam_rej),
            ni=jnp.where(accept, ni_acc, ni_rej),
            it=it_n,
            false_cnt=jnp.where(outer_done, 0, false_n).astype(jnp.int32),
            attempts=c["attempts"] + 1,
            stop=stop_n,
            trace=trace_n,
        )

    out = jax.lax.while_loop(cond, body, carry0)
    return LMResult(state=out["state"], chi=out["chi"], lam=out["lam"],
                    iterations=out["it"], attempts=out["attempts"],
                    trace=out["trace"])


# ---------------------------------------------------------------------------
# Full bundle adjustment (pose + landmark), reference backend problem
# ---------------------------------------------------------------------------

class BAState(NamedTuple):
    poses: jnp.ndarray   # (K, 4, 4)
    points: jnp.ndarray  # (L, 3)


def solve_ba(
    graph: schur.BAGraph,
    poses: jnp.ndarray,
    points: jnp.ndarray,
    *,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
    cfg: LMConfig = LMConfig(),
    engine: str = "soa",
    pose_prior=None,
) -> Tuple[BAState, LMResult]:
    """Sliding-window BA: the batched equivalent of `Backend::Optimize`'s
    `problem.solve(10)` call (backend_lego.cpp:161) over the active window.

    engine="soa" uses the component-major fast path (solver/edge_soa.py);
    "blocks" keeps the original block-tensor pipeline (solver/schur.py).
    Both produce the same optimum (tests/test_edge_soa.py).

    pose_prior: optional (sqrt_J (6K, 6K), err0 (6K,), T_lin (K, 4, 4)) —
    a linearized marginalization prior on the poses (problem.cpp:338-355):
    residual r_p(x) = err0 + sqrt_J * log(T x T_lin^-1), added to the reduced
    pose system each iteration with the first-order b update of
    problem.cpp:447-453.  SoA engine only.
    """
    if engine == "soa":
        return _solve_ba_soa(
            graph, poses, points, kernel=kernel, delta=delta, cfg=cfg,
            pose_prior=pose_prior,
        )
    if pose_prior is not None:
        raise NotImplementedError("pose_prior requires engine='soa'")

    def build(st: BAState):
        blocks = schur.build_blocks(graph, st.poses, st.points, kernel, delta)
        diag = jnp.concatenate(
            [
                jnp.diagonal(blocks.Hpp, axis1=-2, axis2=-1).reshape(-1),
                jnp.diagonal(blocks.Hll, axis1=-2, axis2=-1).reshape(-1),
            ]
        )
        return (blocks, diag)

    def chi_fn(st: BAState):
        return schur.robust_chi(graph, st.poses, st.points, kernel, delta)

    def solve_fn(aux, lam):
        blocks, _ = aux
        S, bs, Hll_inv = schur.schur_reduce(blocks, graph.point_valid, lam, cfg.strategy)
        dx_p = schur.damp_and_solve(S, bs, lam, cfg.strategy, method=cfg.linear_solver)
        dx_l = schur.back_substitute(blocks, Hll_inv, dx_p)
        return (dx_p.reshape(-1, 6), dx_l)

    def retract_fn(st: BAState, dx):
        dx_p, dx_l = dx
        poses_n = se3.retract(st.poses, dx_p)
        # VertexXYZ::add NaN/Inf guard (lego_types.h:105-112)
        finite = jnp.all(jnp.isfinite(dx_l), axis=-1, keepdims=True)
        points_n = st.points + jnp.where(finite & graph.point_valid[:, None], dx_l, 0.0)
        return BAState(poses=poses_n, points=points_n)

    def dot_scale(aux, dx, lam):
        # 0.5 dx^T (lam * dx + b) over the full [pose; landmark] vector
        # (problem.cpp:535); strategy1 uses lam * diag(H) * dx (:564).
        blocks, diag = aux
        dx_p, dx_l = dx
        flat = jnp.concatenate([dx_p.reshape(-1), dx_l.reshape(-1)])
        b = jnp.concatenate([blocks.bp.reshape(-1), blocks.bl.reshape(-1)])
        if cfg.strategy == "strategy1":
            return 0.5 * jnp.dot(flat, lam * diag * flat + b)
        return 0.5 * jnp.dot(flat, lam * flat + b)

    def max_diag(aux):
        _, diag = aux
        return jnp.max(jnp.abs(diag))

    fns = LMFunctions(build=build, chi=chi_fn, solve=solve_fn,
                      retract=retract_fn, dot_scale=dot_scale, max_diag=max_diag)
    res = lm_optimize(fns, BAState(poses=poses, points=points), cfg)
    return res.state, res


def _solve_ba_soa(
    graph: schur.BAGraph,
    poses: jnp.ndarray,
    points: jnp.ndarray,
    *,
    kernel: str,
    delta: float,
    cfg: LMConfig,
    pose_prior=None,
) -> Tuple[BAState, LMResult]:
    """solve_ba on the component-major engine (see solver/edge_soa.py)."""
    from legoslam.solver import edge_soa

    gs = edge_soa.make_soa_graph(graph)
    asm_dtype = jnp.bfloat16 if cfg.assembly_precision == "bf16" else None

    if pose_prior is not None:
        prior_J, prior_err0, prior_T = pose_prior
        prior_H = prior_J.T @ prior_J
        T_lin_inv = se3.se3_inv(prior_T)

        def prior_res(st: BAState) -> jnp.ndarray:
            # r_p = err0 + J * dx with dx the manifold offset from the
            # linearization poses, matching retract's exp(dx)*T convention.
            dx = se3.se3_log(st.poses @ T_lin_inv).reshape(-1)
            return prior_err0 + prior_J @ dx
    else:
        prior_H = None

    def build(st: BAState):
        blocks = edge_soa.soa_build(
            gs, st.poses, st.points, kernel, delta, assembly_dtype=asm_dtype
        )
        # First-order prior b at this linearization: -J^T r_p  (the running
        # update of problem.cpp:447-453, recomputed exactly instead).
        bprior = -(prior_J.T @ prior_res(st)) if prior_H is not None else None
        return (blocks, edge_soa.soa_blocks_diag(blocks), bprior)

    def chi_fn(st: BAState):
        chi = edge_soa.soa_robust_chi(gs, st.poses, st.points, kernel, delta)
        if prior_H is not None:
            r = prior_res(st)
            chi = chi + 0.5 * jnp.dot(r, r)
        return chi

    def chi_build(st: BAState):
        # One edge sweep yields both the candidate chi and its assembly.
        blocks, chi = edge_soa.soa_build(
            gs, st.poses, st.points, kernel, delta, with_chi=True,
            assembly_dtype=asm_dtype,
        )
        bprior = None
        if prior_H is not None:
            r = prior_res(st)
            chi = chi + 0.5 * jnp.dot(r, r)
            bprior = -(prior_J.T @ r)
        return chi, (blocks, edge_soa.soa_blocks_diag(blocks), bprior)

    def solve_fn(aux, lam):
        blocks, _, bprior = aux
        S, bs, Hll_inv = edge_soa.soa_schur_reduce(blocks, graph.point_valid, lam, cfg.strategy)
        if prior_H is not None:
            S = S + prior_H
            bs = bs + bprior
        dx_p = schur.damp_and_solve(S, bs, lam, cfg.strategy, method=cfg.linear_solver)
        dx_l = edge_soa.soa_back_substitute(blocks, Hll_inv, dx_p)
        return (dx_p.reshape(-1, 6), dx_l)

    def retract_fn(st: BAState, dx):
        dx_p, dx_l = dx
        poses_n = se3.retract(st.poses, dx_p)
        finite = jnp.all(jnp.isfinite(dx_l), axis=-1, keepdims=True)
        points_n = st.points + jnp.where(finite & graph.point_valid[:, None], dx_l, 0.0)
        return BAState(poses=poses_n, points=points_n)

    def dot_scale(aux, dx, lam):
        blocks, diag, bprior = aux
        dx_p, dx_l = dx
        flat = jnp.concatenate([dx_p.reshape(-1), dx_l.reshape(-1)])
        bp = blocks.bp.T.reshape(-1)
        if prior_H is not None:
            bp = bp + bprior
        b = jnp.concatenate([bp, blocks.bl.T.reshape(-1)])
        if cfg.strategy == "strategy1":
            return 0.5 * jnp.dot(flat, lam * diag * flat + b)
        return 0.5 * jnp.dot(flat, lam * flat + b)

    def max_diag(aux):
        return jnp.max(jnp.abs(aux[1]))

    fns = LMFunctions(build=build, chi=chi_fn, solve=solve_fn,
                      retract=retract_fn, dot_scale=dot_scale, max_diag=max_diag,
                      chi_build=chi_build)
    res = lm_optimize(fns, BAState(poses=poses, points=points), cfg)
    return res.state, res


# ---------------------------------------------------------------------------
# Motion-only pose solve (single pose, landmarks fixed), frontend problem
# ---------------------------------------------------------------------------

def solve_pose(
    intr: reprojection.Intrinsics,
    T_init: jnp.ndarray,
    p_world: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
    cfg: LMConfig = LMConfig(),
) -> Tuple[jnp.ndarray, LMResult]:
    """Motion-only BA over `EdgeProjectionPoseOnly` edges: one `problem.solve(10)`
    round of the frontend (frontend_lego.cpp:157-225). Outlier handling and the
    4-round loop live in the frontend, which calls this per round."""

    def terms(T):
        r, Jp = reprojection.pose_only_edge(intr, T, p_world, uv)
        r = jnp.where(valid[:, None], r, 0.0)
        return r, Jp

    def build(T):
        r, Jp = terms(T)
        drho, W = robust.robust_information(kernel, r, delta)
        W = jnp.where(valid[:, None, None], W, 0.0)
        drho = jnp.where(valid, drho, 0.0)
        JpW = jnp.einsum("eia,eij->eaj", Jp, W)
        H = jnp.einsum("eaj,ejb->ab", JpW, Jp)
        b = -jnp.einsum("e,eia,ei->a", drho, Jp, r)
        return (H, b)

    def chi_fn(T):
        r, _ = terms(T)
        chis = robust.robust_chi2(kernel, r, delta)
        return 0.5 * jnp.sum(jnp.where(valid, chis, 0.0))

    def solve_fn(aux, lam):
        H, b = aux
        diag = jnp.diagonal(H)
        if cfg.strategy == "strategy1":
            damped = diag + lam * diag
        else:
            damped = diag + lam
        damped = damped + jnp.where(jnp.abs(diag) <= 1e-12, 1.0, 0.0)
        Hd = H.at[jnp.arange(6), jnp.arange(6)].set(damped)
        return jnp.linalg.solve(Hd, b)

    def retract_fn(T, dx):
        return se3.retract(T, dx)

    def dot_scale(aux, dx, lam):
        H, b = aux
        if cfg.strategy == "strategy1":
            return 0.5 * jnp.dot(dx, lam * jnp.diagonal(H) * dx + b)
        return 0.5 * jnp.dot(dx, lam * dx + b)

    def max_diag(aux):
        H, _ = aux
        return jnp.max(jnp.abs(jnp.diagonal(H)))

    fns = LMFunctions(build=build, chi=chi_fn, solve=solve_fn,
                      retract=retract_fn, dot_scale=dot_scale, max_diag=max_diag)
    res = lm_optimize(fns, T_init, cfg)
    return res.state, res


def pose_edge_chi2(intr, T, p_world, uv, kernel: str, delta: float) -> jnp.ndarray:
    """Per-edge robust chi2 for outlier classification (frontend_lego.cpp:214-223)."""
    r, _ = reprojection.pose_only_edge(intr, T, p_world, uv)
    return robust.robust_chi2(kernel, r, delta)


def estimate_pose(
    intr: reprojection.Intrinsics,
    T_init: jnp.ndarray,
    p_world: jnp.ndarray,
    uv: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    chi2_th: float = 5.991,
    outer_iterations: int = 4,
    drop_kernel_after: int = 2,
    exclude_outliers: bool = True,
    cfg: LMConfig = LMConfig(),
):
    """Full `Frontend::EstimateCurrentPose` (frontend_lego.cpp:157-258,
    frontend_g2o.cpp:157-245): `outer_iterations` rounds of {reset pose to the
    prior, run one LM solve, reclassify outliers by robust chi2 > chi2_th};
    the Huber kernel is dropped after round `drop_kernel_after` (both variants
    strip it when `iteration == 2`).

    `exclude_outliers=True` reproduces the default (g2o) build, which removes
    outlier edges from the problem via setLevel (frontend_g2o.cpp:216-221);
    False reproduces the lego variant, which keeps them Huber-weighted.

    Returns (T, inlier_mask (E,), num_inliers). `inlier_mask` is over the
    valid edges only; invalid lanes are False.
    """
    outlier = jnp.zeros(valid.shape, bool)
    T = T_init
    for it in range(outer_iterations):
        kernel = robust.HUBER if it <= drop_kernel_after else robust.TRIVIAL
        use = valid & (~outlier) if exclude_outliers else valid
        T, _ = solve_pose(intr, T_init, p_world, uv, use, kernel=kernel, delta=chi2_th, cfg=cfg)
        chis = pose_edge_chi2(intr, T, p_world, uv, kernel, chi2_th)
        outlier = chis > chi2_th
    inlier = valid & (~outlier)
    return T, inlier, jnp.sum(inlier.astype(jnp.int32))
