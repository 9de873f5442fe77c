"""Backend: sliding-window bundle adjustment over the active map.

Re-designs `Backend` (src/backend_lego.cpp, include/legoslam/backend.h).  The
reference runs a dedicated thread that wakes on a condition variable,
snapshots the active keyframes/landmarks under the map mutex, optimizes, and
writes results back through per-object locks.  Here the whole cycle is one
pure function `ba_step(map) -> (map', stats)` over the fixed-shape world
state: snapshot is free (functional state), the graph is built by masked
gathers, and write-back is a scatter — scheduling (when to run, on which
device, overlapped how) is the caller's concern (pipeline/visual_odometry.py
runs it in dispatch order; parallel/dist_ba.py shards it across a mesh).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.geometry import se3
from legoslam.geometry.camera import StereoRig
from legoslam.solver import edge_soa
from legoslam.solver import lm as lm_ops
from legoslam.solver import reprojection, robust, schur
from legoslam.pipeline.frontend import FrontendConfig, _intr
from legoslam.pipeline.state import WorldMap
from legoslam.utils.jax_setup import full_f32_matmuls


class BAConfig(NamedTuple):
    iterations: int = 10          # problem.solve(10), backend_lego.cpp:161
    chi2_threshold: float = 5.991
    max_chi2_doublings: int = 5   # backend_lego.cpp:166
    inlier_ratio: float = 0.5
    strategy: str = "default"
    linear_solver: str = "cholesky"
    engine: str = "soa"  # "soa" (component-major fast path) | "blocks"
    trace: bool = False  # record the per-iteration chi/lambda solve trace
    # "bf16" runs the big assembly contractions with bf16 operands and f32
    # accumulation (edge_soa.soa_build assembly_dtype); chi/rollback stay f32.
    assembly_precision: str = "f32"


class BAStats(NamedTuple):
    chi: jnp.ndarray
    iterations: jnp.ndarray
    n_outlier: jnp.ndarray
    n_inlier: jnp.ndarray
    n_active_landmarks: jnp.ndarray
    n_dropped_landmarks: jnp.ndarray  # active landmarks beyond capacity (not optimized)
    lam: jnp.ndarray = jnp.asarray(jnp.nan)      # final LM damping
    trace: jnp.ndarray = jnp.zeros((0, 2))       # per-iteration [chi, lambda] if traced


class BAProblem(NamedTuple):
    """A BA problem extracted from the world state (device arrays only)."""

    graph: schur.BAGraph
    poses: jnp.ndarray        # (KW, 4, 4)
    points: jnp.ndarray       # (LA, 3)
    active_ids: jnp.ndarray   # (LA,) global landmark ids (-1 = empty slot)
    e_src: jnp.ndarray        # (EB,) source index into the (2, KW, NF) obs grid


class BAResult(NamedTuple):
    """The outcome of one window solve, *detached* from the world state.

    This is the equivalent of the data the reference's backend thread
    carries out of Optimize (backend_lego.cpp:56-218): optimized poses and
    points plus the outlier verdicts, tagged with enough snapshot identity
    (keyframe ids, landmark ids) that `merge_ba_result` can write them back
    into a map that has *moved on* since the snapshot — the asynchronous
    schedule (pipeline/async_backend.py) runs tracking frames between the
    solve and the write-back, exactly like the reference's frontend does not
    wait for its backend (backend_lego.cpp:38-54).
    """

    # --- snapshot identity ---
    kf_id: jnp.ndarray        # (KW,) keyframe id per slot at snapshot (-1 empty)
    kf_frame_id: jnp.ndarray  # (KW,) source frame id (guards kf-id reuse after Reset)
    active_ids: jnp.ndarray   # (LA,) global landmark ids optimized (-1 empty)
    point_valid: jnp.ndarray  # (LA,) landmark slot participated in the solve
    # --- optimized values ---
    poses: jnp.ndarray        # (KW, 4, 4)
    points: jnp.ndarray       # (LA, 3)
    # --- outlier verdicts on the snapshot's (KW, NF) observation grids ---
    out_l: jnp.ndarray        # (KW, NF) bool
    out_r: jnp.ndarray        # (KW, NF) bool
    stats: "BAStats"
    # (info_S, info_b, info_T, info_kf_id): the window's pose information at
    # the optimum (Schur-reduced, prior included) for use_marg_prior — the
    # matrix the next eviction marginalizes.  None when the flag is off.
    info: Any = None


def build_problem(cfg: FrontendConfig, rig: StereoRig, wmap: WorldMap) -> Tuple[BAProblem, jnp.ndarray]:
    """Snapshot the active window into a `schur.BAGraph`.

    Mirrors the graph built in Backend::Optimize (backend_lego.cpp:63-158):
    one pose vertex per active keyframe, one landmark vertex per active
    landmark, and one projection edge per registered observation, with the
    left/right extrinsic chosen per observation.

    Layout notes: the landmark vertex set is derived from the window's
    observation grid itself (sort + dedupe over KW*NF entries, searchsorted
    lookups) rather than scanning the global landmark table — the table holds
    2^17 slots and a nonzero/scatter over it costs more than the whole Schur
    solve.  Edges are validity-compacted to `caps.ba_edges` lanes so the
    per-LM-iteration segment-sums touch a fraction of the (2*KW*NF) grid.
    """
    caps = cfg.caps
    KW, NF, LA = caps.window, caps.max_features, caps.active_landmarks
    EB = caps.ba_edges

    # --- one argsort does everything -----------------------------------------
    # Sorting the (2*KW*NF) observation grid by a hashed landmark key
    # simultaneously (a) compacts valid edges to the front, (b) groups them by
    # landmark so unique actives are segment boundaries, and (c) yields each
    # edge's active slot as the running unique count — replacing the previous
    # sort + argsort + searchsorted trio with a single sort pass.
    #
    # The key is a *bijective* hash of the landmark id (odd-multiplier mod
    # 2^32), not the raw id: when the window exceeds the edge/landmark budget,
    # sorting by raw id would systematically drop the newest landmarks — the
    # exact ones keeping the latest keyframes constrained.  The hash spreads
    # the over-budget drop uniformly across landmark ages instead.  Bijective
    # means equal-key <=> equal-id, so segment grouping is unaffected.
    kf_ok = jnp.repeat(wmap.kf_valid, NF)
    lm_flat = wmap.kf_lm.reshape(-1)
    base_ok = kf_ok & (lm_flat >= 0)
    valid_g = jnp.concatenate(
        [base_ok & wmap.kf_obs_left.reshape(-1), base_ok & wmap.kf_obs_right.reshape(-1)]
    )
    lm2 = jnp.tile(lm_flat, 2)
    # Preimage of the 0xFFFFFFFF invalid sentinel under this hash is
    # 4050964655 (= 0xFFFFFFFF * 244002641 mod 2^32) — far above any id.
    assert caps.landmarks < 4050964655
    INVALID = jnp.uint32(0xFFFFFFFF)
    h = lm2.astype(jnp.uint32) * jnp.uint32(2654435761)
    key = jnp.where(valid_g, h, INVALID)
    order = jnp.argsort(key, stable=True)[:EB]
    s = key[order]                       # (EB,) sorted hashed ids
    lm_s = lm2[order]                    # (EB,) landmark id per sorted edge
    e_valid = s < INVALID
    n_edges = jnp.sum(valid_g.astype(jnp.int32))
    n_edge_drop = jnp.maximum(n_edges - EB, 0)

    is_first = (
        jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]]) & e_valid
    )
    slot = jnp.cumsum(is_first.astype(jnp.int32)) - 1     # active slot per edge
    overflow = slot >= LA
    e_valid = e_valid & ~overflow
    e_point = jnp.clip(slot, 0, LA - 1)
    n_active = jnp.sum((is_first & ~overflow).astype(jnp.int32))
    n_dropped = jnp.sum((is_first & overflow).astype(jnp.int32)) + n_edge_drop

    tgt = jnp.where(is_first & ~overflow, slot, LA)
    active_ids = jnp.full((LA + 1,), -1, jnp.int32).at[tgt].set(lm_s)[:LA]
    point_valid = active_ids >= 0
    points = wmap.lm_pos[jnp.maximum(active_ids, 0)]

    # Per-edge pose/cam/uv through the same permutation.
    e_pose_g = jnp.tile(jnp.repeat(jnp.arange(KW, dtype=jnp.int32), NF), 2)
    e_cam_g = jnp.repeat(jnp.arange(2, dtype=jnp.int32), KW * NF)
    e_uv_g = jnp.concatenate([wmap.kf_uv.reshape(-1, 2), wmap.kf_uv_r.reshape(-1, 2)])

    graph = schur.BAGraph(
        e_pose=e_pose_g[order],
        e_point=e_point,
        e_cam=e_cam_g[order],
        e_uv=e_uv_g[order],
        e_valid=e_valid,
        exts=jnp.stack([rig.left.pose, rig.right.pose]),
        intr=_intr(rig),
        pose_fixed=~wmap.kf_valid,
        point_valid=point_valid,
    )
    problem = BAProblem(
        graph=graph, poses=wmap.kf_pose, points=points, active_ids=active_ids, e_src=order
    )
    return problem, jnp.stack([n_active, n_dropped])


def adaptive_chi2_threshold(
    chis: jnp.ndarray, e_valid: jnp.ndarray, ba_cfg: BAConfig
) -> jnp.ndarray:
    """Double the chi2 outlier threshold until the inlier ratio exceeds 0.5,
    at most max_chi2_doublings times (backend_lego.cpp:164-184)."""
    n_valid = jnp.sum(e_valid.astype(jnp.int32))

    def cond(c):
        th, it = c
        n_in = jnp.sum((e_valid & (chis <= th)).astype(jnp.int32))
        ratio = n_in.astype(chis.dtype) / jnp.maximum(n_valid, 1).astype(chis.dtype)
        return (ratio <= ba_cfg.inlier_ratio) & (it < ba_cfg.max_chi2_doublings)

    def body(c):
        th, it = c
        return th * 2.0, it + 1

    th, _ = jax.lax.while_loop(
        cond, body, (jnp.asarray(ba_cfg.chi2_threshold, chis.dtype), jnp.asarray(0, jnp.int32))
    )
    return th


@full_f32_matmuls
def solve_window(
    cfg: FrontendConfig,
    rig: StereoRig,
    wmap: WorldMap,
    ba_cfg: BAConfig = BAConfig(),
    solve_fn=None,
) -> BAResult:
    """Snapshot -> LM solve -> adaptive outlier classification, *without*
    write-back (Backend::Optimize up to backend_lego.cpp:194).

    `solve_fn(graph, poses, points, lm_cfg) -> (BAState, LMResult)` can be
    injected to swap the single-chip solver for the mesh-sharded one
    (parallel/dist_ba.py).  The returned `BAResult` is applied with
    `merge_ba_result` — immediately (`ba_step`) or after tracking has moved on
    (pipeline/async_backend.py).
    """
    with jax.named_scope("ba_build_problem"):
        problem, counts = build_problem(cfg, rig, wmap)
    lm_cfg = lm_ops.LMConfig(
        iterations=ba_cfg.iterations, strategy=ba_cfg.strategy,
        linear_solver=ba_cfg.linear_solver, trace=ba_cfg.trace,
        assembly_precision=ba_cfg.assembly_precision,
    )

    # Marginalization prior on the window poses (problem.cpp:338-355): mask
    # the stored sqrt-form prior onto the slots that still hold the keyframes
    # it was built for, and weight it (use_marg_prior).
    pose_prior = None
    if cfg.use_marg_prior:
        if solve_fn is not None:
            raise ValueError("use_marg_prior is not supported with an injected solve_fn")
        mg = wmap.marg
        dtype = wmap.kf_pose.dtype
        slot_ok = wmap.kf_valid & (mg.prior_kf_id >= 0) & (wmap.kf_id == mg.prior_kf_id)
        m6 = jnp.repeat(slot_ok, 6).astype(dtype)
        w = jnp.asarray(cfg.marg_prior_weight, dtype) ** 0.5
        prior_J = mg.prior_J * m6[None, :] * w   # zero cols: no pull on recycled slots
        prior_err = mg.prior_err * w
        # Masked slots linearize at their own current pose => dx = 0 there.
        T_lin = jnp.where(slot_ok[:, None, None], mg.prior_T, wmap.kf_pose)
        pose_prior = (prior_J, prior_err, T_lin)

    if solve_fn is None:
        with jax.named_scope("ba_lm_solve"):
            state, res = lm_ops.solve_ba(
                problem.graph, problem.poses, problem.points,
                kernel=robust.HUBER, delta=ba_cfg.chi2_threshold, cfg=lm_cfg,
                engine=ba_cfg.engine, pose_prior=pose_prior,
            )
    else:
        state, res = solve_fn(problem.graph, problem.poses, problem.points, lm_cfg)
        if ba_cfg.trace and res.trace.shape[0] != ba_cfg.iterations:
            # Injected solvers may not record a trace; keep the output pytree
            # shape stable for the caller's lax.cond branches.
            res = res._replace(
                trace=jnp.full((ba_cfg.iterations, 2), jnp.nan, problem.poses.dtype)
            )

    # Outlier classification at the optimized state (robust chi2 per edge).
    with jax.named_scope("ba_outliers"):
        gs = edge_soa.make_soa_graph(problem.graph, assembly=False)
        chis = edge_soa.soa_edge_chi2(gs, state.poses, state.points, robust.HUBER, ba_cfg.chi2_threshold)
        e_valid = schur.edge_mask(problem.graph)
        th = adaptive_chi2_threshold(chis, e_valid, ba_cfg)
    outlier_edge = e_valid & (chis > th)
    n_out = jnp.sum(outlier_edge.astype(jnp.int32))
    n_in = jnp.sum(e_valid.astype(jnp.int32)) - n_out

    # Scatter the compacted edge verdicts back to the (2, KW, NF) observation
    # grid via e_src (consumed in merge_ba_result, backend_lego.cpp:186-194).
    KW, NF = cfg.caps.window, cfg.caps.max_features
    out_grid = jnp.zeros((2 * KW * NF,), bool).at[problem.e_src].set(outlier_edge)
    out_l = out_grid[: KW * NF].reshape(KW, NF)
    out_r = out_grid[KW * NF :].reshape(KW, NF)

    stats = BAStats(
        chi=res.chi,
        iterations=res.iterations,
        n_outlier=n_out,
        n_inlier=n_in,
        n_active_landmarks=counts[0],
        n_dropped_landmarks=counts[1],
        lam=res.lam,
        trace=res.trace,
    )

    # Window pose information at the optimum for the next eviction to
    # marginalize (use_marg_prior): undamped Schur-reduced system + the prior
    # itself, so information accumulates recursively across evictions.
    info = None
    if cfg.use_marg_prior:
        gi = edge_soa.make_soa_graph(problem.graph)
        blocks_f = edge_soa.soa_build(
            gi, state.poses, state.points, robust.HUBER, ba_cfg.chi2_threshold
        )
        S_f, b_f, _ = edge_soa.soa_schur_reduce(
            blocks_f, problem.graph.point_valid, 0.0, "default"
        )
        prior_J, prior_err, T_lin = pose_prior
        dx = se3.se3_log(state.poses @ se3.se3_inv(T_lin)).reshape(-1)
        r_p = prior_err + prior_J @ dx
        S_f = S_f + prior_J.T @ prior_J
        b_f = b_f - prior_J.T @ r_p
        info = (S_f, b_f, state.poses, wmap.kf_id)

    return BAResult(
        kf_id=wmap.kf_id,
        kf_frame_id=wmap.kf_frame_id,
        active_ids=problem.active_ids,
        point_valid=problem.graph.point_valid,
        poses=state.poses,
        points=state.points,
        out_l=out_l,
        out_r=out_r,
        stats=stats,
        info=info,
    )


def merge_ba_result(wmap: WorldMap, result: BAResult) -> WorldMap:
    """Write a `BAResult` back into a (possibly newer) world map.

    The write-back of Backend::Optimize (backend_lego.cpp:186-217), made safe
    against the map having changed since the snapshot — the exact situation
    the reference handles with per-object mutexes while its frontend keeps
    inserting keyframes.  Reconciliation rules:

    - keyframe poses: applied only where the window slot still holds the same
      keyframe (kf_id AND kf_frame_id match; frame ids are globally monotonic,
      so this also guards keyframe-id reuse across a LOST Reset);
    - landmark positions: applied only to landmarks the solve optimized that
      are still alive;
    - outlier observation removal: applied only on matching slots and only to
      observations still registered, so the lm_obs decrement can never
      double-fire or hit a recycled lane.

    Applying a result to the unchanged snapshot map is exactly the reference's
    synchronous write-back (`ba_step`).
    """
    slot_match = (
        wmap.kf_valid
        & (result.kf_id >= 0)
        & (wmap.kf_id == result.kf_id)
        & (wmap.kf_frame_id == result.kf_frame_id)
    )
    kf_pose = jnp.where(slot_match[:, None, None], result.poses, wmap.kf_pose)

    ids = jnp.maximum(result.active_ids, 0)
    ok = result.point_valid & (result.active_ids >= 0) & wmap.lm_alive[ids]
    # Inactive slots are routed out of bounds and dropped: clipping them to a
    # real index would make that row's final value depend on scatter order
    # (duplicate-index .set is unspecified) whenever the row is also a real
    # write target.
    ML = wmap.lm_pos.shape[0]
    lm_pos = wmap.lm_pos.at[jnp.where(ok, result.active_ids, ML)].set(
        result.points, mode="drop"
    )

    out_l = result.out_l & slot_match[:, None] & wmap.kf_obs_left
    out_r = result.out_r & slot_match[:, None] & wmap.kf_obs_right
    lm_idx = jnp.maximum(wmap.kf_lm, 0)
    dec = out_l.astype(jnp.int32) + out_r.astype(jnp.int32)
    lm_obs = wmap.lm_obs.at[lm_idx.reshape(-1)].add(-dec.reshape(-1))

    marg = wmap.marg
    if result.info is not None:
        S_f, b_f, T_f, kf_id_f = result.info
        marg = marg._replace(info_S=S_f, info_b=b_f, info_T=T_f, info_kf_id=kf_id_f)

    return wmap._replace(
        kf_pose=kf_pose,
        lm_pos=lm_pos,
        lm_obs=lm_obs,
        kf_obs_left=wmap.kf_obs_left & ~out_l,
        kf_obs_right=wmap.kf_obs_right & ~out_r,
        marg=marg,
    )


def ba_step(
    cfg: FrontendConfig,
    rig: StereoRig,
    wmap: WorldMap,
    ba_cfg: BAConfig = BAConfig(),
    solve_fn=None,
) -> Tuple[WorldMap, BAStats]:
    """One full *synchronous* backend cycle: snapshot -> LM solve -> adaptive
    outlier rejection -> observation removal -> write-back (Backend::Optimize,
    backend_lego.cpp:56-218) — `solve_window` + an immediate `merge_ba_result`.
    """
    result = solve_window(cfg, rig, wmap, ba_cfg, solve_fn=solve_fn)
    return merge_ba_result(wmap, result), result.stats
