"""Equivalence of the component-major BA engine (solver/edge_soa.py) with the
block pipeline (solver/schur.py) it accelerates.

Both re-implement buildHessian/solveLinearEquation (problem.cpp:273-431); the
SoA engine must agree to float tolerance on every intermediate (per-edge chi2,
assembled blocks, Schur system, back-substitution) and converge to the same
optimum through lm.solve_ba.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.geometry import se3
from legoslam.solver import edge_soa, lm as lm_ops, reprojection, robust, schur


def random_graph(rng, K=5, L=60, obs_per_lm=4, with_invalid=True):
    """Random BA problem with every landmark observed `obs_per_lm` times from
    distinct poses — keeps the Hll blocks well-conditioned so the two engines'
    f32 roundings cannot be amplified into spurious test failures."""
    E = L * obs_per_lm
    intr = reprojection.Intrinsics(
        fx=jnp.float32(300.0), fy=jnp.float32(310.0), cx=jnp.float32(160.0), cy=jnp.float32(120.0)
    )
    exts = jnp.stack([
        jnp.eye(4, dtype=jnp.float32),
        jnp.asarray(np.block([
            [np.eye(3), np.array([[-0.5], [0.0], [0.0]])],
            [np.zeros((1, 3)), np.ones((1, 1))],
        ]), jnp.float32),
    ])
    points_gt = rng.uniform([-4, -2, 4], [4, 2, 14], (L, 3)).astype(np.float32)
    poses_gt = []
    for k in range(K):
        tw = se3.se3_exp(jnp.asarray(0.05 * rng.standard_normal(6), jnp.float32))
        T = np.array(tw)
        T[:3, 3] += [0.1 * k, 0, 0]
        poses_gt.append(T)
    poses_gt = np.stack(poses_gt).astype(np.float32)

    e_point = np.repeat(np.arange(L), obs_per_lm).astype(np.int32)
    e_pose = np.concatenate(
        [rng.choice(K, obs_per_lm, replace=False) for _ in range(L)]
    ).astype(np.int32)
    e_cam = rng.integers(0, 2, E).astype(np.int32)
    # measurements = projections + noise (+ outliers)
    uv = []
    for i in range(E):
        T = poses_gt[e_pose[i]]
        pw = points_gt[e_point[i]]
        pc = (np.asarray(exts[e_cam[i]]) @ np.append(T[:3, :3] @ pw + T[:3, 3], 1.0))[:3]
        u = 300.0 * pc[0] / pc[2] + 160.0
        v = 310.0 * pc[1] / pc[2] + 120.0
        uv.append([u, v])
    uv = np.asarray(uv, np.float32) + 0.5 * rng.standard_normal((E, 2)).astype(np.float32)
    uv[: E // 20] += 30.0  # outliers exercising the robust kernel

    e_valid = np.ones(E, bool)
    point_valid = np.ones(L, bool)
    pose_fixed = np.zeros(K, bool)
    pose_fixed[0] = True
    if with_invalid:
        # Mask whole landmarks two ways (edge-level and slot-level) rather
        # than random single edges: a landmark left with <2 views has a
        # near-singular Hll block whose inverse amplifies f32 rounding into
        # engine disagreement that says nothing about correctness.
        e_valid[e_point < 3] = False
        point_valid[:3] = False
        point_valid[rng.integers(3, L, 4)] = False

    graph = schur.BAGraph(
        e_pose=jnp.asarray(e_pose), e_point=jnp.asarray(e_point), e_cam=jnp.asarray(e_cam),
        e_uv=jnp.asarray(uv), e_valid=jnp.asarray(e_valid), exts=exts, intr=intr,
        pose_fixed=jnp.asarray(pose_fixed), point_valid=jnp.asarray(point_valid),
    )
    # noisy initial state
    poses0 = np.stack([
        np.asarray(se3.se3_exp(jnp.asarray(0.02 * rng.standard_normal(6), jnp.float32))) @ p
        for p in poses_gt
    ]).astype(np.float32)
    points0 = points_gt + 0.1 * rng.standard_normal((L, 3)).astype(np.float32)
    return graph, jnp.asarray(poses0), jnp.asarray(points0)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    return random_graph(rng)


@pytest.mark.parametrize("kernel", [robust.HUBER, robust.TRIVIAL, robust.CAUCHY])
def test_chi_and_blocks_match(problem, kernel):
    graph, poses, points = problem
    delta = 5.991
    gs = edge_soa.make_soa_graph(graph)

    chi_ref = schur.robust_chi(graph, poses, points, kernel, delta)
    chi_soa = edge_soa.soa_robust_chi(gs, poses, points, kernel, delta)
    np.testing.assert_allclose(chi_soa, chi_ref, rtol=2e-5)

    chis_ref = schur.edge_chi2(graph, poses, points, kernel, delta)
    chis_soa = edge_soa.soa_edge_chi2(gs, poses, points, kernel, delta)
    np.testing.assert_allclose(chis_soa, chis_ref, rtol=2e-4, atol=1e-4)

    ref = schur.build_blocks(graph, poses, points, kernel, delta)
    got = edge_soa.to_bablocks(edge_soa.soa_build(gs, poses, points, kernel, delta))
    for name in ref._fields:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(got, name))
        scale = max(1.0, np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=0, atol=3e-4 * scale, err_msg=name)


def test_schur_and_backsub_match(problem):
    graph, poses, points = problem
    delta = 5.991
    gs = edge_soa.make_soa_graph(graph)
    ref_blocks = schur.build_blocks(graph, poses, points, robust.HUBER, delta)
    soa_blocks = edge_soa.soa_build(gs, poses, points, robust.HUBER, delta)

    S_ref, bs_ref, _ = schur.schur_reduce(ref_blocks, graph.point_valid)
    S_soa, bs_soa, inv_soa = edge_soa.soa_schur_reduce(soa_blocks, graph.point_valid)
    sS = max(1.0, np.abs(np.asarray(S_ref)).max())
    np.testing.assert_allclose(np.asarray(S_soa), np.asarray(S_ref), rtol=0, atol=3e-4 * sS)
    sb = max(1.0, np.abs(np.asarray(bs_ref)).max())
    np.testing.assert_allclose(np.asarray(bs_soa), np.asarray(bs_ref), rtol=0, atol=3e-4 * sb)

    dx_p = schur.damp_and_solve(S_ref, bs_ref, jnp.asarray(1e-3, jnp.float32))
    _, _, Hll_inv_ref = schur.schur_reduce(ref_blocks, graph.point_valid)
    dl_ref = schur.back_substitute(ref_blocks, Hll_inv_ref, dx_p)
    dl_soa = edge_soa.soa_back_substitute(soa_blocks, inv_soa, dx_p)
    sd = max(1.0, np.abs(np.asarray(dl_ref)).max())
    np.testing.assert_allclose(np.asarray(dl_soa), np.asarray(dl_ref), rtol=0, atol=1e-3 * sd)

    # diag packing matches solve_ba's aux order
    diag_ref = np.concatenate([
        np.asarray(jnp.diagonal(ref_blocks.Hpp, axis1=-2, axis2=-1)).reshape(-1),
        np.asarray(jnp.diagonal(ref_blocks.Hll, axis1=-2, axis2=-1)).reshape(-1),
    ])
    diag_soa = np.asarray(edge_soa.soa_blocks_diag(soa_blocks))
    np.testing.assert_allclose(diag_soa, diag_ref, rtol=0, atol=3e-4 * max(1.0, np.abs(diag_ref).max()))


def test_solve_ba_engines_agree(problem):
    graph, poses, points = problem
    cfg = lm_ops.LMConfig(iterations=8)
    st_ref, res_ref = jax.jit(
        lambda p, x: lm_ops.solve_ba(graph, p, x, cfg=cfg, engine="blocks")
    )(poses, points)
    st_soa, res_soa = jax.jit(
        lambda p, x: lm_ops.solve_ba(graph, p, x, cfg=cfg, engine="soa")
    )(poses, points)
    # Same optimization trajectory: chi agrees tightly, states agree loosely
    # (both are local-minimum refinements of the same problem).
    np.testing.assert_allclose(float(res_soa.chi), float(res_ref.chi), rtol=1e-3)
    np.testing.assert_allclose(
        np.asarray(st_soa.poses), np.asarray(st_ref.poses), rtol=0, atol=5e-3
    )
    assert float(res_soa.chi) < 0.9 * float(
        schur.robust_chi(graph, poses, points, robust.HUBER, 5.991)
    )


def test_bf16_assembly_reaches_f32_optimum(problem):
    """assembly_precision="bf16" perturbs only the model Hessian (~0.4%
    relative); the LM loop must still reach the f32 engine's optimum chi.
    This is the A/B gate for the production default
    (utils/config.py ba_assembly_precision)."""
    graph, poses, points = problem
    st32, res32 = jax.jit(
        lambda p, x: lm_ops.solve_ba(graph, p, x, cfg=lm_ops.LMConfig(iterations=10))
    )(poses, points)
    st16, res16 = jax.jit(
        lambda p, x: lm_ops.solve_ba(
            graph, p, x,
            cfg=lm_ops.LMConfig(iterations=10, assembly_precision="bf16"),
        )
    )(poses, points)
    chi0 = float(schur.robust_chi(graph, poses, points, robust.HUBER, 5.991))
    assert float(res16.chi) < 0.9 * chi0  # genuinely optimized
    # Same optimum within noise: chi within 0.5% of the f32 engine's.
    np.testing.assert_allclose(float(res16.chi), float(res32.chi), rtol=5e-3)
    np.testing.assert_allclose(
        np.asarray(st16.poses), np.asarray(st32.poses), rtol=0, atol=1e-2
    )
