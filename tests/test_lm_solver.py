import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.geometry import se3
from legoslam.solver import lm, pcg, reprojection, robust, schur

INTR = reprojection.Intrinsics(
    fx=jnp.float32(360.0), fy=jnp.float32(360.0), cx=jnp.float32(310.0), cy=jnp.float32(94.0)
)


def make_scene(rng, n_points=120, n_poses=5, baseline=0.54):
    """Synthetic stereo scene: points in front of a small forward trajectory."""
    pts = rng.uniform([-10, -4, 8], [10, 2, 60], size=(n_points, 3)).astype(np.float32)
    poses = []
    for i in range(n_poses):
        xi = np.zeros(6)
        xi[:3] = [0.05 * i, 0.01 * i, -0.8 * i]  # camera moves forward (+z world behind)
        xi[3:] = rng.normal(scale=0.01, size=3)
        poses.append(np.asarray(se3.se3_exp(jnp.asarray(xi, jnp.float32))))
    poses = np.stack(poses)
    ext_l = np.eye(4, dtype=np.float32)
    ext_r = np.eye(4, dtype=np.float32)
    ext_r[0, 3] = -baseline
    return pts, poses, np.stack([ext_l, ext_r])


def project_all(pts, poses, exts):
    """(K, C, N, 2) pixel observations and validity (positive depth)."""
    K, C, N = len(poses), len(exts), len(pts)
    uv = np.zeros((K, C, N, 2), np.float32)
    ok = np.zeros((K, C, N), bool)
    intr = np.array([float(INTR.fx), float(INTR.fy), float(INTR.cx), float(INTR.cy)])
    for k in range(K):
        for c in range(C):
            p = (exts[c] @ poses[k])[:3, :3] @ pts.T + ((exts[c] @ poses[k])[:3, 3:])
            z = p[2]
            uv[k, c, :, 0] = intr[0] * p[0] / z + intr[2]
            uv[k, c, :, 1] = intr[1] * p[1] / z + intr[3]
            ok[k, c] = z > 0.5
    return uv, ok


def test_pose_only_jacobian_matches_autodiff(rng):
    pts = jnp.asarray(rng.uniform([-5, -5, 5], [5, 5, 40], size=(16, 3)), jnp.float32)
    T = se3.se3_exp(jnp.asarray(rng.normal(scale=0.1, size=6), jnp.float32))
    uv = jnp.zeros((16, 2), jnp.float32)

    def res_fn(delta):
        return reprojection.pose_only_edge(INTR, se3.retract(T, delta), pts, uv)[0]

    J_auto = jax.jacfwd(res_fn)(jnp.zeros(6, jnp.float32))  # (16, 2, 6)
    _, J_analytic = reprojection.pose_only_edge(INTR, T, pts, uv)
    np.testing.assert_allclose(np.asarray(J_auto), np.asarray(J_analytic), rtol=1e-3, atol=1e-2)


def test_projection_edge_point_jacobian_matches_autodiff(rng):
    pts = jnp.asarray(rng.uniform([-5, -5, 5], [5, 5, 40], size=(8, 3)), jnp.float32)
    T = se3.se3_exp(jnp.asarray(rng.normal(scale=0.1, size=6), jnp.float32))
    ext = jnp.eye(4, dtype=jnp.float32).at[0, 3].set(-0.54)
    uv = jnp.zeros((8, 2), jnp.float32)

    def res_fn(p):
        return reprojection.projection_edge(INTR, T, ext, p, uv)[0]

    J_auto = jax.jacfwd(res_fn)(pts)  # (8, 2, 8, 3) block-diag
    J_auto = jnp.stack([J_auto[i, :, i, :] for i in range(8)])
    _, _, J_analytic = reprojection.projection_edge(INTR, T, ext, pts, uv)
    np.testing.assert_allclose(np.asarray(J_auto), np.asarray(J_analytic), rtol=1e-3, atol=1e-2)


def test_estimate_pose_recovers_ground_truth(rng):
    pts, poses, exts = make_scene(rng, n_poses=2)
    T_gt = poses[1]
    uv, ok = project_all(pts, poses, exts)
    noise = rng.normal(scale=0.3, size=uv[1, 0].shape).astype(np.float32)
    meas = uv[1, 0] + noise
    # Start from a perturbed pose (constant-velocity prior surrogate).
    T0 = np.asarray(se3.retract(jnp.asarray(T_gt), jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.01, 0.03], jnp.float32)))
    T_est, inliers, n_in = lm.estimate_pose(
        INTR, jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(meas), jnp.asarray(ok[1, 0])
    )
    err = np.asarray(se3.se3_log(jnp.asarray(np.linalg.inv(T_gt) @ np.asarray(T_est))))
    assert np.linalg.norm(err[:3]) < 0.05, err
    assert np.linalg.norm(err[3:]) < 0.01, err
    assert int(n_in) > 100


def test_estimate_pose_rejects_outliers(rng):
    pts, poses, exts = make_scene(rng, n_poses=2)
    T_gt = poses[1]
    uv, ok = project_all(pts, poses, exts)
    meas = uv[1, 0] + rng.normal(scale=0.3, size=uv[1, 0].shape).astype(np.float32)
    # Corrupt 20% of measurements badly.
    n_bad = len(pts) // 5
    bad = rng.choice(len(pts), size=n_bad, replace=False)
    meas[bad] += rng.uniform(30, 80, size=(n_bad, 2)).astype(np.float32) * np.sign(rng.normal(size=(n_bad, 2)))
    T0 = np.asarray(se3.retract(jnp.asarray(T_gt), jnp.asarray([0.08, 0.02, -0.1, 0.01, 0.02, -0.01], jnp.float32)))
    T_est, inliers, n_in = lm.estimate_pose(
        INTR, jnp.asarray(T0), jnp.asarray(pts), jnp.asarray(meas), jnp.asarray(ok[1, 0])
    )
    err = np.asarray(se3.se3_log(jnp.asarray(np.linalg.inv(T_gt) @ np.asarray(T_est))))
    assert np.linalg.norm(err[:3]) < 0.08, err
    inliers = np.asarray(inliers)
    # most corrupted edges classified out; most clean edges kept
    assert inliers[bad].mean() < 0.2
    clean = np.setdiff1d(np.arange(len(pts)), bad)
    assert inliers[clean].mean() > 0.9


def _build_graph(pts, poses, exts, uv, ok, noise_uv):
    K, C, N = uv.shape[0], uv.shape[1], uv.shape[2]
    e_pose = np.repeat(np.arange(K), C * N)
    e_cam = np.tile(np.repeat(np.arange(C), N), K)
    e_point = np.tile(np.arange(N), K * C)
    e_uv = noise_uv.reshape(-1, 2)
    e_valid = ok.reshape(-1)
    return schur.BAGraph(
        e_pose=jnp.asarray(e_pose, jnp.int32),
        e_point=jnp.asarray(e_point, jnp.int32),
        e_cam=jnp.asarray(e_cam, jnp.int32),
        e_uv=jnp.asarray(e_uv),
        e_valid=jnp.asarray(e_valid),
        exts=jnp.asarray(exts),
        intr=INTR,
        pose_fixed=jnp.zeros(K, bool).at[0].set(True),
        point_valid=jnp.ones(N, bool),
    )


def test_full_ba_converges_to_ground_truth(rng):
    pts, poses, exts = make_scene(rng, n_points=80, n_poses=5)
    uv, ok = project_all(pts, poses, exts)
    meas = uv + rng.normal(scale=0.2, size=uv.shape).astype(np.float32)
    graph = _build_graph(pts, poses, exts, uv, ok, meas)

    # Perturb everything except the (fixed) first pose.
    poses0 = poses.copy()
    for k in range(1, len(poses)):
        d = rng.normal(scale=0.03, size=6).astype(np.float32)
        poses0[k] = np.asarray(se3.retract(jnp.asarray(poses[k]), jnp.asarray(d)))
    pts0 = pts + rng.normal(scale=0.3, size=pts.shape).astype(np.float32)

    chi_before = float(schur.robust_chi(graph, jnp.asarray(poses0), jnp.asarray(pts0), robust.HUBER, 5.991))
    state, res = lm.solve_ba(graph, jnp.asarray(poses0), jnp.asarray(pts0), cfg=lm.LMConfig(iterations=10))
    chi_after = float(res.chi)
    assert chi_after < chi_before * 0.05, (chi_before, chi_after)

    # Fixed pose must not move.
    np.testing.assert_allclose(np.asarray(state.poses[0]), poses0[0], atol=1e-6)
    # Other poses should approach ground truth.
    for k in range(1, len(poses)):
        err = np.asarray(se3.se3_log(jnp.asarray(np.linalg.inv(poses[k]) @ np.asarray(state.poses[k]))))
        assert np.linalg.norm(err[:3]) < 0.03, (k, err)
        assert np.linalg.norm(err[3:]) < 0.005, (k, err)


def test_ba_respects_invalid_points(rng):
    pts, poses, exts = make_scene(rng, n_points=40, n_poses=3)
    uv, ok = project_all(pts, poses, exts)
    graph = _build_graph(pts, poses, exts, uv, ok, uv)
    pv = np.ones(len(pts), bool)
    pv[::4] = False
    graph = graph._replace(point_valid=jnp.asarray(pv))
    pts0 = pts + rng.normal(scale=0.5, size=pts.shape).astype(np.float32)
    state, res = lm.solve_ba(graph, jnp.asarray(poses), jnp.asarray(pts0), cfg=lm.LMConfig(iterations=5))
    out = np.asarray(state.points)
    # Invalid landmark slots must be untouched.
    np.testing.assert_allclose(out[::4], pts0[::4], atol=1e-7)
    # Valid ones move toward ground truth.
    valid_err_before = np.linalg.norm((pts0 - pts)[pv], axis=1).mean()
    valid_err_after = np.linalg.norm((out - pts)[pv], axis=1).mean()
    assert valid_err_after < 0.3 * valid_err_before


def test_ba_strategy1(rng):
    pts, poses, exts = make_scene(rng, n_points=60, n_poses=4)
    uv, ok = project_all(pts, poses, exts)
    graph = _build_graph(pts, poses, exts, uv, ok, uv)
    poses0 = poses.copy()
    poses0[2] = np.asarray(se3.retract(jnp.asarray(poses[2]), jnp.asarray([0.05, 0, -0.05, 0.01, 0, 0], jnp.float32)))
    chi0 = float(schur.robust_chi(graph, jnp.asarray(poses0), jnp.asarray(pts), robust.HUBER, 5.991))
    state, res = lm.solve_ba(
        graph, jnp.asarray(poses0), jnp.asarray(pts),
        cfg=lm.LMConfig(iterations=10, strategy="strategy1"),
    )
    assert float(res.chi) < chi0 * 0.05


def test_pcg_matches_direct_solve(rng):
    n = 48
    A = rng.normal(size=(n, n)).astype(np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    b = rng.normal(size=n).astype(np.float32)
    x = np.asarray(pcg.pcg_solve(jnp.asarray(A), jnp.asarray(b)))
    x_ref = np.linalg.solve(A, b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-3, atol=1e-3)


def test_lm_jits(rng):
    """The whole BA solve must be traceable/compilable as one function."""
    pts, poses, exts = make_scene(rng, n_points=32, n_poses=3)
    uv, ok = project_all(pts, poses, exts)
    graph = _build_graph(pts, poses, exts, uv, ok, uv)

    @jax.jit
    def run(graph, poses, points):
        state, res = lm.solve_ba(graph, poses, points, cfg=lm.LMConfig(iterations=3))
        return state.poses, res.chi

    p, c = run(graph, jnp.asarray(poses), jnp.asarray(pts))
    assert np.isfinite(float(c))


def test_ba_with_pcg_linear_solver(rng):
    """The PCG seam (problem.cpp:377-422) must reach the same optimum."""
    pts, poses, exts = make_scene(rng, n_points=50, n_poses=4)
    uv, ok = project_all(pts, poses, exts)
    graph = _build_graph(pts, poses, exts, uv, ok, uv)
    pts0 = pts + rng.normal(scale=0.3, size=pts.shape).astype(np.float32)
    s_ch, r_ch = lm.solve_ba(graph, jnp.asarray(poses), jnp.asarray(pts0), cfg=lm.LMConfig(iterations=6))
    s_pc, r_pc = lm.solve_ba(graph, jnp.asarray(poses), jnp.asarray(pts0),
                             cfg=lm.LMConfig(iterations=6, linear_solver="pcg"))
    assert float(r_pc.chi) < 1.5 * float(r_ch.chi) + 1e-3
    np.testing.assert_allclose(np.asarray(s_pc.poses), np.asarray(s_ch.poses), atol=5e-3)
