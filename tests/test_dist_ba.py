"""Distributed BA on a virtual 8-device CPU mesh (SURVEY §4 multi-chip tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.geometry import se3
from legoslam.parallel import dist_ba, mesh as mesh_mod
from legoslam.solver import lm, robust, schur
from tests.test_lm_solver import INTR, _build_graph, make_scene, project_all


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, jax.devices()
    return mesh_mod.make_mesh()


def _problem(rng):
    pts, poses, exts = make_scene(rng, n_points=60, n_poses=5)
    uv, ok = project_all(pts, poses, exts)
    meas = uv + rng.normal(scale=0.2, size=uv.shape).astype(np.float32)
    graph = _build_graph(pts, poses, exts, uv, ok, meas)
    poses0 = poses.copy()
    for k in range(1, len(poses)):
        d = rng.normal(scale=0.02, size=6).astype(np.float32)
        poses0[k] = np.asarray(se3.retract(jnp.asarray(poses[k]), jnp.asarray(d)))
    pts0 = pts + rng.normal(scale=0.2, size=pts.shape).astype(np.float32)
    return graph, jnp.asarray(poses0), jnp.asarray(pts0), poses, pts


def test_dist_matches_single_device(mesh, rng):
    graph, poses0, pts0, poses_gt, pts_gt = _problem(rng)
    cfg = lm.LMConfig(iterations=8)
    state_s, res_s = lm.solve_ba(graph, poses0, pts0, cfg=cfg)
    solve_fn = dist_ba.make_dist_solve_fn(mesh)
    state_d, res_d = solve_fn(graph, poses0, pts0, cfg)
    # Same math, different reduction orders: expect near-identical results.
    np.testing.assert_allclose(float(res_d.chi), float(res_s.chi), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(state_d.poses), np.asarray(state_s.poses), atol=1e-3)
    np.testing.assert_allclose(np.asarray(state_d.points), np.asarray(state_s.points), atol=5e-3)


def test_dist_converges_to_ground_truth(mesh, rng):
    graph, poses0, pts0, poses_gt, pts_gt = _problem(rng)
    solve_fn = dist_ba.make_dist_solve_fn(mesh)
    chi0 = float(schur.robust_chi(graph, poses0, pts0, robust.HUBER, 5.991))
    state, res = solve_fn(graph, poses0, pts0, lm.LMConfig(iterations=10))
    assert float(res.chi) < 0.05 * chi0
    for k in range(1, 5):
        err = np.asarray(
            se3.se3_log(jnp.asarray(np.linalg.inv(poses_gt[k]) @ np.asarray(state.poses[k]))[None])
        )[0]
        assert np.linalg.norm(err[:3]) < 0.05, (k, err)


def test_dist_solve_jits(mesh, rng):
    graph, poses0, pts0, _, _ = _problem(rng)
    solve_fn = dist_ba.make_dist_solve_fn(mesh)

    @jax.jit
    def run(graph, poses, points):
        state, res = solve_fn(graph, poses, points, lm.LMConfig(iterations=3))
        return state.poses, res.chi

    p, c = run(graph, poses0, pts0)
    assert np.isfinite(float(c))


def test_dist_ba_step_in_pipeline(mesh, rng):
    """ba_step with the sharded solver plugged in (backend seam)."""
    from legoslam.ops import pyramid as pyr_ops
    from legoslam.pipeline import backend as backend_mod
    from legoslam.pipeline import frontend as frontend_mod
    from legoslam.pipeline.state import WorldMap
    from tests.test_pipeline import make_dataset, small_cfg

    ds = make_dataset(n_frames=2)
    ds.init()
    fr = ds.next_frame()
    cfg = small_cfg()
    img_l, img_r = jnp.asarray(fr.left), jnp.asarray(fr.right)
    pyr_l = tuple(pyr_ops.build_pyramid(img_l, cfg.klt.levels))
    pyr_r = tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
    ok, feats, wmap = frontend_mod.stereo_init(
        cfg, ds.rig, pyr_l, pyr_r, img_l, WorldMap.empty(cfg.caps), jnp.asarray(0, jnp.int32)
    )
    assert bool(ok)
    solve_fn = dist_ba.make_dist_solve_fn(mesh)
    wmap2, stats = backend_mod.ba_step(cfg, ds.rig, wmap, solve_fn=solve_fn)
    assert np.isfinite(float(stats.chi))
    assert int(stats.n_inlier) > 0


@pytest.mark.slow
def test_dist_matches_single_at_production_shape(mesh, rng):
    """Dist-vs-single parity at the PRODUCTION window shape (K=16, L=2048,
    E=5120 — pipeline/state.py Capacities), asserted rather than reported.
    Reference: the backend solves exactly this window per keyframe
    (problem.cpp:282-284, 390-400)."""
    graph, poses0, pts0 = dist_ba.synthetic_window(rng)
    cfg = lm.LMConfig(iterations=8)
    state_s, res_s = lm.solve_ba(graph, poses0, pts0, cfg=cfg)
    solve_fn = dist_ba.make_dist_solve_fn(mesh)
    state_d, res_d = solve_fn(graph, poses0, pts0, cfg)
    np.testing.assert_allclose(float(res_d.chi), float(res_s.chi), rtol=1e-3)
    # Pose deltas: same optimum up to f32 reduction-order noise.
    dp = np.abs(np.asarray(state_d.poses) - np.asarray(state_s.poses)).max()
    assert dp < 5e-3, dp
