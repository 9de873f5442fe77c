"""Pose-graph optimization (loop-closure scaffold) and marginalization priors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.geometry import se3
from legoslam.solver import lm, marginalization, pose_graph


def _chain_problem(rng, n=20, drift=0.02, loop=True):
    """Ground-truth circular-ish trajectory, noisy odometry, loop closure."""
    gt = [np.eye(4)]
    for i in range(1, n):
        step = np.asarray(se3.se3_exp(jnp.asarray([0.0, 0, 0.5, 0, 2 * np.pi / n, 0], jnp.float32)))
        gt.append(gt[-1] @ step)
    gt = np.stack(gt).astype(np.float32)

    e_i, e_j, T_meas, w = [], [], [], []
    est = [gt[0]]
    for i in range(1, n):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        noise = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(scale=drift, size=6), jnp.float32)))
        rel_noisy = noise @ rel
        # odometry edge measures T_i T_{i-1}^-1
        e_i.append(i)
        e_j.append(i - 1)
        T_meas.append(rel_noisy)
        w.append(1.0)
        est.append(rel_noisy @ est[-1])
    if loop:
        e_i.append(n - 1)
        e_j.append(0)
        T_meas.append(gt[n - 1] @ np.linalg.inv(gt[0]))  # exact loop closure
        w.append(100.0)
    graph = pose_graph.PoseGraph(
        e_i=jnp.asarray(e_i, jnp.int32),
        e_j=jnp.asarray(e_j, jnp.int32),
        T_meas=jnp.asarray(np.stack(T_meas)),
        weight=jnp.asarray(w, jnp.float32),
        valid=jnp.ones(len(w), bool),
        fixed=jnp.zeros(n, bool).at[0].set(True),
    )
    return gt, jnp.asarray(np.stack(est)), graph


def _terr(est, gt):
    return np.linalg.norm(np.asarray(est)[:, :3, 3] - gt[:, :3, 3], axis=1)


def test_pose_graph_reduces_drift(rng):
    gt, est0, graph = _chain_problem(rng)
    before = _terr(est0, gt).max()
    opt, res = pose_graph.optimize(est0, graph)
    after = _terr(opt, gt).max()
    assert after < 0.4 * before, (before, after)
    # gauge: first pose untouched
    np.testing.assert_allclose(np.asarray(opt[0]), gt[0], atol=1e-6)


def test_pose_graph_jits(rng):
    gt, est0, graph = _chain_problem(rng, n=8)
    f = jax.jit(lambda p, g: pose_graph.optimize(p, g, cfg=lm.LMConfig(iterations=5))[0])
    out = f(est0, graph)
    assert np.isfinite(np.asarray(out)).all()


def test_pose_graph_robust_to_bad_edge(rng):
    gt, est0, graph = _chain_problem(rng, n=16)
    # inject a grossly wrong extra edge with low chi-threshold Huber
    bad = pose_graph.PoseGraph(
        e_i=jnp.concatenate([graph.e_i, jnp.asarray([8], jnp.int32)]),
        e_j=jnp.concatenate([graph.e_j, jnp.asarray([2], jnp.int32)]),
        T_meas=jnp.concatenate([graph.T_meas, jnp.eye(4, dtype=jnp.float32)[None]]),
        weight=jnp.concatenate([graph.weight, jnp.asarray([1.0], jnp.float32)]),
        valid=jnp.concatenate([graph.valid, jnp.asarray([True])]),
        fixed=graph.fixed,
    )
    from legoslam.solver import robust

    # Tukey is redescending (cost_function.cpp:28-41): the gross edge's
    # influence goes to zero instead of merely being bounded.
    opt, _ = pose_graph.optimize(est0, bad, kernel=robust.TUKEY, delta=1.0)
    after = _terr(opt, gt).max()
    assert after < 0.35, after


# ---------------------------------------------------------------------------
# Marginalization
# ---------------------------------------------------------------------------

def _random_spd(rng, n):
    A = rng.normal(size=(n, n)).astype(np.float32)
    return A @ A.T + n * np.eye(n, dtype=np.float32)


def test_marginal_matches_direct_elimination(rng):
    """Solving [keep] with the prior == solving the full system then reading
    the kept block (the defining property of marginalization)."""
    n, m = 12, 4
    H = jnp.asarray(_random_spd(rng, n))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))
    mask = jnp.zeros(n, bool).at[jnp.asarray([2, 5, 6, 9])].set(True)

    prior = marginalization.marginalize(H, b, mask, m)
    # Direct: x = H^-1 b; kept coordinates of the joint optimum.
    x_full = np.linalg.solve(np.asarray(H, np.float64), np.asarray(b, np.float64))
    keep = ~np.asarray(mask)
    # Prior system restricted to kept coords must reproduce the same optimum.
    Hk = np.asarray(prior.H, np.float64)[np.ix_(keep, keep)]
    bk = np.asarray(prior.b, np.float64)[keep]
    x_keep = np.linalg.solve(Hk, bk)
    np.testing.assert_allclose(x_keep, x_full[keep], rtol=1e-3, atol=1e-3)
    # Marginalized rows/cols are zero.
    marg = np.asarray(mask)
    assert np.abs(np.asarray(prior.H)[marg]).max() == 0.0
    assert np.abs(np.asarray(prior.b)[marg]).max() == 0.0


def test_sqrt_form_consistent(rng):
    n, m = 10, 3
    H = jnp.asarray(_random_spd(rng, n))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))
    mask = jnp.zeros(n, bool).at[jnp.asarray([0, 4, 7])].set(True)
    prior = marginalization.marginalize(H, b, mask, m)
    np.testing.assert_allclose(
        np.asarray(prior.sqrt_J.T @ prior.sqrt_J), np.asarray(prior.H), rtol=1e-3, atol=1e-2
    )
    # err = -J^-T b  =>  J^T err = -b on the kept subspace
    np.testing.assert_allclose(
        np.asarray(prior.sqrt_J.T @ prior.err), -np.asarray(prior.b), rtol=1e-3, atol=1e-2
    )


def test_apply_prior_and_update(rng):
    n = 8
    H = jnp.asarray(_random_spd(rng, n))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))
    mask = jnp.zeros(n, bool).at[0].set(True).at[1].set(True)
    prior = marginalization.marginalize(H, b, mask, 2)
    H2 = jnp.asarray(_random_spd(rng, n))
    b2 = jnp.asarray(rng.normal(size=n).astype(np.float32))
    Hc, bc = marginalization.apply_prior(H2, b2, prior)
    np.testing.assert_allclose(np.asarray(Hc), np.asarray(H2 + prior.H), atol=1e-6)
    # fixed coordinates suppress the prior (problem.cpp:344-351)
    fixed = jnp.zeros(n, bool).at[3].set(True)
    Hf, bf = marginalization.apply_prior(H2, b2, prior, fixed_mask=fixed)
    assert float(jnp.abs(Hf[3] - H2[3]).max()) == 0.0
    # first-order b update
    dx = jnp.asarray(rng.normal(size=n).astype(np.float32) * 0.01)
    up = marginalization.update_prior_b(prior, dx)
    np.testing.assert_allclose(np.asarray(up.b), np.asarray(prior.b - prior.H @ dx), atol=1e-6)


def test_marginalize_jits(rng):
    n = 12
    H = jnp.asarray(_random_spd(rng, n))
    b = jnp.asarray(rng.normal(size=n).astype(np.float32))
    mask = jnp.zeros(n, bool).at[jnp.arange(6)].set(True)
    f = jax.jit(lambda H, b, m: marginalization.marginalize(H, b, m, 6))
    out = f(H, b, mask)
    assert np.isfinite(np.asarray(out.H)).all()
