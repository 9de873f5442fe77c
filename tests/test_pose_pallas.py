"""The Pallas (Triton) pose-solve kernel against solver/lm.py estimate_pose.

estimate_pose_pallas must reproduce estimate_pose: same 4-round outlier
reclassification, LM schedule and Huber semantics.  The only allowed
deviations are float-level (Cholesky vs LU on the SPD 6x6; op ordering), so
the recovered pose and inlier sets are compared with tight tolerances.
Runs in Pallas interpret mode; chip_smoke.py compares the compiled kernel on
the GPU.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from legoslam.geometry import se3
from legoslam.solver import lm as lm_ops
from legoslam.solver import pose_pallas, reprojection
from tests.cuda_lowering import lower_for_cuda

INTR = reprojection.Intrinsics(fx=360.0, fy=360.0, cx=310.0, cy=94.0)
INTR_VEC = jnp.asarray([360.0, 360.0, 310.0, 94.0], jnp.float32)
kernel = functools.partial(pose_pallas.estimate_pose_pallas, INTR_VEC, interpret=True)


def _problem(rng, n=256, outlier_frac=0.1, noise=0.3):
    z = rng.uniform(4.0, 60.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    T_true = np.asarray(se3.se3_exp(jnp.asarray([0.1, -0.05, 0.3, 0.01, 0.02, -0.01], jnp.float32)))
    pc = P @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([360.0 * pc[:, 0] / pc[:, 2] + 310.0, 360.0 * pc[:, 1] / pc[:, 2] + 94.0], -1)
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(outlier_frac * n)
    uv[:n_out] += rng.normal(0, 30.0, (n_out, 2))
    valid = rng.uniform(size=n) > 0.05
    T_prior = np.asarray(
        se3.se3_exp(jnp.asarray([0.12, -0.03, 0.25, 0.0, 0.025, 0.0], jnp.float32))
    )
    return (
        jnp.asarray(T_prior, jnp.float32),
        jnp.asarray(P, jnp.float32),
        jnp.asarray(uv, jnp.float32),
        jnp.asarray(valid),
        T_true,
    )


def _reference(T_prior, P, uv, valid):
    return lm_ops.estimate_pose(
        INTR, T_prior, P, uv, valid, chi2_th=5.991, outer_iterations=4,
        cfg=lm_ops.LMConfig(iterations=10),
    )


def test_pose_kernel_matches_xla(rng):
    T_prior, P, uv, valid, T_true = _problem(rng)
    T_ref, inl_ref, n_ref = _reference(T_prior, P, uv, valid)
    T_pal, inl_pal, n_pal = kernel(T_prior, P, uv, valid)
    T_ref, T_pal = np.asarray(T_ref), np.asarray(T_pal)
    # Both must recover the true pose; and agree with each other tightly.
    np.testing.assert_allclose(T_ref, np.asarray(T_true), atol=5e-3)
    np.testing.assert_allclose(T_pal, np.asarray(T_true), atol=5e-3)
    np.testing.assert_allclose(T_pal, T_ref, atol=1e-4)
    inl_ref, inl_pal = np.asarray(inl_ref), np.asarray(inl_pal)
    assert (inl_ref == inl_pal).mean() > 0.98
    assert abs(int(n_ref) - int(n_pal)) <= max(3, 0.02 * len(inl_ref))


def test_pose_kernel_all_invalid(rng):
    """Degenerate: no valid edges — a finite pose and zero inliers, as from
    the XLA solve."""
    T_prior, P, uv, _, _ = _problem(rng, n=64)
    valid = jnp.zeros((64,), bool)
    T_pal, inl, n = kernel(T_prior, P, uv, valid)
    T_ref, _, n_ref = _reference(T_prior, P, uv, valid)
    assert np.isfinite(np.asarray(T_pal)).all()
    assert int(n) == 0 == int(n_ref) and not np.asarray(inl).any()
    np.testing.assert_allclose(np.asarray(T_pal), np.asarray(T_ref), atol=1e-6)


def test_pose_kernel_pads_edges(rng):
    """E that is not a power of two is padded with invalid edges: the result
    equals the same edges padded by hand."""
    T_prior, P, uv, valid, _ = _problem(rng, n=300)
    T_a, inl_a, n_a = kernel(T_prior, P, uv, valid)
    pad = 512 - 300
    T_b, inl_b, n_b = kernel(
        T_prior, jnp.pad(P, ((0, pad), (0, 0)), constant_values=1.0),
        jnp.pad(uv, ((0, pad), (0, 0))), jnp.pad(valid, (0, pad)),
    )
    assert inl_a.shape == (300,)
    np.testing.assert_allclose(np.asarray(T_a), np.asarray(T_b), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(inl_a), np.asarray(inl_b)[:300])
    assert int(n_a) == int(n_b)


def test_pose_kernel_lowers_for_cuda(rng):
    T_prior, P, uv, valid, _ = _problem(rng, n=64)
    text, n_modules = lower_for_cuda(
        lambda T, P, uv, v: pose_pallas.estimate_pose_pallas(INTR_VEC, T, P, uv, v),
        T_prior, P, uv, valid,
    )
    assert "__gpu$xla.gpu.triton" in text and n_modules == 1
