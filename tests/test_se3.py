import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.geometry import se3


def random_xi(rng, n, scale=1.0):
    return jnp.asarray(rng.normal(size=(n, 6)) * scale, jnp.float32)


def test_exp_log_roundtrip(rng):
    # Rotation angles kept below pi: log returns the principal value.
    xi = random_xi(rng, 64, scale=0.8)
    T = se3.se3_exp(xi)
    xi2 = se3.se3_log(T)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), rtol=1e-3, atol=1e-3)
    # For arbitrary transforms, exp(log(T)) must reproduce T.
    big = random_xi(rng, 64, scale=3.0)
    Tb = se3.se3_exp(big)
    Tb2 = se3.se3_exp(se3.se3_log(Tb))
    np.testing.assert_allclose(np.asarray(Tb2), np.asarray(Tb), atol=5e-3)


def test_exp_small_angle(rng):
    xi = random_xi(rng, 16, scale=1e-8)
    T = se3.se3_exp(xi)
    assert np.all(np.isfinite(np.asarray(T)))
    # exp(xi) ~ I + hat(xi) for tiny xi
    np.testing.assert_allclose(np.asarray(T[:, :3, 3]), np.asarray(xi[:, :3]), atol=1e-9)
    xi0 = se3.se3_log(jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (4, 4, 4)))
    np.testing.assert_allclose(np.asarray(xi0), 0.0, atol=1e-7)


def test_rotation_orthonormal(rng):
    T = se3.se3_exp(random_xi(rng, 32))
    R = np.asarray(T[:, :3, :3], np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_inv_matches_matrix_inverse(rng):
    T = se3.se3_exp(random_xi(rng, 8))
    Ti = se3.se3_inv(T)
    prod = np.asarray(T @ Ti)
    np.testing.assert_allclose(prod, np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


def test_retract_left_multiplicative(rng):
    T = se3.se3_exp(random_xi(rng, 4))
    d = random_xi(rng, 4, scale=0.1)
    np.testing.assert_allclose(
        np.asarray(se3.retract(T, d)), np.asarray(se3.se3_exp(d) @ T), atol=1e-6
    )


def test_retract_nan_guard(rng):
    """Non-finite updates must leave the pose unchanged (lego_types.h:62-67)."""
    T = se3.se3_exp(random_xi(rng, 3))
    d = jnp.stack([
        jnp.full((6,), jnp.nan, jnp.float32),
        jnp.zeros((6,), jnp.float32).at[0].set(jnp.inf),
        jnp.full((6,), 0.25, jnp.float32),
    ])
    out = np.asarray(se3.retract(T, d))
    # retract re-projects onto SO(3), so "unchanged" is up to machine epsilon.
    np.testing.assert_allclose(out[0], np.asarray(T[0]), atol=1e-6)
    np.testing.assert_allclose(out[1], np.asarray(T[1]), atol=1e-6)
    assert not np.allclose(out[2], np.asarray(T[2]))


def test_log_small_angles_fp32():
    """Float32 log must stay accurate for tiny relative transforms (the ATE
    error path takes logs of near-identity matrices)."""
    for theta in [1e-4, 1e-3, 1e-2, 0.04, 0.06, 0.3]:
        xi = jnp.asarray([0.01, -0.02, 0.005, theta, 0.0, 0.0], jnp.float32)
        back = np.asarray(se3.se3_log(se3.se3_exp(xi[None])))[0]
        assert np.all(np.isfinite(back))
        np.testing.assert_allclose(back, np.asarray(xi), rtol=2e-3, atol=2e-6)


def test_log_near_pi():
    axis = np.array([0.3, -0.5, 0.8])
    axis = axis / np.linalg.norm(axis)
    for angle in [np.pi - 1e-3, np.pi - 1e-5]:
        phi = jnp.asarray(axis * angle, jnp.float32)
        xi = jnp.concatenate([jnp.zeros(3, jnp.float32), phi])
        T = se3.se3_exp(xi[None])
        back = np.asarray(se3.se3_log(T))[0, 3:]
        np.testing.assert_allclose(back, axis * angle, atol=2e-3)


def test_transform_points(rng):
    T = se3.se3_exp(random_xi(rng, 1))[0]
    p = jnp.asarray(rng.normal(size=(10, 3)), jnp.float32)
    expected = (np.asarray(T[:3, :3]) @ np.asarray(p).T).T + np.asarray(T[:3, 3])
    np.testing.assert_allclose(np.asarray(se3.transform(T, p)), expected, atol=1e-5)


def test_rot_to_quat_roundtrip(rng):
    T = se3.se3_exp(random_xi(rng, 64))
    R = T[:, :3, :3]
    q = np.asarray(se3.rot_to_quat(R), np.float64)  # (x, y, z, w)
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
    # Rebuild rotation from quaternion and compare.
    x, y, z, w = q.T
    R2 = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    np.testing.assert_allclose(R2, np.asarray(R, np.float64), atol=1e-5)


def test_jit_and_vmap(rng):
    xi = random_xi(rng, 16)
    f = jax.jit(se3.se3_exp)
    np.testing.assert_allclose(np.asarray(f(xi)), np.asarray(se3.se3_exp(xi)), atol=1e-7)
    g = jax.vmap(se3.se3_log)
    np.testing.assert_allclose(np.asarray(g(se3.se3_exp(xi))), np.asarray(xi), rtol=1e-3, atol=1e-4)


def test_so3_project_restores_manifold(rng):
    """so3_project must pull a skewed near-rotation back to SO(3), and iterated
    compose+retract cycles must not accumulate orthonormality error (the
    round-1 long-horizon collapse: skew grew x2.4/frame through the
    rel = T_new @ inv(T_cur) feedback)."""
    R = np.asarray(se3.se3_exp(random_xi(rng, 8))[:, :3, :3])
    skew = R * (1.0 + rng.normal(size=(8, 3, 3)) * 3e-3)
    Rp = np.asarray(se3.so3_project(jnp.asarray(skew, jnp.float32)), np.float64)
    err = np.abs(Rp @ Rp.transpose(0, 2, 1) - np.eye(3)).max()
    assert err < 1e-6, err
    # Projection of an exact rotation is (nearly) the identity map.
    Rp2 = np.asarray(se3.so3_project(jnp.asarray(R, jnp.float32)), np.float64)
    np.testing.assert_allclose(Rp2, R, atol=1e-5)


def test_pose_composition_stays_on_manifold(rng):
    """Emulate 200 frames of the VO pose recurrence in float32; without the
    projection in retract this diverges off SO(3) within ~20 iterations."""
    T_cur = jnp.eye(4, dtype=jnp.float32)
    rel = jnp.eye(4, dtype=jnp.float32)
    for i in range(200):
        T_prior = se3.se3_orthonormalize(rel @ T_cur)
        dx = jnp.asarray(rng.normal(size=6) * 0.02, jnp.float32)
        T_new = se3.retract(T_prior, dx)
        rel = se3.se3_orthonormalize(T_new @ se3.se3_inv(T_cur))
        T_cur = T_new
    R = np.asarray(T_cur[:3, :3], np.float64)
    assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5
