import jax.numpy as jnp
import numpy as np

from legoslam.solver import robust


def _huber_ref(e2, delta):
    d2 = delta * delta
    if e2 <= d2:
        return e2, 1.0, 0.0
    s = np.sqrt(e2)
    return 2 * s * delta - d2, delta / s, -0.5 * (delta / s) / e2


def test_huber_matches_reference():
    delta = 5.991
    for e2 in [0.0, 1.0, 35.0, 36.0, 100.0, 1e4]:
        r0, r1, r2 = robust.rho(robust.HUBER, jnp.asarray([e2], jnp.float64), delta)
        g0, g1, g2 = _huber_ref(e2, delta)
        np.testing.assert_allclose([float(r0[0]), float(r1[0]), float(r2[0])], [g0, g1, g2], rtol=1e-6)


def test_cauchy_tukey_shapes_and_continuity():
    e2 = jnp.linspace(0.0, 100.0, 1001, dtype=jnp.float64)
    for kind in [robust.CAUCHY, robust.TUKEY]:
        r0, r1, r2 = robust.rho(kind, e2, 3.0)
        assert np.all(np.isfinite(np.asarray(r0)))
        # rho is monotone non-decreasing in e2
        assert np.all(np.diff(np.asarray(r0)) >= -1e-9)
        # rho' in [0, 1]
        assert np.all(np.asarray(r1) <= 1.0 + 1e-9) and np.all(np.asarray(r1) >= -1e-9)


def test_trivial_identity():
    e2 = jnp.asarray([0.5, 2.0])
    r0, r1, r2 = robust.rho(robust.TRIVIAL, e2, 123.0)
    np.testing.assert_allclose(np.asarray(r0), np.asarray(e2))
    np.testing.assert_allclose(np.asarray(r1), 1.0)
    np.testing.assert_allclose(np.asarray(r2), 0.0)


def test_robust_information_inlier_is_information():
    r = jnp.asarray([[0.5, -0.3]], jnp.float32)  # chi2 well below delta^2
    drho, W = robust.robust_information(robust.HUBER, r, 5.991)
    np.testing.assert_allclose(np.asarray(drho), 1.0)
    np.testing.assert_allclose(np.asarray(W[0]), np.eye(2), atol=1e-6)


def test_robust_information_outlier_psd_guard():
    """For Huber outliers rho' + 2 rho'' e2 = 0, so the rank-1 term must be
    dropped (base_edge.cpp:55) leaving rho' * Lambda."""
    r = jnp.asarray([[100.0, 0.0]], jnp.float32)
    drho, W = robust.robust_information(robust.HUBER, r, 5.991)
    e2 = 1e4
    expected = 5.991 / np.sqrt(e2)
    np.testing.assert_allclose(np.asarray(W[0]), expected * np.eye(2), rtol=1e-5)
    # eigenvalues non-negative
    ev = np.linalg.eigvalsh(np.asarray(W[0], np.float64))
    assert np.all(ev >= -1e-8)
