import jax.numpy as jnp
import numpy as np

from legoslam.geometry import se3, triangulation
from legoslam.geometry.camera import Camera, StereoRig


def test_reference_three_view_case():
    """Mirror of the reference's only unit test
    (test/legoslam_test_triangulation.cpp:5-23): a world point at (30, 20, 10)
    seen from three identity-rotation cameras at y in {0, -10, +10} must be
    recovered within 0.01 per axis."""
    pt = np.array([30.0, 20.0, 10.0])
    offsets = [0.0, -10.0, 10.0]
    poses = []
    obs = []
    for dy in offsets:
        T = np.eye(4)
        T[1, 3] = dy  # camera-from-world translation
        p_cam = T[:3, :3] @ pt + T[:3, 3]
        obs.append(p_cam[:2] / p_cam[2])
        poses.append(T)
    poses = jnp.asarray(np.stack(poses), jnp.float32)
    pts_norm = jnp.asarray(np.stack(obs)[None], jnp.float32)  # (1, 3, 2)
    est, ok = triangulation.triangulate(poses, pts_norm)
    assert bool(ok[0])
    np.testing.assert_allclose(np.asarray(est[0]), pt, atol=0.01)


def test_batched_stereo(rng):
    baseline = 0.54
    right_pose = np.eye(4)
    right_pose[0, 3] = -baseline
    pts = rng.uniform([-20, -5, 4], [20, 2, 80], size=(256, 3))
    uvl = pts[:, :2] / pts[:, 2:3]
    p_r = pts + right_pose[:3, 3]
    uvr = p_r[:, :2] / p_r[:, 2:3]
    est, ok = triangulation.triangulate_stereo(
        jnp.eye(4), jnp.asarray(right_pose, jnp.float32),
        jnp.asarray(uvl, jnp.float32), jnp.asarray(uvr, jnp.float32))
    assert np.asarray(ok).mean() > 0.95
    good = np.asarray(ok)
    np.testing.assert_allclose(np.asarray(est)[good], pts[good], rtol=2e-2, atol=5e-2)


def test_degenerate_rejected():
    """Zero-baseline observations leave the depth unconstrained -> gate must fire
    (singular-ratio check, algorithm.h:29-33)."""
    T = jnp.eye(4)
    uv = jnp.asarray([[0.1, 0.2]], jnp.float32)
    _, ok = triangulation.triangulate_stereo(T, T, uv, uv)
    assert not bool(ok[0])


def test_camera_roundtrip(rng):
    cam = Camera.create(fx=718.0, fy=718.0, cx=607.0, cy=185.0)
    T_cw = se3.se3_exp(jnp.asarray(rng.normal(size=(6,)) * 0.1, jnp.float32))
    p_w = jnp.asarray(rng.uniform([-5, -5, 5], [5, 5, 50], size=(32, 3)), jnp.float32)
    uv = cam.world2pixel(p_w, T_cw)
    depth = cam.world2camera(p_w, T_cw)[:, 2]
    back = cam.pixel2world(uv, T_cw, depth)
    np.testing.assert_allclose(np.asarray(back), np.asarray(p_w), rtol=1e-3, atol=1e-3)


def test_kitti_rig_parsing():
    # KITTI 00 calib rows (P0 and P1).
    P0 = np.array([
        [718.856, 0.0, 607.1928, 0.0],
        [0.0, 718.856, 185.2157, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ])
    P1 = P0.copy()
    P1[0, 3] = -386.1448  # = -fx * baseline
    rig = StereoRig.from_kitti_projections(P0, P1, scale=0.5)
    # K scaled by 0.5 (dataset.cpp:40)
    np.testing.assert_allclose(float(rig.left.fx), 718.856 * 0.5, rtol=1e-6)
    # baseline = ||K^-1 p4|| (dataset.cpp:39-42)
    np.testing.assert_allclose(float(rig.right.baseline), 386.1448 / 718.856, rtol=1e-5)
    # right extrinsic is a pure translation along -x
    t = np.asarray(rig.right.pose)[:3, 3]
    np.testing.assert_allclose(t, [-386.1448 / 718.856, 0, 0], atol=1e-6)


def test_fast_matches_svd_on_stereo_batch(rng):
    """The closed-form path (adjugate null vector + deflated-cubic sigmas,
    the default) must reproduce the SVD reference: identical gates and
    matching points over a realistic noisy stereo batch."""
    from legoslam.geometry import triangulation as tri

    n = 1024
    fx, b = 360.0, 0.54
    Tl = jnp.eye(4, dtype=jnp.float32)
    Tr = Tl.at[0, 3].set(-b)
    z = rng.uniform(1.0, 120.0, n)
    P = np.stack([rng.uniform(-0.8, 0.8, n) * z, rng.uniform(-0.3, 0.3, n) * z, z], -1)
    pl = P[:, :2] / P[:, 2:3]
    Pr = P.copy()
    Pr[:, 0] -= b
    pr = Pr[:, :2] / Pr[:, 2:3]
    pl_n = jnp.asarray(pl + rng.normal(0, 0.3 / fx, (n, 2)), jnp.float32)
    pr_n = jnp.asarray(pr + rng.normal(0, 0.3 / fx, (n, 2)), jnp.float32)

    pt_f, ok_f = tri.triangulate_stereo(Tl, Tr, pl_n, pr_n, 1e-3, method="fast")
    pt_s, ok_s = tri.triangulate_stereo(Tl, Tr, pl_n, pr_n, 1e-3, method="svd")
    ok_f, ok_s = np.asarray(ok_f), np.asarray(ok_s)
    # Gates agree except possibly within a whisker of the ratio threshold.
    assert (ok_f == ok_s).mean() > 0.99
    both = ok_f & ok_s
    assert both.sum() > 100
    err = np.linalg.norm(np.asarray(pt_f)[both] - np.asarray(pt_s)[both], axis=-1)
    rel = err / np.linalg.norm(np.asarray(pt_s)[both], axis=-1)
    assert np.median(rel) < 1e-4 and rel.max() < 5e-3
