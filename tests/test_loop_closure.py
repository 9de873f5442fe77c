"""Loop closure (pipeline/loop_closure.py): geometric verification on a
synthetic revisit.

The reference declares loop closure its north-star TODO (CMakeLists.txt:74-77)
and ships only stubs; these tests gate the pipeline this repo adds."""

import numpy as np
import pytest

from legoslam.pipeline.dataset import SyntheticPlanesDataset
from legoslam.pipeline.loop_closure import (
    KeyframeRecord,
    LoopCloser,
    LoopConfig,
    make_thumbnail,
)

SHAPE = (160, 240)
FOCAL = 260.0


def _make_record(frame_id, img_full, T_cw, uv=None, p_world=None, max_feats=256):
    """Build a KeyframeRecord the way LoopCloser.add_keyframe does."""
    img = img_full[::2, ::2].astype(np.float32)
    uv_p = np.zeros((max_feats, 2), np.float32)
    pw_p = np.zeros((max_feats, 3), np.float32)
    n = 0
    if uv is not None:
        n = min(len(uv), max_feats)
        uv_p[:n] = uv[:n] * 0.5
        pw_p[:n] = p_world[:n]
    T64 = np.asarray(T_cw, np.float64)
    return KeyframeRecord(
        frame_id=frame_id, T_cw=T64.copy(), T_cw_obs=T64.copy(),
        rel_prev=np.eye(4),
        thumb=make_thumbnail(img),
        img=np.clip(img, 0.0, 255.0).astype(np.uint8),
        uv=uv_p, p_world=pw_p, n_feats=n,
    )


def _grid_features(ds, T_wc, step=12):
    """Full-res pixel grid + exact world points from the renderer's depth."""
    H, W = SHAPE
    img, depth = ds._render_with_depth(T_wc, ds.rig.left)
    us, vs = np.meshgrid(np.arange(20, W - 20, step), np.arange(20, H - 20, step))
    uv = np.stack([us.ravel(), vs.ravel()], axis=-1).astype(np.float64)
    z = depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
    ok = np.isfinite(z) & (z < 60)
    uv, z = uv[ok], z[ok]
    cx, cy = W / 2.0, H / 2.0
    p_cam = np.stack(
        [(uv[:, 0] - cx) / FOCAL * z, (uv[:, 1] - cy) / FOCAL * z, z], axis=-1
    )
    p_world = p_cam @ T_wc[:3, :3].T + T_wc[:3, 3]
    return img, uv, p_world


def test_verify_recovers_relative_pose():
    """_verify: KLT re-track + robust pose solve on a revisit recovers the
    candidate->current transform (frontend_g2o.cpp:157-245's machinery re-used
    for loop verification)."""
    ds = SyntheticPlanesDataset(n_frames=2, shape=SHAPE, focal=FOCAL, baseline=0.54)
    ds.init()
    T_wc_A = np.eye(4)
    yaw = np.deg2rad(2.0)
    c, s = np.cos(yaw), np.sin(yaw)
    T_wc_B = np.eye(4)
    T_wc_B[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T_wc_B[:3, 3] = [0.05, 0.0, 0.4]

    imgA, uvA, pwA = _grid_features(ds, T_wc_A)
    imgB = ds._render(T_wc_B, ds.rig.left)

    lc = LoopCloser(ds.rig, LoopConfig())
    lc.records = [
        _make_record(0, imgA, np.linalg.inv(T_wc_A), uvA, pwA),
        _make_record(1, imgB, np.linalg.inv(T_wc_B)),
    ]
    ok, M, n_in = lc._verify(0)
    assert ok, f"verification rejected ({n_in} inliers)"
    assert n_in >= 50, n_in
    M_true = np.linalg.inv(T_wc_B) @ T_wc_A
    assert np.linalg.norm(M[:3, 3] - M_true[:3, 3]) < 0.08
    # rotation error (angle of M_true^-1 M)
    dR = M_true[:3, :3].T @ M[:3, :3]
    ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    assert ang < np.deg2rad(0.5), np.rad2deg(ang)


def test_verify_rejects_unrelated_view():
    """A candidate showing different geometry must fail verification, not
    produce a spurious closure."""
    ds = SyntheticPlanesDataset(n_frames=2, shape=SHAPE, focal=FOCAL, baseline=0.54)
    ds.init()
    T_wc_A = np.eye(4)
    # Far down the corridor AND yawed: different walls fill the view.
    yaw = np.deg2rad(40.0)
    c, s = np.cos(yaw), np.sin(yaw)
    T_wc_B = np.eye(4)
    T_wc_B[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T_wc_B[:3, 3] = [2.0, 0.0, 60.0]

    imgA, uvA, pwA = _grid_features(ds, T_wc_A)
    imgB = ds._render(T_wc_B, ds.rig.left)
    lc = LoopCloser(ds.rig, LoopConfig())
    lc.records = [
        _make_record(0, imgA, np.linalg.inv(T_wc_A), uvA, pwA),
        _make_record(1, imgB, np.linalg.inv(T_wc_B)),
    ]
    ok, _, n_in = lc._verify(0)
    assert not ok, f"unrelated view verified with {n_in} inliers"


def loop_trajectory(side=32, turn=24, speed=0.3, tail=28, laps=1):
    """A rounded-square lap (4 straights + 4 raised-cosine 90-degree turns)
    whose tail re-drives the first straight: the discrete lap closes exactly,
    so tail frames revisit early poses with matched heading.  The smooth
    yaw-rate profile keeps angular acceleration physical (~1 deg/frame^2) —
    a kinked profile breaks the constant-velocity motion prior the tracker
    seeds from, which no real vehicle trajectory does.  `laps` > 1 re-drives
    the whole square, exercising repeated closures."""
    r = np.arange(turn)
    w = 0.5 * (1 - np.cos(2 * np.pi * (r + 0.5) / turn))
    w = w * (np.pi / 2 / w.sum())
    dyaws = []
    for _ in range(4 * laps):
        dyaws.append(np.zeros(side))
        dyaws.append(w)
    dyaws.append(np.zeros(tail))
    poses, pos, yaw = [], np.zeros(3), 0.0
    for dy in np.concatenate(dyaws):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T.copy())
        pos = pos + R @ np.array([0.0, 0.0, speed])
        yaw += dy
    return np.stack(poses)


@pytest.mark.slow
def test_loop_closure_end_to_end():
    """A loop-shaped trajectory with loop closure enabled must detect and
    verify at least one closure and reduce both the keyframe-trajectory ATE
    (the quantity the pose graph corrects) and the full-trajectory ATE vs the
    open-loop run.  The open arm runs the identical pipeline with the
    detector gated shut (zncc_min > 1), so the comparison is same-code."""
    import jax  # noqa: F401  (ensures CPU backend is initialized first)

    from legoslam.pipeline.visual_odometry import VisualOdometry
    from legoslam.utils import evaluation
    from legoslam.utils.config import Config

    traj = loop_trajectory()
    base = {
        "max_features": 320,
        "keyframe_window_capacity": 8,
        "max_active_landmarks": 1536,
        "max_landmarks": 16384,
        "num_active_keyframes": 7,
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 50.0,
        "detect_mask_half": 6,
        "gftt_min_distance": 6,
        "use_loop_closure": True,
    }
    res = {}
    for zncc in (1.1, 0.5):
        ds = SyntheticPlanesDataset(
            shape=SHAPE, focal=FOCAL, baseline=0.54,
            half_width=20.0, length=30.0, z_min=-25.0, trajectory=traj,
        )
        vo = VisualOdometry(config=Config({**base, "loop_zncc_min": zncc}), dataset=ds)
        assert vo.init()
        vo.run()
        est = vo.trajectory_T_wc()
        full_ate = evaluation.ate_rmse(est[:, :3, 3], traj[: len(est), :3, 3])
        ids, kf_T_cw = vo.keyframe_trajectory()
        kf_wc = np.linalg.inv(kf_T_cw)
        kf_ate = evaluation.ate_rmse(kf_wc[:, :3, 3], traj[ids][:, :3, 3])
        res[zncc] = (full_ate, kf_ate, dict(vo.loop_closer.stats))
    open_full, open_kf, open_stats = res[1.1]
    closed_full, closed_kf, closed_stats = res[0.5]
    assert open_stats["closures"] == 0
    assert closed_stats["closures"] >= 1, closed_stats
    assert closed_kf < open_kf, (closed_kf, open_kf)
    assert closed_full < open_full, (closed_full, open_full)


@pytest.mark.slow
def test_loop_closure_two_laps():
    """Two full laps: repeated revisits must produce MULTIPLE accepted
    closures (exercising the cooldown, re-verification against corrected
    records, and the immutable-measurement pose graph across corrections)
    and still beat the open-loop trajectory.  Guards the loop-closure
    machinery's long-horizon behavior (CMakeLists.txt:74-77 north star)."""
    from legoslam.pipeline.visual_odometry import VisualOdometry
    from legoslam.utils import evaluation
    from legoslam.utils.config import Config

    traj = loop_trajectory(laps=2)
    base = {
        "max_features": 320,
        "keyframe_window_capacity": 8,
        "max_active_landmarks": 1536,
        "max_landmarks": 16384,
        "num_active_keyframes": 7,
        "stereo_depth_inferior_limit": 2.0,
        "stereo_depth_superior_limit": 50.0,
        "detect_mask_half": 6,
        "gftt_min_distance": 6,
        "use_loop_closure": True,
    }
    res = {}
    for zncc in (1.1, 0.5):
        ds = SyntheticPlanesDataset(
            shape=SHAPE, focal=FOCAL, baseline=0.54,
            half_width=20.0, length=30.0, z_min=-25.0, trajectory=traj,
        )
        vo = VisualOdometry(config=Config({**base, "loop_zncc_min": zncc}), dataset=ds)
        assert vo.init()
        vo.run()
        est = vo.trajectory_T_wc()
        full_ate = evaluation.ate_rmse(est[:, :3, 3], traj[: len(est), :3, 3])
        ids, kf_T_cw = vo.keyframe_trajectory()
        kf_wc = np.linalg.inv(kf_T_cw)
        kf_ate = evaluation.ate_rmse(kf_wc[:, :3, 3], traj[ids][:, :3, 3])
        res[zncc] = (full_ate, kf_ate, dict(vo.loop_closer.stats))
    open_full, open_kf, _ = res[1.1]
    closed_full, closed_kf, closed_stats = res[0.5]
    assert closed_stats["closures"] >= 2, closed_stats
    assert closed_kf < open_kf, (closed_kf, open_kf)
    assert closed_full < open_full, (closed_full, open_full)
