"""Trajectory evaluation and export.

The reference validates KITTI trajectories only visually (SURVEY section 6);
BASELINE.json makes ATE RMSE the headline metric, so this module provides:
Umeyama SE(3) alignment, ATE RMSE, RPE, and KITTI / TUM trajectory export —
the checkpoint/export gap called out in SURVEY section 5.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def umeyama_alignment(x: np.ndarray, y: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment y ~ c R x + t over (N, 3) point sets.

    Returns (R, t, c). Classic Umeyama (1991) closed form.
    """
    x = np.asarray(x, np.float64).T  # (3, N)
    y = np.asarray(y, np.float64).T
    mx, my = x.mean(axis=1, keepdims=True), y.mean(axis=1, keepdims=True)
    xc, yc = x - mx, y - my
    n = x.shape[1]
    cov = yc @ xc.T / n
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / n
        c = float(np.trace(np.diag(d) @ S) / var_x)
    else:
        c = 1.0
    t = my - c * R @ mx
    return R, t[:, 0], c


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (N, 3) position sequences."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape, (est.shape, gt.shape)
    if align:
        R, t, c = umeyama_alignment(est, gt)
        est = (c * (R @ est.T) + t[:, None]).T
    err = est - gt
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est_poses: Sequence[np.ndarray], gt_poses: Sequence[np.ndarray], delta: int = 1) -> Tuple[float, float]:
    """Relative pose error over (N, 4, 4) world-from-camera pose sequences.

    Returns (translation RMSE in meters, rotation RMSE in degrees) over all
    pairs (i, i+delta).
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    t_errs, r_errs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(e[:3, 3]))
        cos = min(1.0, max(-1.0, (np.trace(e[:3, :3]) - 1.0) / 2.0))
        r_errs.append(np.degrees(np.arccos(cos)))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(np.sqrt(np.mean(np.square(r_errs))))


def drift_rate(
    est_poses: np.ndarray, gt_poses: np.ndarray, segment_m: float = 100.0
) -> float:
    """Open-loop drift in meters per `segment_m` meters traveled (the KITTI
    odometry-benchmark style metric, complementing ATE for long sequences).

    For every start index, find the frame where ground-truth path length
    first exceeds `segment_m` (or use the remaining tail if the sequence is
    shorter), express both trajectories relative to the segment start, and
    measure the endpoint translation error normalized by traveled distance.
    Returns the mean over all segments, scaled to meters per segment_m.
    """
    est = np.asarray(est_poses, np.float64)
    gt = np.asarray(gt_poses, np.float64)
    step = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(step)])
    errs = []
    for i in range(len(gt) - 1):
        target = cum[i] + segment_m
        j = int(np.searchsorted(cum, target))
        j = min(j, len(gt) - 1)
        dist = cum[j] - cum[i]
        if dist < 1e-6:
            continue
        de = np.linalg.inv(est[i]) @ est[j]
        dg = np.linalg.inv(gt[i]) @ gt[j]
        err = np.linalg.norm(de[:3, 3] - dg[:3, 3])
        errs.append(err / dist)
        if j == len(gt) - 1 and dist < segment_m:
            break
    return float(np.mean(errs) * segment_m) if errs else 0.0


def save_kitti_trajectory(path: str, poses_wc: Sequence[np.ndarray]) -> None:
    """Write world-from-camera poses as KITTI 12-number rows."""
    with open(path, "w") as f:
        for T in poses_wc:
            f.write(" ".join(f"{v:.9e}" for v in np.asarray(T)[:3, :].reshape(-1)) + "\n")


def save_tum_trajectory(path: str, timestamps: Sequence[float], poses_wc: Sequence[np.ndarray]) -> None:
    """Write TUM format: t x y z qx qy qz qw."""
    from legoslam.geometry import se3
    import jax.numpy as jnp

    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_wc):
            T = np.asarray(T, np.float64)
            q = np.asarray(se3.rot_to_quat(jnp.asarray(T[:3, :3])))
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} {q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def load_kitti_trajectory(path: str) -> List[np.ndarray]:
    poses = []
    with open(path) as f:
        for line in f:
            vals = np.fromstring(line, sep=" ")
            if vals.size != 12:
                continue
            T = np.eye(4)
            T[:3, :] = vals.reshape(3, 4)
            poses.append(T)
    return poses
