"""1,000-frame KITTI-format soak through the REAL ingestion + CLI path.

VERDICT round 4 "what's missing" 3 / "next round" 8: the reference's entire
results section is 4,500+ KITTI frames (README.md:90-104); KITTI imagery is
absent on this machine, so this fabricates a 1,000-frame KITTI-format
sequence on disk — photometric noise, occluders, S-curve turns — and runs it
through `apps/run_kitti.py` end to end (KittiDataset + native prefetch
loader when it builds, dataset.cpp:13-86 format), gating on drift rate in
meters per 100 m of path.
"""

import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from legoslam.pipeline.dataset import SyntheticPlanesDataset
from tests.test_kitti_path import _write_png

# KITTI-shaped: written full-res, ingested at half -> (188, 620), the
# production shape the default config is tuned for (dataset.cpp:76).
FULL_SHAPE = (376, 1240)
FOCAL = 720.0
BASELINE = 0.54
N_FRAMES = 1000
SPEED = 0.3

# The 1,000-frame 376x1240 render is ~1 h single-threaded, which made the
# soak un-runnable inside most CI budgets.  Frame i is a pure function of the
# trajectory + index (the photometric noise rng is seeded per index), so the
# render fans out over processes bit-identically, and the finished sequence
# is cached in a stable path keyed by the generator parameters — repeat runs
# skip the render entirely.
CACHE_ROOT = pathlib.Path(
    os.environ.get("LEGOSLAM_SOAK_CACHE", "/tmp/legoslam_soak_seq_v1")
) / "07"


def _make_dataset(traj):
    return SyntheticPlanesDataset(
        shape=FULL_SHAPE, focal=FOCAL, baseline=BASELINE,
        half_width=12.0, length=N_FRAMES * SPEED + 60.0, z_min=-20.0,
        trajectory=traj,
        n_occluders=6, photometric_noise=1.5,
    )


def _render_chunk(root, traj, lo, hi):
    """Worker: render + write frames [lo, hi) (deterministic per index)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    ds = _make_dataset(traj)
    ds.init()
    ds.current_index = lo
    root = pathlib.Path(root)
    for i in range(lo, hi):
        fr = ds.next_frame()
        _write_png(str(root / "image_0" / f"{i:06d}.png"), fr.left)
        _write_png(str(root / "image_1" / f"{i:06d}.png"), fr.right)
    return hi - lo


def _s_curve_trajectory(n=N_FRAMES, speed=SPEED):
    """Forward drive with gentle alternating yaw (lateral excursion stays
    well inside the corridor): real-vehicle-like smooth turns."""
    k = np.arange(n)
    dyaw = 0.0018 * np.sin(2 * np.pi * k / 320.0)
    poses, pos, yaw = [], np.zeros(3), 0.0
    for dy in dyaw:
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = pos
        poses.append(T.copy())
        pos = pos + R @ np.array([0.0, 0.0, speed])
        yaw += dy
    return np.stack(poses)


@pytest.fixture(scope="module")
def soak_dir():
    root = CACHE_ROOT
    traj = _s_curve_trajectory()
    if (root / "COMPLETE").exists():
        return str(root), traj
    (root / "image_0").mkdir(parents=True, exist_ok=True)
    (root / "image_1").mkdir(exist_ok=True)
    H, W = FULL_SHAPE
    cx, cy = W / 2.0, H / 2.0
    P0 = f"P0: {FOCAL} 0 {cx} 0 0 {FOCAL} {cy} 0 0 0 1 0"
    P1 = f"P1: {FOCAL} 0 {cx} {-FOCAL * BASELINE} 0 {FOCAL} {cy} 0 0 0 1 0"
    (root / "calib.txt").write_text(P0 + "\n" + P1 + "\n")
    np.savetxt(root / "poses.txt", np.stack([traj[i][:3].reshape(-1)
                                             for i in range(N_FRAMES)]))
    # spawn (not fork): the parent's initialized JAX runtime must not be
    # forked into the render workers.
    workers = min(8, os.cpu_count() or 1)
    chunk = -(-N_FRAMES // workers)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        done = pool.starmap(
            _render_chunk,
            [(str(root), traj, lo, min(lo + chunk, N_FRAMES))
             for lo in range(0, N_FRAMES, chunk)],
        )
    assert sum(done) == N_FRAMES
    (root / "COMPLETE").write_text("ok\n")
    return str(root), traj


@pytest.mark.slow
def test_kitti_soak_1000_frames(soak_dir, tmp_path):
    root, gt = soak_dir
    out_dir = str(tmp_path / "out")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "apps", "run_kitti.py"),
         "--dataset_dir", root, "--out_dir", out_dir],
        capture_output=True, text=True, timeout=3600, env=env, cwd=repo,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    traj_path = os.path.join(out_dir, "trajectory_kitti.txt")
    assert os.path.exists(traj_path), proc.stderr[-2000:]
    est = np.loadtxt(traj_path).reshape(-1, 3, 4)
    assert len(est) == N_FRAMES, len(est)
    pos = est[:, :, 3]
    gt_pos = gt[:, :3, 3]
    # Drift rate: error at the end of each 100 m of path, per 100 m.
    path = np.concatenate([[0.0], np.cumsum(
        np.linalg.norm(np.diff(gt_pos, axis=0), axis=1))])
    total = path[-1]
    assert total > 250.0, total
    final_err = np.linalg.norm(pos[-1] - gt_pos[-1])
    drift_per_100m = final_err / total * 100.0
    ate = float(np.sqrt(np.mean(np.sum((pos - gt_pos) ** 2, axis=1))))
    print(f"\nsoak: {N_FRAMES} frames, path {total:.0f} m, ATE {ate:.2f} m, "
          f"final error {final_err:.2f} m -> drift {drift_per_100m:.2f} m/100m")
    assert drift_per_100m < 2.0, (drift_per_100m, final_err, total)
