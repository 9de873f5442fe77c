import os

import numpy as np
import pytest

from legoslam.utils import evaluation
from legoslam.utils.config import Config, DEFAULTS


def test_umeyama_recovers_transform(rng):
    x = rng.normal(size=(50, 3))
    R_true, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(R_true) < 0:
        R_true[:, 0] *= -1
    t_true = np.array([1.0, -2.0, 3.0])
    y = (R_true @ x.T).T + t_true
    R, t, c = evaluation.umeyama_alignment(x, y)
    np.testing.assert_allclose(R, R_true, atol=1e-8)
    np.testing.assert_allclose(t, t_true, atol=1e-8)
    assert abs(c - 1.0) < 1e-12


def test_ate_zero_for_rigidly_transformed(rng):
    gt = np.cumsum(rng.normal(size=(30, 3)) * 0.1, axis=0)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    est = (R @ gt.T).T + np.array([5.0, 1.0, -2.0])
    assert evaluation.ate_rmse(est, gt) < 1e-9
    # Unaligned comparison must see the offset.
    assert evaluation.ate_rmse(est, gt, align=False) > 1.0


def test_rpe(rng):
    poses = [np.eye(4)]
    for _ in range(10):
        T = poses[-1].copy()
        T[:3, 3] += [0.0, 0.0, 1.0]
        poses.append(T)
    t_err, r_err = evaluation.rpe_rmse(poses, poses)
    assert t_err < 1e-12 and r_err < 1e-9


def test_trajectory_roundtrip(tmp_path, rng):
    from legoslam.geometry import se3
    import jax.numpy as jnp

    poses = [np.asarray(se3.se3_exp(jnp.asarray(rng.normal(size=6) * 0.3, jnp.float32)), np.float64) for _ in range(5)]
    p = str(tmp_path / "traj.txt")
    evaluation.save_kitti_trajectory(p, poses)
    loaded = evaluation.load_kitti_trajectory(p)
    np.testing.assert_allclose(np.stack(loaded), np.stack(poses), atol=1e-6)
    evaluation.save_tum_trajectory(str(tmp_path / "t.txt"), range(5), poses)
    assert len(open(tmp_path / "t.txt").read().splitlines()) == 5


def test_config_yaml_and_defaults(tmp_path):
    y = tmp_path / "c.yaml"
    y.write_text("num_features: 99\ndataset_dir: /data/x\n")
    cfg = Config.from_yaml(str(y))
    assert cfg["num_features"] == 99
    assert cfg["dataset_dir"] == "/data/x"
    # untouched keys fall back to defaults
    assert cfg["chi2_threshold"] == DEFAULTS["chi2_threshold"]
    # reference-style static API (config.h:26-32)
    assert Config.set_parameter_file(str(y))
    assert Config.get("num_features") == 99
    o = cfg.override(num_features=7)
    assert o["num_features"] == 7 and cfg["num_features"] == 99


def test_reference_yaml_parses():
    """The repo's mirrors of the reference's KITTI configs load with the
    reference's values (cv::FileStorage-style flat YAML)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for seq, far in (("00", 200), ("05", 250)):
        cfg = Config.from_yaml(os.path.join(repo, "config", f"kitti_{seq}.yaml"))
        assert cfg["num_features"] == 150
        assert cfg["stereo_depth_superior_limit"] == far
        assert cfg["dataset_dir"].endswith(f"sequences/{seq}")
        assert cfg["image_scale"] == 0.5


def test_flat_yaml_parser():
    """config/*.yaml without PyYAML: directives, comments, scalar types;
    nested structures are refused rather than misread."""
    from legoslam.utils.config import parse_flat_yaml

    text = (
        "%YAML:1.0\n---\n# comment\nname: kitti  # trailing\n"
        "n: 150\nth: 5.991\neps: 1e-2\nflag: true\noff: False\n"
        "path: /data/x:y\nq: \"a b\"\n"
    )
    assert parse_flat_yaml(text) == {
        "name": "kitti", "n": 150, "th": 5.991, "eps": 0.01, "flag": True,
        "off": False, "path": "/data/x:y", "q": "a b",
    }
    for bad in ("camera:\n  fx: 1\n", "just text\n"):
        with pytest.raises(ValueError):
            parse_flat_yaml(bad)


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compilation_cache_dir_rule(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR when set (and then no directory is set in
    code); otherwise one fixed, git-ignored directory in the checkout."""
    import jax
    from pathlib import Path

    from legoslam.utils import jax_setup

    repo = Path(__file__).resolve().parents[1]
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = (jax.config.jax_compilation_cache_dir,
              jax.config.jax_persistent_cache_min_compile_time_secs)
    try:
        used = jax_setup.enable_compilation_cache()
        if env_dir:
            assert used == env_dir
            assert jax.config.jax_compilation_cache_dir == before[0]
        else:
            assert Path(used) == repo / ".jax_cache"
            assert jax.config.jax_compilation_cache_dir == used
            assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before[1])


def test_viewer_stream(tmp_path):
    """Live viewer stream: per-frame overlays, follow-mode map, GIF assembly
    (viewer.cpp:38-97's continuous redraw as headless artifacts)."""
    from legoslam.pipeline.viewer import Viewer

    rng = np.random.default_rng(0)
    vw = Viewer(every_n=2)
    H, W = 60, 80
    for i in range(6):
        T = np.eye(4)
        T[2, 3] = -0.3 * i  # camera moving forward
        img = rng.uniform(0, 255, (H, W)) if True else None
        uv = rng.uniform(5, 55, (20, 2))
        vw.add_current_frame(T, img=img, feature_uv=uv, feature_valid=np.ones(20, bool))
        if i % 3 == 0:
            kf = np.eye(4)[None].repeat(2, 0)
            vw.update_map(kf, np.ones(2, bool), rng.uniform(-5, 5, (50, 3)), np.ones(50, bool))
    paths = vw.save(str(tmp_path))
    names = [os.path.basename(p) for p in paths]
    assert "trajectory.png" in names
    assert any(n.startswith("frame_") for n in names)
    assert "tracking.gif" in names
    # every_n=2 over 6 frames -> 3 overlay frames
    assert sum(1 for n in names if n.startswith("frame_")) == 3
