"""Checkpoint/resume round-trip (utils/checkpoint.py).

The reference has no persistence (SURVEY §5); these tests pin down the
guarantee our redesign adds: a resumed VO continues the sequence with
bit-identical device state, so the remaining trajectory matches an
uninterrupted run exactly.
"""

import numpy as np
import pytest

from legoslam.pipeline.state import Capacities
from legoslam.pipeline.visual_odometry import VisualOdometry
from legoslam.utils import checkpoint
from legoslam.utils.config import Config

from tests.test_pipeline import SCENE_OVERRIDES, SMALL_CAPS, make_dataset


def _make_vo(dataset, inline_ba=False):
    config = Config(
        {
            "max_features": SMALL_CAPS.max_features,
            "keyframe_window_capacity": SMALL_CAPS.window,
            "max_active_landmarks": SMALL_CAPS.active_landmarks,
            "max_landmarks": SMALL_CAPS.landmarks,
            "num_active_keyframes": 7,
            **SCENE_OVERRIDES,
        }
    )
    vo = VisualOdometry(config=config, dataset=dataset, inline_ba=inline_ba)
    assert vo.init()
    return vo


def test_pytree_roundtrip(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4), "b": [np.asarray(3)]}
    p = str(tmp_path / "t.npz")
    checkpoint.save_pytree(p, tree, meta={"k": 1})
    out, meta = checkpoint.load_pytree(p, tree)
    assert meta == {"k": 1}
    np.testing.assert_array_equal(out["a"], tree["a"])
    np.testing.assert_array_equal(out["b"][0], tree["b"][0])


def test_pytree_shape_mismatch_fails(tmp_path):
    p = str(tmp_path / "t.npz")
    checkpoint.save_pytree(p, {"a": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="leaf 0"):
        checkpoint.load_pytree(p, {"a": np.zeros((3, 3))})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(p, {"a": np.zeros((2, 2)), "b": np.zeros(1)})


def test_vo_resume_matches_uninterrupted_run(tmp_path):
    n = 12
    # Reference run: all n frames in one go.
    vo_full = _make_vo(make_dataset(n_frames=n))
    vo_full.run()
    full_traj = vo_full.trajectory_T_cw()

    # Checkpointed run: stop after 6 frames, save, resume in a fresh VO.
    vo_a = _make_vo(make_dataset(n_frames=n))
    for _ in range(6):
        assert vo_a.step()
    ckpt = str(tmp_path / "vo.npz")
    vo_a.save_checkpoint(ckpt)

    vo_b = _make_vo(make_dataset(n_frames=n))
    vo_b.load_checkpoint(ckpt)
    assert vo_b.dataset.current_index == 6
    assert len(vo_b.outputs) == 6
    vo_b.run()

    resumed_traj = vo_b.trajectory_T_cw()
    assert resumed_traj.shape == full_traj.shape
    np.testing.assert_allclose(resumed_traj, full_traj, rtol=0, atol=1e-5)
    assert vo_b.frame_ids == vo_full.frame_ids


def test_vo_checkpoint_requires_state(tmp_path):
    vo = _make_vo(make_dataset(n_frames=3))
    with pytest.raises(ValueError, match="no frames"):
        vo.save_checkpoint(str(tmp_path / "x.npz"))
