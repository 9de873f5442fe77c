"""Async backend tests: solve/merge decomposition equals the synchronous
cycle, merge reconciles a moved-on map, and the overlapped schedule holds the
pipeline ATE gates (the reference's frontend/backend thread split,
backend_lego.cpp:38-54, rebuilt as pipeline/async_backend.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legoslam.pipeline import backend as backend_mod
from legoslam.pipeline.async_backend import AsyncBackend, pick_ba_device
from legoslam.pipeline.visual_odometry import FrontendStatus, VisualOdometry
from legoslam.utils import evaluation
from legoslam.utils.config import Config
from tests.test_backend import init_state
from tests.test_pipeline import SCENE_OVERRIDES, SMALL_CAPS, make_dataset


def _tree_equal(a, b):
    la, _ = jax.tree_util.tree_flatten(a)
    lb, _ = jax.tree_util.tree_flatten(b)
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def test_solve_plus_merge_equals_ba_step(init_state):
    """Applying a BAResult to the unchanged snapshot is exactly the
    synchronous write-back."""
    ds, cfg, feats, wmap = init_state
    ba_cfg = backend_mod.BAConfig(iterations=4)
    wmap_sync, stats_sync = backend_mod.ba_step(cfg, ds.rig, wmap, ba_cfg)
    result = backend_mod.solve_window(cfg, ds.rig, wmap, ba_cfg)
    wmap_async = backend_mod.merge_ba_result(wmap, result)
    assert _tree_equal(wmap_sync, wmap_async)
    assert float(stats_sync.chi) == float(result.stats.chi)


def test_merge_respects_moved_on_map(init_state):
    """While a solve is in flight the frontend may recycle window slots and
    allocate landmarks; the merge must only touch snapshot-owned state."""
    ds, cfg, feats, wmap = init_state
    result = backend_mod.solve_window(cfg, ds.rig, wmap, backend_mod.BAConfig(iterations=4))

    # Move the map on: recycle keyframe slot 1 with a new keyframe (as
    # evict+insert would), and allocate one new landmark.
    slot = 1
    new_pose = jnp.eye(4).at[0, 3].set(7.0)
    lm_new = int(wmap.lm_next)
    moved = wmap._replace(
        kf_valid=wmap.kf_valid.at[slot].set(True),
        kf_id=wmap.kf_id.at[slot].set(wmap.next_kf_id),
        kf_frame_id=wmap.kf_frame_id.at[slot].set(99),
        kf_pose=wmap.kf_pose.at[slot].set(new_pose),
        next_kf_id=wmap.next_kf_id + 1,
        lm_pos=wmap.lm_pos.at[lm_new].set(jnp.asarray([1.0, 2.0, 3.0])),
        lm_alive=wmap.lm_alive.at[lm_new].set(True),
        lm_next=wmap.lm_next + 1,
    )
    merged = backend_mod.merge_ba_result(moved, result)

    # The recycled slot keeps its new pose (snapshot id does not match).
    np.testing.assert_array_equal(np.asarray(merged.kf_pose[slot]), np.asarray(new_pose))
    # Slot 0 (unchanged since the snapshot) takes the optimized pose.
    np.testing.assert_array_equal(
        np.asarray(merged.kf_pose[0]), np.asarray(result.poses[0])
    )
    # The newborn landmark is untouched.
    np.testing.assert_array_equal(
        np.asarray(merged.lm_pos[lm_new]), np.asarray(moved.lm_pos[lm_new])
    )
    # Optimized landmarks are written back.
    ids = np.asarray(result.active_ids)
    pv = np.asarray(result.point_valid) & (ids >= 0)
    assert pv.any()
    np.testing.assert_array_equal(
        np.asarray(merged.lm_pos)[ids[pv]], np.asarray(result.points)[pv]
    )


def test_merge_after_reset_is_a_noop(init_state):
    """A LOST Reset wipes the map; a late-arriving solve must not write into
    the re-initialized world (kf_frame_id guards keyframe-id reuse)."""
    from legoslam.pipeline.state import WorldMap

    ds, cfg, feats, wmap = init_state
    result = backend_mod.solve_window(cfg, ds.rig, wmap, backend_mod.BAConfig(iterations=4))
    fresh = WorldMap.empty(cfg.caps)
    # Re-init from a different frame: same kf_id 0, different frame id.
    fresh = fresh._replace(
        kf_valid=fresh.kf_valid.at[0].set(True),
        kf_id=fresh.kf_id.at[0].set(0),
        kf_frame_id=fresh.kf_frame_id.at[0].set(50),
        next_kf_id=jnp.asarray(1, jnp.int32),
    )
    merged = backend_mod.merge_ba_result(fresh, result)
    np.testing.assert_array_equal(np.asarray(merged.kf_pose), np.asarray(fresh.kf_pose))
    np.testing.assert_array_equal(np.asarray(merged.lm_obs), np.asarray(fresh.lm_obs))


def _run_async_vo(ds, ba_async_device):
    config = Config(
        {
            "max_features": SMALL_CAPS.max_features,
            "keyframe_window_capacity": SMALL_CAPS.window,
            "max_active_landmarks": SMALL_CAPS.active_landmarks,
            "max_landmarks": SMALL_CAPS.landmarks,
            "num_active_keyframes": 7,
            "ba_mode": "async",
            "ba_async_device": ba_async_device,
            **SCENE_OVERRIDES,
        }
    )
    vo = VisualOdometry(config=config, dataset=ds)
    assert vo.init()
    assert vo.async_backend is not None
    vo.run()
    return vo


@pytest.mark.parametrize("ba_async_device", ["none", "auto"])
def test_vo_async_end_to_end(ba_async_device):
    """Overlapped BA holds the same ATE gate as inline BA; solves actually
    dispatch, complete, and merge (on the 8-device CPU mesh, "auto" runs the
    solve on a second device — the true-overlap path)."""
    ds = make_dataset(n_frames=20)
    vo = _run_async_vo(ds, ba_async_device)
    assert (vo.statuses() == FrontendStatus.TRACKING_GOOD).all()
    est_wc = vo.trajectory_T_wc()
    ate = evaluation.ate_rmse(est_wc[:, :3, 3], ds.gt_T_wc[:, :3, 3])
    assert ate < 0.15, ate
    st = vo.async_backend.stats
    assert st["dispatched"] >= 1 and st["merged"] == st["dispatched"], st
    assert vo.async_backend.pending is None
    # The merged solves produced finite chi (BA genuinely ran).
    chis = [float(s.chi) for s in vo.async_backend.merged_stats]
    assert chis and all(np.isfinite(c) for c in chis), chis


def test_pick_ba_device():
    assert pick_ba_device("none") is None
    devs = jax.local_devices()
    if len(devs) > 1:
        assert pick_ba_device("auto") == devs[1]
        assert pick_ba_device("1") == devs[1]
    assert pick_ba_device("0") is None
