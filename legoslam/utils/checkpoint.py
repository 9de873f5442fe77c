"""Checkpoint / resume for the SLAM pipeline.

The reference has **no** persistence at all (SURVEY §5: no map or trajectory
serialization anywhere; the g2o `read`/`write` stubs in g2o_types.h:44-46
just return true).  This module closes that gap, and it is where the
functional redesign pays off: the entire mutable world of the reference —
`Map`'s four pointer containers, every `Frame`/`MapPoint` object and its
mutex (src/map.cpp, src/frame.cpp, src/mappoint.cpp) — is here a single
pytree of fixed-shape arrays (`VOCarry`), so a checkpoint is just that
pytree's leaves written to one compressed `.npz`, and resume is an exact
bit-level restoration of the device state.

Format: `.npz` with leaves keyed `leaf_{i:04d}` in `tree_flatten` order plus
a `__meta__` JSON blob (leaf count, schema version, user metadata).  The
loader rebuilds the pytree structure from a template produced by the same
config that will consume it, which guarantees shape/capacity agreement or a
loud error — never a silently misinterpreted buffer.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

SCHEMA_VERSION = 1


def _flatten(tree) -> Tuple[list, Any]:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return leaves, treedef


def save_pytree(path: str, tree, meta: Optional[Dict[str, Any]] = None) -> str:
    """Write any pytree of arrays to `path` (.npz, compressed).

    `np.savez_compressed` appends ``.npz`` when the suffix is missing, which
    would make a later `load_pytree(path)` miss the file — so the path is
    normalized here and the actual path written is returned.
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    leaves, _ = _flatten(tree)
    blobs = {f"leaf_{i:04d}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    blobs["__meta__"] = np.frombuffer(
        json.dumps(
            {"schema": SCHEMA_VERSION, "n_leaves": len(leaves), "user": meta or {}}
        ).encode("utf-8"),
        dtype=np.uint8,
    )
    np.savez_compressed(path, **blobs)
    return path


def _normalize_path(path: str) -> str:
    """Accept both `f` and `f.npz` spellings at load time."""
    import os

    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return path


def load_pytree(path: str, template) -> Tuple[Any, Dict[str, Any]]:
    """Read a pytree saved by `save_pytree`, shaped like `template`.

    Every leaf must match the template's shape and dtype exactly; capacity
    or config drift between save and load fails loudly here.
    """
    data = np.load(_normalize_path(path))
    meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    if meta["schema"] != SCHEMA_VERSION:
        raise ValueError(f"checkpoint schema {meta['schema']} != {SCHEMA_VERSION}")
    t_leaves, treedef = _flatten(template)
    if meta["n_leaves"] != len(t_leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, template has {len(t_leaves)} "
            "(config/capacity mismatch between save and load)"
        )
    leaves = []
    for i, t_leaf in enumerate(t_leaves):
        arr = data[f"leaf_{i:04d}"]
        t_arr = np.asarray(t_leaf)
        if arr.shape != t_arr.shape or arr.dtype != t_arr.dtype:
            raise ValueError(
                f"leaf {i}: checkpoint {arr.shape}/{arr.dtype} vs "
                f"template {t_arr.shape}/{t_arr.dtype}"
            )
        leaves.append(arr)
    return jax.tree_util.tree_unflatten(treedef, leaves), meta.get("user", {})


def save_vo_checkpoint(path: str, vo) -> None:
    """Snapshot a running `VisualOdometry`: device carry + host trajectory.

    Resume with `load_vo_checkpoint` on a VO constructed with the same
    config; the next `step()` continues the sequence exactly where this one
    stopped (same map, same keyframe window, same constant-velocity prior).
    """
    if vo.carry is None:
        raise ValueError("VO has processed no frames; nothing to checkpoint")
    outputs = [jax.device_get(o) for o in vo.outputs]
    trace_len = 0
    if outputs and outputs[0].ba is not None:
        trace_len = int(np.asarray(outputs[0].ba.trace).shape[0])
    # The driver's upload lookahead may have pulled one frame beyond the last
    # PROCESSED one; the resume point is the first unprocessed frame.
    next_index = int(getattr(vo.dataset, "current_index", 0))
    if getattr(vo, "_prefetched", None) is not None:
        next_index -= 1
    user = {
        "frame_ids": [int(i) for i in vo.frame_ids],
        "n_outputs": len(outputs),
        "image_shape": list(vo.carry.pyr_last[0].shape),
        "next_index": next_index,
        "has_ba_stats": bool(outputs and outputs[0].ba is not None),
        "ba_trace_len": trace_len,
    }
    save_pytree(path, (vo.carry, outputs), meta=user)


def load_vo_checkpoint(path: str, vo) -> None:
    """Restore a `save_vo_checkpoint` snapshot into an `init()`-ed VO."""
    from legoslam.pipeline import visual_odometry as vo_mod

    if vo.frontend_cfg is None:
        raise ValueError("call vo.init() before loading a checkpoint")
    path = _normalize_path(path)
    probe = np.load(path)
    user = json.loads(bytes(probe["__meta__"]).decode("utf-8"))["user"]
    carry_t = vo_mod.initial_carry(vo.frontend_cfg, tuple(user["image_shape"]))
    ba_t = None
    if user.get("has_ba_stats", False):
        from legoslam.pipeline.backend import BAStats

        i0 = np.asarray(0, np.int32)
        f0 = np.asarray(0.0, np.float32)
        ba_t = BAStats(
            chi=f0, iterations=i0, n_outlier=i0, n_inlier=i0,
            n_active_landmarks=i0, n_dropped_landmarks=i0, lam=f0,
            trace=np.zeros((int(user.get("ba_trace_len", 0)), 2), np.float32),
        )
    out_t = vo_mod.FrameOutput(
        T_cw=np.zeros((4, 4), np.float32),
        status=np.asarray(0, np.int32),
        kf_inserted=np.asarray(False),
        n_inliers=np.asarray(0, np.int32),
        ba_chi=np.asarray(0.0, np.float32),
        n_tracked=np.asarray(0, np.int32),
        n_new_landmarks=np.asarray(0, np.int32),
        ba=ba_t,
    )
    template = (carry_t, [out_t] * user["n_outputs"])
    (carry, outputs), user2 = load_pytree(path, template)
    vo.carry = jax.device_put(carry)
    vo.outputs = list(outputs)
    vo.frame_ids = list(user2["frame_ids"])
    # Reposition the dataset at the next unprocessed frame.  Setting
    # `current_index` alone is NOT enough for KittiDataset's native prefetch
    # loader (its worker queue was opened at start=0 and ignores the
    # attribute) — the dataset must support an explicit seek; anything else
    # would silently reprocess from frame 0 and corrupt the resumed run.
    next_index = int(user2.get("next_index", 0))
    if hasattr(vo.dataset, "seek"):
        vo.dataset.seek(next_index)
    elif hasattr(vo.dataset, "current_index"):
        vo.dataset.current_index = next_index
    else:
        raise ValueError(
            f"dataset {type(vo.dataset).__name__} cannot seek to frame "
            f"{next_index}; resume requires a seek() or current_index"
        )
    # Any in-hand prefetched frame belongs to the pre-restore stream, as
    # does the one-frame loop-hook pipeline.
    vo._prefetched = None
    vo._pending_device_imgs = None
    vo._hook_prev = None
    vo._pending_snapshot = None
