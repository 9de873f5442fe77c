"""Asynchronous backend scheduling: BA overlapped with tracking.

Reproduces the reference's frontend/backend asynchrony (backend_lego.cpp:
38-54: the backend thread wakes on a condvar, optimizes a *snapshot* of the
active map while the frontend keeps tracking, and writes results back later)
with JAX's asynchronous dispatch.  There are no threads and no mutexes here — the same
three ingredients fall out of JAX's execution model:

- **snapshot** — free: the world map is immutable functional state, so the
  array handles passed to the BA program *are* the snapshot;
- **overlap** — the BA solve is its own jitted program dispatched
  asynchronously; tracking frame-steps keep being enqueued (and, with a
  second device available, actually execute concurrently while BA runs
  there — the scheduler ships the snapshot over the interconnect and the
  result back);
- **write-back** — a jitted `merge_ba_result` reconciles the finished
  result with however far the map has moved on (new keyframes, evictions,
  newborn landmarks), mirroring the reference's mutexed per-object
  SetPose/SetPos write-back (backend_lego.cpp:198-217).

The host never blocks: completion is detected by polling `jax.Array
.is_ready()` and the dispatch schedule reads NOTHING back from the device.
This is a deliberate divergence from the reference's event-driven trigger
(UpdateMap on each keyframe, backend_lego.cpp:22-28): reading a frame's
`kf_inserted` flag to the host costs one blocking device->host fetch per
frame.  Instead the backend
dispatches on a frame CADENCE (`dispatch_every`, default 4 — keyframes
arrive every ~5 frames, so the cadence approximates the reference's
trigger): when no solve is in flight and `dispatch_every` frames have
passed, the next solve is enqueued on the freshest snapshot.  A solve on a
window that gained no keyframe re-polishes the same optimum and is merged
harmlessly.  Like the reference — whose condvar notify is lost if the
backend is mid-solve — keyframes landing during a solve do not queue extra
solves.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import jax

from legoslam.pipeline import backend as backend_mod
from legoslam.utils.logging import get_logger

log = get_logger("legoslam.async_ba")


def pick_ba_device(spec: str = "auto"):
    """Resolve the device the BA program runs on.

    "auto": the second local device when one exists (true overlap — tracking
    on device 0, BA on device 1, snapshot/result shipped over the
    interconnect), else None (same-device: BA interleaves in the FIFO stream,
    which still removes the solve from the keyframe frame's critical path).
    "none": force same-device.  An integer string picks that local device.
    """
    if spec == "none":
        return None
    devs = jax.local_devices()
    if spec == "auto":
        return devs[1] if len(devs) > 1 else None
    idx = int(spec)
    if idx <= 0 or idx >= len(devs):
        return None
    return devs[idx]


class AsyncBackend:
    """Host-side scheduler for one in-flight window BA.

    Protocol (driven by VisualOdometry.process):
      1. `poll(carry_wmap) -> wmap` — call at the top of every frame: if the
         pending solve finished, dispatch the merge and return the merged
         map (else the map unchanged).
      2. after the frame step, `observe(output)` — counts the frame toward
         the dispatch cadence.  The device flag is NOT read (see module
         banner).
      3. if `want_dispatch`: `dispatch(carry_wmap)` — enqueue the solve on
         the (fresh) snapshot.
      4. `flush(carry_wmap) -> wmap` — at end of run / before checkpoint:
         block on the pending solve and merge it.
    """

    def __init__(
        self,
        frontend_cfg,
        rig,
        ba_cfg: backend_mod.BAConfig,
        solve_fn: Optional[Callable] = None,
        ba_device=None,
        dispatch_every: int = 4,
    ):
        self._solve = jax.jit(
            lambda wmap: backend_mod.solve_window(
                frontend_cfg, rig, wmap, ba_cfg, solve_fn=solve_fn
            )
        )
        self._merge = jax.jit(backend_mod.merge_ba_result)
        self.ba_device = ba_device
        self.dispatch_every = max(1, int(dispatch_every))
        self.pending: Optional[backend_mod.BAResult] = None
        self._frames_since_dispatch = 0
        self.stats = {"dispatched": 0, "merged": 0, "skipped": 0}
        self.merged_stats: List[backend_mod.BAStats] = []

    # --- step 1 -----------------------------------------------------------
    def poll(self, wmap):
        """Merge the pending result if it has finished; never blocks."""
        if self.pending is not None and self.pending.stats.chi.is_ready():
            return self._do_merge(wmap)
        return wmap

    # --- step 2 -----------------------------------------------------------
    def observe(self, kf_inserted) -> None:
        """Count a processed frame toward the dispatch cadence.  The
        kf_inserted device scalar is accepted for API compatibility but
        deliberately not fetched (see module banner)."""
        self._frames_since_dispatch += 1
        if self.pending is not None and self._frames_since_dispatch >= self.dispatch_every:
            # A cadence tick elapsed while a solve was still in flight — the
            # reference's "notify during active solve is dropped" case.
            self.stats["skipped"] += 1
            self._frames_since_dispatch = 0

    @property
    def want_dispatch(self) -> bool:
        return (
            self.pending is None
            and self._frames_since_dispatch >= self.dispatch_every
        )

    # --- step 3 -----------------------------------------------------------
    def dispatch(self, wmap) -> None:
        """Enqueue a window solve on the current map (the freshest snapshot —
        the reference likewise snapshots at solve *start*, not at notify,
        backend_lego.cpp:45-46)."""
        assert self.pending is None
        self._frames_since_dispatch = 0
        snap = wmap
        if self.ba_device is not None:
            snap = jax.device_put(snap, self.ba_device)
        self.pending = self._solve(snap)
        self.stats["dispatched"] += 1

    # --- step 4 -----------------------------------------------------------
    def flush(self, wmap):
        """Block on the in-flight solve (if any) and merge it."""
        if self.pending is not None:
            jax.block_until_ready(self.pending.stats.chi)
            wmap = self._do_merge(wmap)
        return wmap

    def _do_merge(self, wmap):
        result = self.pending
        self.pending = None
        if self.ba_device is not None:
            result = jax.device_put(result, wmap.kf_pose.devices().pop())
        self.merged_stats.append(result.stats)
        self.stats["merged"] += 1
        return self._merge(wmap, result)
