"""The VisualOdometry API and the fused per-frame SLAM step.

Re-designs `VisualOdometry` (src/visual_odometry.cpp, include/legoslam/
visual_odometry.h): `init()` wires dataset, rig, frontend/backend config and
compiles the step; `step()` feeds one stereo frame; `run()` loops to the end
of the sequence.

Scheduling is the deepest redesign (SURVEY §2 concurrency):  the reference
splits tracking and BA across threads with mutexes and a condition variable;
here one `process_frame` function jits the *entire* frame — the
INITING/TRACKING/LOST state machine as `lax.switch`, keyframe insertion as
`lax.cond`, and (by default) the backend BA inline in the keyframe branch.
The host just streams frames; JAX's async dispatch keeps the device queue
full, and no per-frame scalar ever has to return to the host.  On one chip
this is at least as parallel as the reference's threads (device work is
serialized either way); multi-chip asynchrony instead shards the BA itself
(parallel/dist_ba.py).
"""

from __future__ import annotations

import enum
from typing import Any, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from legoslam.geometry import se3
from legoslam.geometry.camera import StereoRig
from legoslam.ops import pyramid as pyr_ops
from legoslam.pipeline import backend as backend_mod
from legoslam.pipeline import frontend as frontend_mod
from legoslam.pipeline.dataset import KittiDataset, StereoFrame, SyntheticDataset
from legoslam.pipeline.state import Capacities, Features, WorldMap
from legoslam.utils.config import Config
from legoslam.utils.jax_setup import enable_compilation_cache, full_f32_matmuls
from legoslam.utils.logging import get_logger
from legoslam.utils.timer import CumulativeTimer, Timer

log = get_logger("legoslam.vo")


class FrontendStatus(enum.IntEnum):
    """frontend.h:17"""

    INITING = 0
    TRACKING_GOOD = 1
    TRACKING_BAD = 2
    LOST = 3


class VOCarry(NamedTuple):
    """Device-resident loop state for the fused frame step."""

    status: jnp.ndarray       # () int32 FrontendStatus
    feats: Features           # current-frame feature table
    wmap: WorldMap
    T_cur: jnp.ndarray        # (4, 4) last processed frame pose T_cw
    rel_motion: jnp.ndarray   # (4, 4) constant-velocity model (frontend.h:86)
    pyr_last: Tuple[jnp.ndarray, ...]  # left-image pyramid of the last frame
    frames_since_kf: jnp.ndarray  # () int32, for the max_keyframe_gap trigger


class FrameOutput(NamedTuple):
    """Per-frame results + the reference's per-frame log counters
    (frontend_lego.cpp:87,152,230: tracked points, new landmarks,
    outlier/inlier splits; problem.cpp:180-184: solver chi/lambda)."""

    T_cw: jnp.ndarray
    status: jnp.ndarray
    kf_inserted: jnp.ndarray
    n_inliers: jnp.ndarray
    ba_chi: jnp.ndarray
    n_tracked: jnp.ndarray = jnp.asarray(0, jnp.int32)        # KLT survivors
    n_new_landmarks: jnp.ndarray = jnp.asarray(0, jnp.int32)  # triangulated this frame
    ba: Any = None                                            # BAStats (NaN/0 if BA didn't run)


def initial_carry(cfg: frontend_mod.FrontendConfig, shape, dtype=jnp.float32) -> VOCarry:
    H, W = shape
    levels = cfg.klt.levels
    pyr = tuple(
        jnp.zeros((H // (2**i), W // (2**i)), dtype) for i in range(levels)
    )
    return VOCarry(
        status=jnp.asarray(int(FrontendStatus.INITING), jnp.int32),
        feats=Features.empty(cfg.caps, dtype, cfg.klt.levels, 2 * cfg.klt.half_patch + 3),
        wmap=WorldMap.empty(cfg.caps, dtype),
        T_cur=jnp.eye(4, dtype=dtype),
        rel_motion=jnp.eye(4, dtype=dtype),
        pyr_last=pyr,
        frames_since_kf=jnp.asarray(0, jnp.int32),
    )


@full_f32_matmuls
def process_frame(
    cfg: frontend_mod.FrontendConfig,
    rig: StereoRig,
    carry: VOCarry,
    img_l: jnp.ndarray,
    img_r: jnp.ndarray,
    frame_id: jnp.ndarray,
    ba_cfg: backend_mod.BAConfig = backend_mod.BAConfig(),
    inline_ba: bool = True,
    ba_solve_fn=None,
) -> Tuple[VOCarry, FrameOutput]:
    """One full SLAM frame: Frontend::AddFrame (frontend_g2o.cpp:27-46) with
    the backend cycle folded into the keyframe branch when `inline_ba`."""
    with jax.named_scope("pyr_build_l"):
        pyr_l = tuple(pyr_ops.build_pyramid(img_l, cfg.klt.levels))

    # The right pyramid feeds only stereo matching, which runs in the init
    # and keyframe-insert branches — build it there (inside lax.cond/switch)
    # so pure tracking frames skip the work entirely.
    def make_pyr_r():
        with jax.named_scope("pyr_build_r"):
            return tuple(pyr_ops.build_pyramid(img_r, cfg.klt.levels))
    eye = jnp.eye(4, dtype=img_l.dtype)
    no_chi = jnp.asarray(jnp.nan, img_l.dtype)
    i0 = jnp.asarray(0, jnp.int32)
    no_stats = backend_mod.BAStats(
        chi=no_chi, iterations=i0, n_outlier=i0, n_inlier=i0,
        n_active_landmarks=i0, n_dropped_landmarks=i0, lam=no_chi,
        trace=jnp.full((ba_cfg.iterations if ba_cfg.trace else 0, 2), jnp.nan, img_l.dtype),
    )

    def run_ba(wmap):
        if not inline_ba:
            return wmap, no_stats
        with jax.named_scope("window_ba"):
            wmap2, stats = backend_mod.ba_step(cfg, rig, wmap, ba_cfg, solve_fn=ba_solve_fn)
        return wmap2, stats

    def branch_init(op):
        carry, = op
        success, feats, wmap = frontend_mod.stereo_init(
            cfg, rig, pyr_l, make_pyr_r(), img_l, carry.wmap, frame_id
        )
        n_new = wmap.lm_next - carry.wmap.lm_next
        wmap, ba = jax.lax.cond(
            success, lambda w: run_ba(w), lambda w: (w, no_stats), wmap
        )
        status = jnp.where(
            success, int(FrontendStatus.TRACKING_GOOD), int(FrontendStatus.INITING)
        ).astype(jnp.int32)
        out = FrameOutput(
            T_cw=eye, status=status, kf_inserted=success,
            n_inliers=i0, ba_chi=ba.chi,
            n_tracked=i0, n_new_landmarks=n_new, ba=ba,
        )
        return VOCarry(status, feats, wmap, eye, eye, pyr_l, jnp.asarray(0, jnp.int32)), out

    def branch_track(op):
        carry, = op
        # Track (frontend_g2o.cpp:48-75).  The composition is re-projected
        # onto SE(3): float32 pose products shed ~1e-7 of orthonormality per
        # frame, and the rel/T_cur feedback amplifies it exponentially
        # (se3.so3_project docstring) — the round-1 long-horizon collapse.
        T_prior = se3.se3_orthonormalize(carry.rel_motion @ carry.T_cur)
        with jax.named_scope("klt_track"):
            feats = frontend_mod.track_last_frame(
                cfg, rig, carry.pyr_last, pyr_l, carry.feats, carry.wmap.lm_pos,
                T_prior, rel_motion=carry.rel_motion,
            )
        n_tracked = feats.count()
        with jax.named_scope("pose_solve"):
            T_new, feats, n_in = frontend_mod.estimate_current_pose(
                cfg, rig, feats, carry.wmap.lm_pos, T_prior
            )
        status = jnp.where(
            n_in >= cfg.num_features_tracking,
            int(FrontendStatus.TRACKING_GOOD),
            jnp.where(
                n_in >= cfg.num_features_tracking_bad,
                int(FrontendStatus.TRACKING_BAD),
                int(FrontendStatus.LOST),
            ),
        ).astype(jnp.int32)
        # InsertKeyframe when tracked support is low (frontend_g2o.cpp:77-81)
        # or the max keyframe gap elapsed.  Deviation from the reference: a
        # LOST frame does not insert (the reference would, then wipe the map
        # on the next frame anyway).
        insert = (
            (n_in < cfg.num_features_needed_for_keyframe)
            | (carry.frames_since_kf + 1 >= cfg.max_keyframe_gap)
        ) & (n_in >= cfg.num_features_tracking_bad)

        def do_insert(op):
            feats, wmap = op
            with jax.named_scope("kf_insert"):
                feats, wmap = frontend_mod.insert_keyframe(
                    cfg, rig, pyr_l, make_pyr_r(), img_l, feats, wmap, T_new, frame_id
                )
            wmap, ba = run_ba(wmap)
            return feats, wmap, ba

        feats, wmap, ba = jax.lax.cond(
            insert, do_insert, lambda op: (op[0], op[1], no_stats), (feats, carry.wmap)
        )
        n_new = wmap.lm_next - carry.wmap.lm_next
        rel = se3.se3_orthonormalize(T_new @ se3.se3_inv(carry.T_cur))
        out = FrameOutput(
            T_cw=T_new, status=status, kf_inserted=insert, n_inliers=n_in,
            ba_chi=ba.chi, n_tracked=n_tracked, n_new_landmarks=n_new, ba=ba,
        )
        since_kf = jnp.where(insert, 0, carry.frames_since_kf + 1).astype(jnp.int32)
        return VOCarry(status, feats, wmap, T_new, rel, pyr_l, since_kf), out

    def branch_lost(op):
        carry, = op
        # Reset (frontend_g2o.cpp:351-366): wipe the map, re-init next frame.
        fresh = initial_carry(cfg, img_l.shape, img_l.dtype)
        out = FrameOutput(
            T_cw=carry.T_cur,
            status=fresh.status,
            kf_inserted=jnp.asarray(False),
            n_inliers=i0,
            ba_chi=no_chi,
            n_tracked=i0,
            n_new_landmarks=i0,
            ba=no_stats,
        )
        return fresh._replace(pyr_last=pyr_l), out

    branch_idx = jnp.where(
        carry.status == int(FrontendStatus.INITING),
        0,
        jnp.where(carry.status <= int(FrontendStatus.TRACKING_BAD), 1, 2),
    )
    return jax.lax.switch(branch_idx, [branch_init, branch_track, branch_lost], (carry,))


def process_chunk(
    cfg: frontend_mod.FrontendConfig,
    rig: StereoRig,
    carry: VOCarry,
    imgs_l: jnp.ndarray,
    imgs_r: jnp.ndarray,
    frame_ids: jnp.ndarray,
    ba_cfg: backend_mod.BAConfig = backend_mod.BAConfig(),
    inline_ba: bool = True,
    ba_solve_fn=None,
) -> Tuple[VOCarry, FrameOutput]:
    """Offline/throughput mode: `lax.scan` of `process_frame` over a chunk of
    F stacked stereo frames — the whole chunk compiles to ONE XLA program, so
    the per-program dispatch cost is paid once per chunk instead of once per
    frame.  The math
    is the per-frame step unchanged; outputs are stacked `FrameOutput` with a
    leading F axis.  Use for offline mapping / bulk serving where frames are
    already on device; the interactive path (`VisualOdometry.step`) stays
    per-frame so host hooks (viewer, loop closure, async BA) see every frame.

    The reference has no analogue: its per-frame loop is inherently host-paced
    (visual_odometry.cpp:46-57)."""

    def scan_step(c, xs):
        il, ir, fid = xs
        c, out = process_frame(
            cfg, rig, c, il, ir, fid,
            ba_cfg=ba_cfg, inline_ba=inline_ba, ba_solve_fn=ba_solve_fn,
        )
        return c, out

    return jax.lax.scan(scan_step, carry, (imgs_l, imgs_r, frame_ids))


@full_f32_matmuls
def _apply_world_correction(carry: VOCarry, G: jnp.ndarray) -> VOCarry:
    """Re-anchor the live world after a loop closure (pipeline/loop_closure.py):
    map points p' = G p, camera-from-world poses Q' = Q G^-1; the relative
    motion model and feature tables are frame-local and unaffected."""
    G_inv = se3.se3_inv(G)
    R, t = G[:3, :3], G[:3, 3]
    wmap = carry.wmap
    lm_pos = jnp.where(wmap.lm_alive[:, None], wmap.lm_pos @ R.T + t[None, :], wmap.lm_pos)
    kf_pose = jnp.where(
        wmap.kf_valid[:, None, None],
        se3.se3_orthonormalize(wmap.kf_pose @ G_inv),
        wmap.kf_pose,
    )
    marg = wmap.marg._replace(
        prior_T=se3.se3_orthonormalize(wmap.marg.prior_T @ G_inv),
        info_T=se3.se3_orthonormalize(wmap.marg.info_T @ G_inv),
    )
    return carry._replace(
        wmap=wmap._replace(lm_pos=lm_pos, kf_pose=kf_pose, marg=marg),
        T_cur=se3.se3_orthonormalize(carry.T_cur @ G_inv),
    )


class VisualOdometry:
    """Host-side driver (the reference's `VisualOdometry` API)."""

    def __init__(
        self,
        config_path: Optional[str] = None,
        config: Optional[Config] = None,
        dataset: Any = None,
        inline_ba: bool = True,
        ba_solve_fn=None,
        ba_mode: Optional[str] = None,
    ):
        self.config = config or (Config.from_yaml(config_path) if config_path else Config())
        self.dataset = dataset
        # Scheduling mode: "inline" folds BA into the keyframe branch of the
        # fused frame step; "async" overlaps a detached solve with tracking
        # (pipeline/async_backend.py, the reference's thread split); "off"
        # disables BA.  `inline_ba` is the legacy bool spelling.
        if ba_mode is None:
            ba_mode = self.config["ba_mode"] if inline_ba else "off"
        if ba_mode not in ("inline", "async", "off"):
            raise ValueError(f"unknown ba_mode {ba_mode!r}")
        self.ba_mode = ba_mode
        self.inline_ba = ba_mode == "inline"
        self.ba_solve_fn = ba_solve_fn
        self.async_backend = None
        self.loop_closer = None
        self.frontend_cfg: Optional[frontend_mod.FrontendConfig] = None
        self.rig: Optional[StereoRig] = None
        self.carry: Optional[VOCarry] = None
        self.outputs: List[FrameOutput] = []
        self.frame_ids: List[int] = []
        self.timers = CumulativeTimer()
        self._step_fn = None
        self.log_every = 0
        self._prefetched = None
        self._pending_device_imgs = None

    # --- reference API (visual_odometry.h:27-49) ---
    def init(self) -> bool:
        enable_compilation_cache()
        if self.dataset is None:
            ddir = self.config["dataset_dir"]
            self.dataset = KittiDataset(ddir, scale=self.config["image_scale"])
        if not self.dataset.init():
            return False
        self.rig = self.dataset.rig
        self.frontend_cfg = frontend_mod.FrontendConfig.from_config(self.config)
        if self.frontend_cfg.use_marg_prior and self.ba_solve_fn is not None:
            # Fail at init, not mid-run inside the first keyframe's solve
            # (backend.solve_window would raise the same conflict later).
            raise ValueError(
                "use_marg_prior is not supported with an injected ba_solve_fn "
                "(distributed BA): the prior requires the SoA single-chip solver"
            )
        ba_cfg = backend_mod.BAConfig(
            iterations=self.config["ba_solver_iterations"],
            chi2_threshold=self.config["chi2_threshold"],
            max_chi2_doublings=self.config["ba_max_chi2_doublings"],
            inlier_ratio=self.config["ba_inlier_ratio"],
            strategy=self.config["lm_strategy"],
            linear_solver=self.config["linear_solver"],
            engine=self.config["lm_engine"],
            trace=bool(self.config["ba_trace"]),
            assembly_precision=str(self.config["ba_assembly_precision"]),
        )
        self.log_every = int(self.config["log_every_n_frames"])
        cfg, rig = self.frontend_cfg, self.rig

        def step(carry, img_l, img_r, frame_id):
            return process_frame(
                cfg, rig, carry, img_l, img_r, frame_id,
                ba_cfg=ba_cfg, inline_ba=self.inline_ba, ba_solve_fn=self.ba_solve_fn,
            )

        self._step_fn = jax.jit(step, donate_argnums=(0,))
        if self.ba_mode == "async":
            from legoslam.pipeline.async_backend import AsyncBackend, pick_ba_device

            self.async_backend = AsyncBackend(
                cfg, rig, ba_cfg, solve_fn=self.ba_solve_fn,
                ba_device=pick_ba_device(str(self.config["ba_async_device"])),
                dispatch_every=int(self.config["ba_async_dispatch_every"]),
            )
        if bool(self.config["use_loop_closure"]):
            from legoslam.pipeline.loop_closure import LoopCloser, LoopConfig

            self.loop_closer = LoopCloser(
                rig,
                LoopConfig(
                    zncc_min=float(self.config["loop_zncc_min"]),
                    min_gap=int(self.config["loop_min_gap"]),
                    min_inliers=int(self.config["loop_min_inliers"]),
                    loop_weight=float(self.config["loop_edge_weight"]),
                ),
            )
            self._apply_correction = jax.jit(_apply_world_correction, donate_argnums=(0,))

            # Keyframe snapshot for the loop closer, packed into ONE device
            # buffer: every device->host fetch pays a fixed latency regardless
            # of size, so the hook reads one async-copied vector per keyframe
            # instead of five arrays.
            M = cfg.caps.max_features

            def pack_snapshot(carry, T_cw):
                feats = carry.feats
                sel = feats.valid & (feats.lm >= 0)
                pw = carry.wmap.lm_pos[jnp.maximum(feats.lm, 0)]
                return jnp.concatenate([
                    T_cw.reshape(-1),
                    feats.uv.reshape(-1),
                    feats.lm.astype(jnp.float32),
                    sel.astype(jnp.float32),
                    pw.reshape(-1),
                ])

            self._pack_snapshot = jax.jit(pack_snapshot)
            self._snapshot_M = M
        # Live viewer stream (viewer.cpp:38-97's continuous redraw, decimated
        # to every N frames): opt-in because feeding it forces per-frame
        # device->host syncs of the feature table.
        viz_n = int(self.config["viewer_every_n"])
        if viz_n > 0:
            from legoslam.pipeline.viewer import Viewer

            self.viewer = Viewer(every_n=viz_n)
        else:
            self.viewer = None
        self.carry = None
        self.outputs = []
        self.frame_ids = []
        self._prefetched = None
        self._pending_device_imgs = None
        self._hook_prev = None        # (frame_id, out) awaiting its flag read
        self._pending_snapshot = None  # (frame_id, img, packed device vec)
        return True

    def step(self) -> bool:
        """Process one frame (visual_odometry.cpp:59-70)."""
        frame = self._next_frame()
        if frame is None:
            self._drain_hooks()
            return False
        t = Timer()
        self.process(frame)
        self.timers.add("vo_step_dispatch", t.toc())
        return True

    def _upload(self, frame: StereoFrame):
        """Enqueue the stereo pair's host->device transfer (async)."""
        return (
            jax.device_put(np.asarray(frame.left, np.float32)),
            jax.device_put(np.asarray(frame.right, np.float32)),
        )

    def _next_frame(self) -> Optional[StereoFrame]:
        """Dataset pull with a one-frame device-upload lookahead: the next
        frame's host->device transfer is enqueued BEFORE the current frame is
        processed, so the transfer overlaps the previous step's compute
        instead of serializing in front of it."""
        if self._prefetched is not None:
            frame, dev = self._prefetched
        else:
            frame = self.dataset.next_frame()
            if frame is None:
                return None
            dev = self._upload(frame)
        nxt = self.dataset.next_frame()
        self._prefetched = (nxt, self._upload(nxt)) if nxt is not None else None
        self._pending_device_imgs = dev
        return frame

    def process(self, frame: StereoFrame, device_imgs=None) -> FrameOutput:
        if device_imgs is None:
            device_imgs = self._pending_device_imgs
            self._pending_device_imgs = None
        if device_imgs is not None:
            img_l, img_r = device_imgs
        else:
            img_l = jnp.asarray(frame.left, jnp.float32)
            img_r = jnp.asarray(frame.right, jnp.float32)
        if self.carry is None:
            self.carry = initial_carry(self.frontend_cfg, frame.left.shape)
        ab = self.async_backend
        if ab is not None:
            # Merge a finished solve before this frame tracks (non-blocking).
            merged = ab.poll(self.carry.wmap)
            if merged is not self.carry.wmap:
                self.carry = self.carry._replace(wmap=merged)
        self.carry, out = self._step_fn(
            self.carry, img_l, img_r, jnp.asarray(frame.frame_id, jnp.int32)
        )
        if ab is not None:
            ab.observe(out.kf_inserted)
            if ab.want_dispatch:
                ab.dispatch(self.carry.wmap)
        if self.loop_closer is not None:
            self._loop_hook(frame, out)
        if self.viewer is not None:
            self._viewer_hook(frame, out)
        self.outputs.append(out)
        self.frame_ids.append(frame.frame_id)
        if self.log_every > 0 and len(self.outputs) % self.log_every == 0:
            self._log_frame(frame.frame_id, out)
        return out

    def _log_frame(self, frame_id: int, out: FrameOutput) -> None:
        """The reference's per-frame INFO log (frontend_lego.cpp:87,152,230 and
        problem.cpp:180-184).  Forces a device sync — gate with log_every."""
        status = FrontendStatus(int(out.status)).name
        kf = bool(out.kf_inserted)
        msg = (
            f"frame {frame_id}: {status} tracked={int(out.n_tracked)} "
            f"inliers={int(out.n_inliers)}"
        )
        if kf:
            ba = out.ba
            msg += f" KF new_landmarks={int(out.n_new_landmarks)}"
            if ba is not None and np.isfinite(float(ba.chi)):
                msg += (
                    f" | BA chi={float(ba.chi):.2f} iters={int(ba.iterations)}"
                    f" lambda={float(ba.lam):.3g} inl/out={int(ba.n_inlier)}/{int(ba.n_outlier)}"
                    f" active_lms={int(ba.n_active_landmarks)}"
                )
                if int(ba.n_dropped_landmarks) > 0:
                    log.warning(
                        "frame %d: BA capacity overflow — %d landmarks/edges dropped "
                        "from the problem (raise max_active_landmarks / max_ba_edges)",
                        frame_id, int(ba.n_dropped_landmarks),
                    )
                tr = np.asarray(ba.trace)
                if tr.size:
                    for it, (chi, lam) in enumerate(tr):
                        if np.isfinite(chi):
                            log.info("  BA iter %d: chi=%.3f lambda=%.4g", it, chi, lam)
        log.info(msg)

    def run(self) -> None:
        """Main loop (visual_odometry.cpp:46-57)."""
        t_total = Timer()
        n = 0
        while self.step():
            n += 1
        self.flush_ba()
        total_ms = t_total.toc(block_on=self.carry)
        if n:
            log.info("VO: %d frames in %.1f ms (%.2f ms/frame, %.1f FPS)",
                     n, total_ms, total_ms / n, 1e3 * n / total_ms)
            # Silent-overflow audit (VERDICT round 1 weakness 6): any BA solve
            # that quietly truncated its problem is surfaced here even when
            # per-frame logging is off.
            dropped = sum(
                int(o.ba.n_dropped_landmarks) for o in self.outputs if o.ba is not None
            )
            if dropped > 0:
                log.warning(
                    "VO: BA dropped %d landmark/edge slots across the run due to "
                    "capacity limits — results may be degraded; raise "
                    "max_active_landmarks / max_ba_edges", dropped,
                )

    def _loop_hook(self, frame: StereoFrame, out: FrameOutput) -> None:
        """Feed the loop closer without per-frame device->host fetches.

        Every device->host fetch pays a fixed latency, so the hook pipeline is
        one frame DEEP: the current frame's
        status/kf flags are enqueued as async host copies now and consumed on
        the next call, by which time the transfer has landed (~0.5 ms read).
        A keyframe event likewise snapshots the NEXT frame's state — the
        packed (pose, uv, landmark-id, validity, position) vector is built on
        device, async-copied, and consumed one frame later with that frame's
        host image.  Loop-closure records therefore lag keyframes by one
        frame, which place recognition is indifferent to; corrections are
        world-frame re-anchors, valid whenever applied.  (Loop closure is the
        reference's north-star TODO, CMakeLists:74-77.)
        """
        lc = self.loop_closer
        # 1. Consume a pending keyframe snapshot (transferred during the step
        #    that was just dispatched).
        if self._pending_snapshot is not None:
            fid, img, vec = self._pending_snapshot
            self._pending_snapshot = None
            self._consume_snapshot(fid, img, vec)
        # 2. Enqueue this frame's flags; consume the previous frame's.
        out.status.copy_to_host_async()
        out.kf_inserted.copy_to_host_async()
        prev = self._hook_prev
        self._hook_prev = (frame.frame_id, frame.left, out)
        if prev is None:
            return
        prev_fid, _prev_img, prev_out = prev
        if int(prev_out.status) == int(FrontendStatus.LOST):
            self._pending_snapshot = None
            lc.reset()
            return
        if not bool(prev_out.kf_inserted):
            return
        # 3. The previous frame inserted a keyframe: snapshot the CURRENT
        #    frame's state (self-consistent: carry.feats, out.T_cw and
        #    frame.left all describe this frame) and let it transfer while
        #    the next step runs.
        vec = self._pack_snapshot(self.carry, out.T_cw)
        vec.copy_to_host_async()
        self._pending_snapshot = (frame.frame_id, np.asarray(frame.left), vec)

    def _consume_snapshot(self, frame_id: int, img: np.ndarray, vec) -> None:
        M = self._snapshot_M
        v = np.asarray(vec)
        T_cw = v[:16].reshape(4, 4)
        off = 16
        uv = v[off:off + 2 * M].reshape(M, 2); off += 2 * M
        off += M  # landmark ids (present for diagnostics; positions follow)
        sel = v[off:off + M] > 0.5; off += M
        p_world = v[off:off + 3 * M].reshape(M, 3)
        result = self.loop_closer.add_keyframe(
            frame_id, img, T_cw, uv[sel], p_world[sel]
        )
        if result is not None:
            _, G = result
            if self.async_backend is not None:
                # An in-flight solve was linearized in the old world frame;
                # settle it before re-anchoring.
                self.carry = self.carry._replace(
                    wmap=self.async_backend.flush(self.carry.wmap)
                )
            self.carry = self._apply_correction(self.carry, jnp.asarray(G, jnp.float32))

    def _drain_hooks(self) -> None:
        """End of stream: flush the one-frame hook pipeline synchronously."""
        if self.loop_closer is None:
            return
        if self._pending_snapshot is not None:
            fid, img, vec = self._pending_snapshot
            self._pending_snapshot = None
            self._consume_snapshot(fid, img, vec)
        prev = self._hook_prev
        self._hook_prev = None
        if prev is None:
            return
        prev_fid, prev_img, prev_out = prev
        # The final frame's flags were never consumed; a trailing keyframe
        # (often the one that closes a loop at sequence end) snapshots from
        # the final carry, which still describes that frame.
        if int(prev_out.status) == int(FrontendStatus.LOST):
            self.loop_closer.reset()
            return
        if bool(prev_out.kf_inserted):
            vec = self._pack_snapshot(self.carry, prev_out.T_cw)
            self._consume_snapshot(prev_fid, np.asarray(prev_img), vec)

    def _viewer_hook(self, frame: StereoFrame, out: FrameOutput) -> None:
        """Feed the live viewer stream: T_cw every frame, a feature overlay
        every N frames, a map snapshot on keyframe events (viewer.cpp:19-36)."""
        vw = self.viewer
        if len(self.outputs) % vw.every_n == 0:
            feats = self.carry.feats
            vw.add_current_frame(
                np.asarray(out.T_cw), frame.left,
                np.asarray(feats.uv), np.asarray(feats.valid),
            )
        else:
            vw.add_current_frame(np.asarray(out.T_cw))
        if bool(out.kf_inserted):
            wmap = self.carry.wmap
            vw.update_map(
                np.asarray(wmap.kf_pose), np.asarray(wmap.kf_valid),
                np.asarray(wmap.lm_pos), np.asarray(wmap.lm_active_mask()),
            )

    def keyframe_trajectory(self):
        """(frame_ids, T_cw (N, 4, 4)) over keyframes — loop-corrected when
        loop closure is on."""
        lc = self.loop_closer
        if lc is None or not lc.records:
            return [], np.zeros((0, 4, 4))
        ids = [r.frame_id for r in lc.records]
        return ids, np.stack([r.T_cw for r in lc.records])

    def flush_ba(self) -> None:
        """Settle the asynchronous backend: merge any in-flight solve, and run
        one final solve if a keyframe event is still awaiting dispatch (the
        reference's backend likewise drains its last UpdateMap before Stop)."""
        ab = self.async_backend
        if ab is None or self.carry is None:
            return
        wmap = ab.flush(self.carry.wmap)
        if ab.want_dispatch:
            ab.dispatch(wmap)
            wmap = ab.flush(wmap)
        self.carry = self.carry._replace(wmap=wmap)
        log.info(
            "async BA: %d solves dispatched, %d merged, %d keyframe events "
            "coalesced while busy",
            ab.stats["dispatched"], ab.stats["merged"], ab.stats["skipped"],
        )

    # --- results ---
    def frontend_status(self) -> FrontendStatus:
        return FrontendStatus(int(self.carry.status)) if self.carry is not None else FrontendStatus.INITING

    def trajectory_T_cw(self) -> np.ndarray:
        return np.asarray(jnp.stack([o.T_cw for o in self.outputs]))

    def trajectory_T_wc(self) -> np.ndarray:
        T = self.trajectory_T_cw()
        return np.linalg.inv(T)

    def statuses(self) -> np.ndarray:
        return np.asarray(jnp.stack([o.status for o in self.outputs]))

    def num_keyframes(self) -> int:
        return int(self.carry.wmap.num_keyframes()) if self.carry is not None else 0

    # --- checkpoint / resume (no reference analogue — SURVEY §5 gap) ---
    def save_checkpoint(self, path: str) -> None:
        from legoslam.utils import checkpoint

        self.flush_ba()      # an in-flight solve is not serializable state
        self._drain_hooks()  # nor is the one-frame loop-hook pipeline
        checkpoint.save_vo_checkpoint(path, self)

    def load_checkpoint(self, path: str) -> None:
        from legoslam.utils import checkpoint

        checkpoint.load_vo_checkpoint(path, self)

    # --- export / visualization ---
    def save_trajectory(self, path: str, fmt: str = "kitti") -> None:
        from legoslam.utils import evaluation

        T_wc = self.trajectory_T_wc()
        if fmt == "tum":
            evaluation.save_tum_trajectory(path, [float(i) for i in self.frame_ids], T_wc)
        else:
            evaluation.save_kitti_trajectory(path, T_wc)

    def save_visualization(self, out_dir: str, ground_truth=None, last_frame=None):
        """Render the reference viewer's artifacts headlessly (pipeline/viewer.py).

        With `viewer_every_n` > 0 the live stream collected during the run is
        rendered (per-frame overlays + follow-mode local map + GIF);
        otherwise a final-state-only rendering is produced."""
        from legoslam.pipeline.viewer import Viewer

        if self.viewer is not None:
            if self.carry is not None:
                wmap = self.carry.wmap
                self.viewer.update_map(
                    np.asarray(wmap.kf_pose), np.asarray(wmap.kf_valid),
                    np.asarray(wmap.lm_pos), np.asarray(wmap.lm_active_mask()),
                )
            return self.viewer.save(out_dir, ground_truth=ground_truth)

        viewer = Viewer()
        for o in self.outputs:
            viewer.add_current_frame(np.asarray(o.T_cw))
        if self.carry is not None:
            viewer.update_map(
                self.carry.wmap.kf_pose, self.carry.wmap.kf_valid,
                self.carry.wmap.lm_pos, self.carry.wmap.lm_alive,
            )
            if last_frame is not None:
                viewer.last_frame_img = last_frame
                feats = self.carry.feats
                viewer.last_features = np.asarray(feats.uv)[np.asarray(feats.valid)]
        return viewer.save(out_dir, ground_truth=ground_truth)
