"""Frontend device functions: tracking, detection, stereo matching,
triangulation, keyframe insertion, stereo bootstrap.

Re-designs `Frontend` (src/frontend_{lego,g2o}.cpp, include/legoslam/frontend.h)
as pure functions over the fixed-shape world state (pipeline/state.py).  Each
reference member function maps to one function here (cites inline); the
INITING/TRACKING/LOST state machine itself is assembled in
pipeline/visual_odometry.py as a `lax.switch` so a whole frame step jits.

Conventions: poses are T_cw (camera/rig-from-world); images are float32
(H, W) grayscale 0..255; pyramids are tuples of per-level arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.geometry import se3, triangulation
from legoslam.geometry.camera import StereoRig
from legoslam.ops import detect as detect_ops
from legoslam.ops import klt as klt_ops
from legoslam.ops import stereo as stereo_ops
from legoslam.solver import lm as lm_ops
from legoslam.solver import pose_pallas
from legoslam.solver import reprojection
from legoslam.pipeline.state import Capacities, Features, WorldMap


class FrontendConfig(NamedTuple):
    """Static configuration (reference values cited in utils/config.py)."""

    caps: Capacities = Capacities()
    num_features: int = 150
    num_features_init: int = 50
    num_features_tracking: int = 30
    num_features_tracking_bad: int = 5
    num_features_needed_for_keyframe: int = 80
    stereo_depth_superior_limit: float = 200.0
    stereo_depth_inferior_limit: float = 8.0
    ground_y_limit: float = 2.0
    detect_mask_half: int = 10
    gftt: detect_ops.GFTTConfig = detect_ops.GFTTConfig()
    klt: klt_ops.KLTConfig = klt_ops.KLTConfig()
    chi2_threshold: float = 5.991
    pose_outer_iterations: int = 4
    pose_solver_iterations: int = 10
    pose_exclude_outliers: bool = True
    num_active_keyframes: int = 15
    min_dis_th: float = 0.2
    sing_ratio_threshold: float = 1e-3
    # Forward-backward verification thresholds in px (0 disables).  Not in the
    # reference; added because one-way KLT systematically under-shoots large
    # stereo disparities, biasing triangulated depths long (and letting
    # mistracks survive).  Costs one extra batched KLT pass.
    stereo_fb_threshold: float = 0.6
    track_fb_threshold: float = 0.8
    # "scanline" (epipolar-constrained coarse scan + 1-D GN; rectified rigs)
    # or "klt" (the reference's general 2-D KLT, frontend_g2o.cpp:495-535).
    stereo_matcher: str = "scanline"
    # "anchored": track keyframe templates (drift-free); "frame": the
    # reference's last-frame-to-current tracking (frontend_g2o.cpp:453-492).
    track_mode: str = "anchored"
    track_min_zncc: float = 0.5
    # Pyramid levels used by the anchored temporal tracker (0 = all of
    # klt.levels).  Anchored tracking seeds each lane at its landmark's
    # projection under the constant-velocity prior — within a few px — so the
    # coarse levels built for large unknown motions (the reference's
    # frame-to-frame scheme, algorithm.cpp:128-206) only burn GN iterations
    # on /4- and /8-scale template mismatch.  Detection-time stereo matching
    # and the "frame" track mode keep the full pyramid.
    track_levels: int = 0
    scanline: stereo_ops.ScanlineConfig = stereo_ops.ScanlineConfig()
    # Insert a keyframe after this many frames even if the inlier count stays
    # high (no reference analogue — the reference triggers only on counts,
    # frontend.h:100 — but a long keyframe-less stretch lets the tracked set
    # age into a far-field/FOE-concentrated, z-degenerate geometry).
    max_keyframe_gap: int = 1_000_000
    # Fold evicted keyframes' information into a prior on the surviving
    # window poses (lego::Problem::marginalize, problem.cpp:617-781 — shipped
    # but never invoked by the reference pipeline, which discards on
    # eviction, map.cpp:34-86).  The prior is the recursive linearized kind
    # (VINS-style): re-observed landmarks overlap with it, so the weight
    # tempers double-counted information.
    use_marg_prior: bool = False
    marg_prior_weight: float = 0.5

    @staticmethod
    def from_config(cfg) -> "FrontendConfig":
        """Build from a utils.config.Config instance."""
        caps = Capacities(
            max_features=cfg["max_features"],
            window=cfg["keyframe_window_capacity"],
            active_landmarks=cfg["max_active_landmarks"],
            landmarks=cfg["max_landmarks"],
            ba_edges=cfg["max_ba_edges"],
        )
        return FrontendConfig(
            caps=caps,
            num_features=cfg["num_features"],
            num_features_init=cfg["num_features_init"],
            num_features_tracking=cfg["num_features_tracking"],
            num_features_tracking_bad=cfg["num_features_tracking_bad"],
            num_features_needed_for_keyframe=cfg["num_features_needed_for_keyframe"],
            stereo_depth_superior_limit=float(cfg["stereo_depth_superior_limit"]),
            stereo_depth_inferior_limit=float(cfg["stereo_depth_inferior_limit"]),
            ground_y_limit=float(cfg["ground_y_limit"]),
            detect_mask_half=cfg["detect_mask_half"],
            gftt=detect_ops.GFTTConfig(
                max_corners=cfg["num_features"],
                quality_level=cfg["gftt_quality_level"],
                min_distance=cfg["gftt_min_distance"],
            ),
            klt=klt_ops.KLTConfig(
                half_patch=cfg["klt_half_patch"],
                iterations=cfg["klt_iterations"],
                eps=cfg["klt_eps"],
                levels=cfg["klt_pyramid_levels"],
                scale=cfg["klt_pyramid_scale"],
                inverse=cfg["klt_inverse"],
            ),
            chi2_threshold=float(cfg["chi2_threshold"]),
            pose_outer_iterations=cfg["pose_outer_iterations"],
            pose_solver_iterations=cfg["pose_solver_iterations"],
            num_active_keyframes=cfg["num_active_keyframes"],
            min_dis_th=float(cfg["min_dis_th"]),
            sing_ratio_threshold=float(cfg["sing_ratio_threshold"]),
            stereo_fb_threshold=float(cfg["stereo_fb_threshold"]),
            track_fb_threshold=float(cfg["track_fb_threshold"]),
            stereo_matcher=cfg["stereo_matcher"],
            max_keyframe_gap=int(cfg["max_keyframe_gap"]),
            track_mode=cfg["track_mode"],
            track_min_zncc=float(cfg["track_min_zncc"]),
            track_levels=int(cfg["track_levels"]),
            use_marg_prior=bool(cfg["use_marg_prior"]),
            marg_prior_weight=float(cfg["marg_prior_weight"]),
        )


def _intr(rig: StereoRig) -> reprojection.Intrinsics:
    c = rig.left
    return reprojection.Intrinsics(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)


def _safe_gather_lm(lm_pos: jnp.ndarray, lm_idx: jnp.ndarray) -> jnp.ndarray:
    return lm_pos[jnp.maximum(lm_idx, 0)]


def track_last_frame(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_last,
    pyr_cur,
    feats: Features,
    lm_pos: jnp.ndarray,
    T_prior: jnp.ndarray,
    rel_motion: jnp.ndarray = None,
) -> Features:
    """TrackLastFrame (frontend_g2o.cpp:453-492): track features into the
    current frame, seeding landmark-linked lanes with their projection under
    the constant-velocity prior and unlinked lanes with the infinite-depth
    (rotation-only) flow of that prior.

    The rotation seed matters on rotation-heavy motion: a 3 deg/frame yaw
    moves features ~15 px, which zero-motion-seeded lanes only survive via
    the coarse pyramid levels the anchored tracker no longer runs
    (track_levels); rotating the ray K^-1 [u,v,1] by the relative rotation
    predicts that flow exactly for far points and well enough for near ones.

    track_mode "anchored" matches keyframe templates (drift-free); "frame"
    reproduces the reference's last-frame-to-current KLT with an optional
    forward-backward gate."""
    has_lm = feats.lm >= 0
    proj = rig.left.world2pixel(_safe_gather_lm(lm_pos, feats.lm), T_prior)
    if rel_motion is not None:
        c = rig.left
        R = rel_motion[:3, :3]
        dx = (feats.uv[:, 0] - c.cx) / c.fx
        dy = (feats.uv[:, 1] - c.cy) / c.fy
        d = jnp.stack([dx, dy, jnp.ones_like(dx)], axis=-1) @ R.T
        z = jnp.where(jnp.abs(d[:, 2]) > 1e-6, d[:, 2], 1.0)
        rot_guess = jnp.stack(
            [c.fx * d[:, 0] / z + c.cx, c.fy * d[:, 1] / z + c.cy], axis=-1
        )
    else:
        rot_guess = feats.uv
    guess = jnp.where(has_lm[:, None], proj, rot_guess)
    if cfg.track_mode == "anchored":
        klt_cfg = cfg.klt
        if 0 < cfg.track_levels < klt_cfg.levels:
            # anchors are stored finest-first, so truncating the level count
            # tracks on the finest `track_levels` levels only
            klt_cfg = klt_cfg._replace(levels=cfg.track_levels)
        kp2, ok = klt_ops.klt_pyramid_anchored(
            feats.anchor, feats.anchor_uv, pyr_cur, guess, feats.valid, klt_cfg,
            min_zncc=cfg.track_min_zncc,
        )
    else:
        kp2, ok = klt_ops.klt_pyramid(pyr_last, pyr_cur, feats.uv, guess, feats.valid, cfg.klt)
        if cfg.track_fb_threshold > 0:
            kp_back, ok_b = klt_ops.klt_pyramid(pyr_cur, pyr_last, kp2, feats.uv, ok, cfg.klt)
            rt = jnp.sum((kp_back - feats.uv) ** 2, axis=-1)
            ok = ok & ok_b & (rt < cfg.track_fb_threshold**2)
    return feats._replace(
        uv=kp2,
        uv_r=jnp.zeros_like(kp2),
        has_right=jnp.zeros_like(ok),
        valid=ok,
    )


def estimate_current_pose(
    cfg: FrontendConfig,
    rig: StereoRig,
    feats: Features,
    lm_pos: jnp.ndarray,
    T_prior: jnp.ndarray,
) -> Tuple[jnp.ndarray, Features, jnp.ndarray]:
    """EstimateCurrentPose (frontend_g2o.cpp:157-245): motion-only BA over
    features linked to landmarks; outlier features get their landmark link
    reset (:236-242).  Returns (T, feats', num_inliers)."""
    edge_valid = feats.valid & (feats.lm >= 0)
    p_world = _safe_gather_lm(lm_pos, feats.lm)
    kw = dict(
        chi2_th=cfg.chi2_threshold,
        outer_iterations=cfg.pose_outer_iterations,
        exclude_outliers=cfg.pose_exclude_outliers,
    )

    def kernel(T_prior, p_world, uv, edge_valid):
        c = rig.left
        intr = jnp.stack([jnp.asarray(x, jnp.float32) for x in (c.fx, c.fy, c.cx, c.cy)])
        return pose_pallas.estimate_pose_pallas(
            intr, T_prior, p_world, uv, edge_valid,
            iterations=cfg.pose_solver_iterations, **kw,
        )

    def xla(T_prior, p_world, uv, edge_valid):
        return lm_ops.estimate_pose(
            _intr(rig), T_prior, p_world, uv, edge_valid,
            cfg=lm_ops.LMConfig(iterations=cfg.pose_solver_iterations), **kw,
        )

    T, inlier, n_in = jax.lax.platform_dependent(
        T_prior, p_world, feats.uv, edge_valid, cuda=kernel, default=xla
    )
    # Outlier features lose their landmark but remain usable (frontend_g2o.cpp:236-242).
    new_lm = jnp.where(edge_valid & ~inlier, -1, feats.lm)
    return T, feats._replace(lm=new_lm), n_in


def detect_features(cfg: FrontendConfig, img: jnp.ndarray, feats: Features) -> Features:
    """DetectFeatures (frontend_g2o.cpp:279-297): GFTT with a mask around
    existing features; detections are appended after compacting live lanes to
    the front of the table (the fixed-shape analogue of push_back).

    Capacity policy (no reference analogue — its feature vector is unbounded):
    room for `num_features` fresh detections is always reserved by dropping
    *unlinked* existing lanes first (they already failed triangulation at an
    earlier keyframe and cannot contribute to pose estimation).  Without this
    the table saturates after a few keyframes, detection starves, and the
    aging track set degenerates toward the focus of expansion.
    """
    mask = detect_ops.occupancy_mask(img.shape, feats.uv, feats.valid, cfg.detect_mask_half)
    pos, dvalid = detect_ops.detect(img, cfg.gftt, exclude_mask=mask)

    nf = cfg.caps.max_features
    quota = max(nf - cfg.gftt.max_corners, 0)
    linked = feats.valid & (feats.lm >= 0)
    # Priority: linked live lanes, then unlinked live lanes, then free slots.
    key = jnp.where(linked, 0, jnp.where(feats.valid, 1, 2))
    order = jnp.argsort(key, stable=True)
    compact = jax.tree_util.tree_map(lambda a: a[order], feats)
    n_linked = jnp.sum(linked.astype(jnp.int32))
    rank = jnp.arange(nf, dtype=jnp.int32)
    keep = compact.valid & (rank < jnp.maximum(quota, n_linked))
    compact = compact._replace(valid=keep)
    n_live = compact.count()
    tgt = n_live + jnp.arange(pos.shape[0], dtype=jnp.int32)
    put = dvalid & (tgt < nf)
    # Dummy writes go out of bounds and are dropped — collapsing them onto a
    # real slot would race a genuine write to that slot (duplicate-index .set
    # order is unspecified).
    tgt = jnp.where(put, tgt, nf)
    uv = compact.uv.at[tgt].set(pos, mode="drop")
    valid = compact.valid.at[tgt].set(True, mode="drop")
    lmv = compact.lm.at[tgt].set(-1, mode="drop")
    return compact._replace(
        uv=uv,
        uv_r=jnp.zeros_like(uv),
        has_right=jnp.zeros_like(valid),
        lm=lmv,
        valid=valid,
    )


def find_features_in_right(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    feats: Features,
    lm_pos: jnp.ndarray,
    T_cur: jnp.ndarray,
) -> Features:
    """FindFeaturesInRight (frontend_g2o.cpp:495-535).

    stereo_matcher == "klt": the reference's general 2-D pyramid KLT seeded by
    landmark projections (plus optional forward-backward gating).
    stereo_matcher == "scanline": epipolar-constrained coarse-scan + 1-D GN
    (ops/stereo.py) with the search range derived from the depth gates.
    """
    if cfg.stereo_matcher == "scanline":
        fxb = float(rig.left.fx) * float(rig.right.baseline)
        z_inf = max(cfg.stereo_depth_inferior_limit, 0.5)
        d_max = fxb / z_inf
        d_lo = fxb / cfg.stereo_depth_superior_limit
        scan_cfg = cfg.scanline._replace(levels=cfg.klt.levels, scale=cfg.klt.scale)
        kp_r, ok = stereo_ops.match(pyr_left, pyr_right, feats.uv, feats.valid, d_lo, d_max, scan_cfg)
        return feats._replace(uv_r=kp_r, has_right=ok)

    has_lm = feats.lm >= 0
    proj = rig.right.world2pixel(_safe_gather_lm(lm_pos, feats.lm), T_cur)
    guess = jnp.where(has_lm[:, None], proj, feats.uv)
    kp_r, ok = klt_ops.klt_pyramid(pyr_left, pyr_right, feats.uv, guess, feats.valid, cfg.klt)
    if cfg.stereo_fb_threshold > 0:
        kp_back, ok_b = klt_ops.klt_pyramid(pyr_right, pyr_left, kp_r, feats.uv, ok, cfg.klt)
        rt = jnp.sum((kp_back - feats.uv) ** 2, axis=-1)
        ok = ok & ok_b & (rt < cfg.stereo_fb_threshold**2)
    return feats._replace(uv_r=kp_r, has_right=ok)


def triangulate_new_points(
    cfg: FrontendConfig,
    rig: StereoRig,
    feats: Features,
    wmap: WorldMap,
    T_cur: jnp.ndarray,
) -> Tuple[Features, WorldMap, jnp.ndarray]:
    """TriangulateNewPoints / BuildInitMap core (frontend_g2o.cpp:111-155,
    310-349): DLT-triangulate features that have a right match but no
    landmark, gate on the singular-value ratio, the y <= 2 m ground
    constraint, and the stereo depth limits, then allocate landmark slots.

    Returns (feats', map', born_mask) where born_mask marks lanes whose
    landmark was created here (their right observation joins the BA graph).
    """
    cand = feats.valid & feats.has_right & (feats.lm < 0)
    pn_l = rig.left.pixel2camera(feats.uv)[..., :2]
    pn_r = rig.right.pixel2camera(feats.uv_r)[..., :2]
    pt_rig, ok = triangulation.triangulate_stereo(
        rig.left.pose, rig.right.pose, pn_l, pn_r, cfg.sing_ratio_threshold
    )
    accept = (
        cand
        & ok
        & (pt_rig[:, 1] <= cfg.ground_y_limit)
        & (pt_rig[:, 2] > cfg.stereo_depth_inferior_limit)
        & (pt_rig[:, 2] <= cfg.stereo_depth_superior_limit)
    )
    p_world = se3.transform(se3.se3_inv(T_cur), pt_rig)

    # Slot allocation: ids = cursor + rank among accepted lanes.
    rank = jnp.cumsum(accept.astype(jnp.int32)) - 1
    new_id = wmap.lm_next + rank
    in_cap = new_id < cfg.caps.landmarks
    put = accept & in_cap
    # Rejected lanes scatter out of bounds and are dropped (a clipped dummy
    # index would race a real write to that slot when the table is near full).
    idx = jnp.where(put, new_id, cfg.caps.landmarks)
    lm_pos = wmap.lm_pos.at[idx].set(p_world, mode="drop")
    lm_alive = wmap.lm_alive.at[idx].set(True, mode="drop")
    n_new = jnp.sum(put.astype(jnp.int32))
    wmap = wmap._replace(lm_pos=lm_pos, lm_alive=lm_alive, lm_next=wmap.lm_next + n_new)
    feats = feats._replace(lm=jnp.where(put, new_id, feats.lm))
    return feats, wmap, put


def _evict_if_full(cfg: FrontendConfig, wmap: WorldMap, T_cur: jnp.ndarray) -> WorldMap:
    """Map::RemoveOldKeyframe + CleanMap (src/map.cpp:34-100): when the window
    holds num_active keyframes, drop the closest one to the current pose if it
    is nearer than min_dis_th, else the farthest; un-register its observations
    and deactivate landmarks whose observation count hits zero."""
    full = wmap.num_keyframes() >= cfg.num_active_keyframes

    Twc = se3.se3_inv(T_cur)
    rel = wmap.kf_pose @ Twc
    dis = jnp.linalg.norm(se3.se3_log(rel), axis=-1)
    big = jnp.asarray(1e30, dis.dtype)
    dis_valid = jnp.where(wmap.kf_valid, dis, big)
    min_slot = jnp.argmin(dis_valid)
    max_slot = jnp.argmax(jnp.where(wmap.kf_valid, dis, -big))
    evict = jnp.where(dis_valid[min_slot] < cfg.min_dis_th, min_slot, max_slot)

    # Un-register this keyframe's observations (map.cpp:72-82).
    obs_l = wmap.kf_obs_left[evict] & full
    obs_r = wmap.kf_obs_right[evict] & full
    lm_idx = jnp.maximum(wmap.kf_lm[evict], 0)
    dec = obs_l.astype(jnp.int32) + obs_r.astype(jnp.int32)
    lm_obs = wmap.lm_obs.at[lm_idx].add(-dec)
    # CleanMap (map.cpp:88-100) needs no explicit step: "active" is *derived*
    # as lm_alive & (lm_obs > 0) (state.WorldMap.lm_active_mask), so landmarks
    # whose count just hit zero leave the active set by definition (they stay
    # alive in the global table for the viewer).

    # use_marg_prior: instead of discarding the evicted keyframe's
    # information, marginalize its 6 coordinates out of the window's pose
    # information at the last BA linearization (wmap.marg.info_*) and keep
    # the Schur complement as a sqrt-form prior on the survivors
    # (problem.cpp:617-781, which the reference ships but never calls).
    if cfg.use_marg_prior:
        from legoslam.solver import marginalization

        mg = wmap.marg
        KW = wmap.kf_valid.shape[0]
        # Only coordinates whose slot still holds the keyframe the info was
        # linearized for participate; stale slots zero out (their information
        # is lost, exactly like the baseline eviction).
        slot_ok = (mg.info_kf_id >= 0) & (mg.info_kf_id == wmap.kf_id) & wmap.kf_valid
        m6 = jnp.repeat(slot_ok, 6).astype(wmap.kf_pose.dtype)
        S = mg.info_S * m6[:, None] * m6[None, :]
        b = mg.info_b * m6
        marg_mask = jnp.repeat(jnp.arange(KW) == evict, 6)
        factor = marginalization.marginalize(S, b, marg_mask, 6)
        prior_kf_id = jnp.where(slot_ok & (jnp.arange(KW) != evict), mg.info_kf_id, -1)
        wmap = wmap._replace(
            marg=mg._replace(
                prior_J=jnp.where(full, factor.sqrt_J, mg.prior_J),
                prior_err=jnp.where(full, factor.err, mg.prior_err),
                prior_T=jnp.where(full, mg.info_T, mg.prior_T),
                prior_kf_id=jnp.where(full, prior_kf_id, mg.prior_kf_id),
            )
        )

    def clear(slot_arr, fill):
        return slot_arr.at[evict].set(jnp.where(full, fill, slot_arr[evict]))

    return wmap._replace(
        lm_obs=lm_obs,
        kf_valid=clear(wmap.kf_valid, False),
        kf_id=clear(wmap.kf_id, -1),
        kf_frame_id=clear(wmap.kf_frame_id, -1),
        kf_obs_left=clear(wmap.kf_obs_left, jnp.zeros_like(wmap.kf_obs_left[0])),
        kf_obs_right=clear(wmap.kf_obs_right, jnp.zeros_like(wmap.kf_obs_right[0])),
        kf_lm=clear(wmap.kf_lm, jnp.full_like(wmap.kf_lm[0], -1)),
    )


def insert_keyframe(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    img_left: jnp.ndarray,
    feats: Features,
    wmap: WorldMap,
    T_cur: jnp.ndarray,
    frame_id: jnp.ndarray,
) -> Tuple[Features, WorldMap]:
    """InsertKeyframe (frontend_g2o.cpp:77-102): evict-if-full, register
    tracked observations, detect new features, match them in the right image,
    triangulate, and write the keyframe record."""
    wmap = _evict_if_full(cfg, wmap, T_cur)
    with jax.named_scope("gftt_detect"):
        feats = detect_features(cfg, img_left, feats)
    # Re-anchor every live template at this keyframe (bounds appearance drift
    # to one keyframe gap; gives fresh detections their first template).
    with jax.named_scope("extract_anchors"):
        feats = feats._replace(
            anchor=klt_ops.extract_anchors(pyr_left, feats.uv, cfg.klt), anchor_uv=feats.uv
        )
    with jax.named_scope("stereo_match"):
        feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats, wmap.lm_pos, T_cur)
    with jax.named_scope("triangulate"):
        feats, wmap, born = triangulate_new_points(cfg, rig, feats, wmap, T_cur)

    slot = jnp.argmin(wmap.kf_valid)  # first free slot (capacity > window size)
    obs_left = feats.valid & (feats.lm >= 0)
    obs_right = born
    lm_idx = jnp.maximum(feats.lm, 0)
    inc = jnp.where(obs_left, 1, 0) + jnp.where(obs_right, 1, 0)
    wmap = wmap._replace(
        lm_obs=wmap.lm_obs.at[lm_idx].add(inc.astype(jnp.int32)),
        kf_pose=wmap.kf_pose.at[slot].set(T_cur),
        kf_id=wmap.kf_id.at[slot].set(wmap.next_kf_id),
        kf_frame_id=wmap.kf_frame_id.at[slot].set(frame_id.astype(jnp.int32)),
        kf_valid=wmap.kf_valid.at[slot].set(True),
        next_kf_id=wmap.next_kf_id + 1,
        kf_uv=wmap.kf_uv.at[slot].set(feats.uv),
        kf_uv_r=wmap.kf_uv_r.at[slot].set(feats.uv_r),
        kf_lm=wmap.kf_lm.at[slot].set(feats.lm),
        kf_obs_left=wmap.kf_obs_left.at[slot].set(obs_left),
        kf_obs_right=wmap.kf_obs_right.at[slot].set(obs_right),
    )
    return feats, wmap


def stereo_init(
    cfg: FrontendConfig,
    rig: StereoRig,
    pyr_left,
    pyr_right,
    img_left: jnp.ndarray,
    wmap: WorldMap,
    frame_id: jnp.ndarray,
) -> Tuple[jnp.ndarray, Features, WorldMap]:
    """StereoInit + BuildInitMap (frontend_g2o.cpp:258-349): detect, stereo
    match, and — when enough matches exist — triangulate the initial map and
    insert the first keyframe at the identity pose.

    Returns (success, feats, map').  On failure the inputs pass through
    unchanged (the reference stays INITING and retries next frame).
    """
    empty = Features.empty(cfg.caps, img_left.dtype, cfg.klt.levels, 2 * cfg.klt.half_patch + 3)
    feats = detect_features(cfg, img_left, empty)
    feats = feats._replace(
        anchor=klt_ops.extract_anchors(pyr_left, feats.uv, cfg.klt), anchor_uv=feats.uv
    )
    T0 = jnp.eye(4, dtype=img_left.dtype)
    feats = find_features_in_right(cfg, rig, pyr_left, pyr_right, feats, wmap.lm_pos, T0)
    n_match = jnp.sum((feats.valid & feats.has_right).astype(jnp.int32))
    success = n_match >= cfg.num_features_init

    def do_init(operand):
        feats, wmap = operand
        feats, wmap, born = triangulate_new_points(cfg, rig, feats, wmap, T0)
        slot = jnp.argmin(wmap.kf_valid)
        obs_left = feats.valid & (feats.lm >= 0)
        lm_idx = jnp.maximum(feats.lm, 0)
        inc = jnp.where(obs_left, 1, 0) + jnp.where(born, 1, 0)
        wmap = wmap._replace(
            lm_obs=wmap.lm_obs.at[lm_idx].add(inc.astype(jnp.int32)),
            kf_pose=wmap.kf_pose.at[slot].set(T0),
            kf_id=wmap.kf_id.at[slot].set(wmap.next_kf_id),
            kf_frame_id=wmap.kf_frame_id.at[slot].set(frame_id.astype(jnp.int32)),
            kf_valid=wmap.kf_valid.at[slot].set(True),
            next_kf_id=wmap.next_kf_id + 1,
            kf_uv=wmap.kf_uv.at[slot].set(feats.uv),
            kf_uv_r=wmap.kf_uv_r.at[slot].set(feats.uv_r),
            kf_lm=wmap.kf_lm.at[slot].set(feats.lm),
            kf_obs_left=wmap.kf_obs_left.at[slot].set(obs_left),
            kf_obs_right=wmap.kf_obs_right.at[slot].set(born),
        )
        return feats, wmap

    feats, wmap = jax.lax.cond(success, do_init, lambda op: op, (feats, wmap))
    return success, feats, wmap
