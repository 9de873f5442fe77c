"""Headless viewer / visualization.

The reference runs a Pangolin GL thread continuously drawing the current
frame frustum, active keyframes, trajectory and landmarks with the camera
*following* the current pose, plus an OpenCV window of tracked features
(src/viewer.cpp:38-97 loop, :116-201 DrawFrame/Follow).  A GL window makes
no sense on a headless accelerator host, so this module collects the same data
streams — per-frame feature overlays (every N frames), map snapshots at
keyframe events, the full trajectory — and renders them to image files plus
an animated GIF: the artifacts reviewers actually consume from a headless
run.

`Viewer.add_current_frame` / `Viewer.update_map` mirror the reference's API
(viewer.h:24-31); everything is host-side and optional (matplotlib-gated).
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

from legoslam.utils.logging import get_logger

log = get_logger("legoslam.viewer")


class _FrameRecord(NamedTuple):
    index: int
    T_cw: np.ndarray            # (4, 4)
    img: Optional[np.ndarray]   # (H, W) uint8 or None
    features: Optional[np.ndarray]  # (M, 2) or None


class _MapRecord(NamedTuple):
    index: int
    kf_positions: np.ndarray    # (K, 3) world positions of active keyframes
    landmarks: np.ndarray       # (<=cap, 3) subsampled alive landmarks


class Viewer:
    """Collects viewer streams during a run and renders them on save().

    every_n: keep a feature-overlay record every N frames (the reference
    redraws every frame; a headless artifact stream decimates instead).
    max_landmarks: per-snapshot landmark subsample cap (memory bound).
    """

    def __init__(self, every_n: int = 1, max_landmarks: int = 4000):
        self.every_n = max(1, int(every_n))
        self.max_landmarks = max_landmarks
        self.trajectory: List[np.ndarray] = []   # T_cw per frame
        self.frames: List[_FrameRecord] = []
        self.map_history: List[_MapRecord] = []
        self.keyframe_poses: Optional[np.ndarray] = None
        self.landmarks: Optional[np.ndarray] = None
        self.last_frame_img: Optional[np.ndarray] = None
        self.last_features: Optional[np.ndarray] = None
        self._n = 0

    # --- reference-style API -------------------------------------------------
    def add_current_frame(self, T_cw, img=None, feature_uv=None, feature_valid=None) -> None:
        """Viewer::AddCurrentFrame (viewer.cpp:19-22)."""
        T = np.asarray(T_cw, np.float64)
        self.trajectory.append(T)
        keep = img is not None and (self._n % self.every_n == 0)
        self._n += 1
        if not keep:
            return
        im8 = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        feats = None
        if feature_uv is not None:
            uv = np.asarray(feature_uv)
            mask = (
                np.asarray(feature_valid)
                if feature_valid is not None
                else np.ones(len(uv), bool)
            )
            feats = uv[mask]
        self.frames.append(_FrameRecord(self._n - 1, T, im8, feats))
        self.last_frame_img = im8
        self.last_features = feats

    def update_map(self, keyframe_poses, keyframe_valid, lm_pos, lm_alive) -> None:
        """Viewer::UpdateMap (viewer.cpp:24-36): snapshot keyframes+landmarks."""
        kv = np.asarray(keyframe_valid)
        self.keyframe_poses = np.asarray(keyframe_poses)[kv]
        alive = np.asarray(lm_alive)
        self.landmarks = np.asarray(lm_pos)[alive]
        lms = self.landmarks
        if len(lms) > self.max_landmarks:
            step = int(np.ceil(len(lms) / self.max_landmarks))
            lms = lms[::step]
        kf_wc = (
            np.linalg.inv(self.keyframe_poses)[:, :3, 3]
            if len(self.keyframe_poses)
            else np.zeros((0, 3))
        )
        self.map_history.append(_MapRecord(self._n, kf_wc, lms.copy()))

    # --- rendering -----------------------------------------------------------
    def _follow_axes(self, ax, T_cw, mrec: Optional[_MapRecord], window: float = 30.0):
        """Camera-follow local top view (viewer.cpp Follow mode): landmarks +
        keyframes + frustum direction around the current camera position."""
        T_wc = np.linalg.inv(T_cw)
        c = T_wc[:3, 3]
        if mrec is not None and len(mrec.landmarks):
            ax.plot(mrec.landmarks[:, 0], mrec.landmarks[:, 2], ".", color="0.65", ms=1)
        if mrec is not None and len(mrec.kf_positions):
            ax.plot(mrec.kf_positions[:, 0], mrec.kf_positions[:, 2], "g^", ms=5)
        if self.trajectory:
            upto = np.linalg.inv(np.stack(self.trajectory))[:, :3, 3]
            ax.plot(upto[:, 0], upto[:, 2], "b-", lw=1.0)
        # frustum direction: camera z-axis in world
        z = T_wc[:3, 2] * 3.0
        ax.annotate(
            "", xy=(c[0] + z[0], c[2] + z[2]), xytext=(c[0], c[2]),
            arrowprops=dict(arrowstyle="->", color="r", lw=1.5),
        )
        ax.plot([c[0]], [c[2]], "rs", ms=6)
        ax.set_xlim(c[0] - window, c[0] + window)
        ax.set_ylim(c[2] - window * 0.5, c[2] + window * 1.5)
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])

    def _render_frame(self, plt, rec: _FrameRecord, mrec: Optional[_MapRecord]):
        """One composite frame: feature overlay + follow-mode local map."""
        fig, (ax_im, ax_map) = plt.subplots(
            1, 2, figsize=(12, 3.6), gridspec_kw={"width_ratios": [2.4, 1.0]}
        )
        ax_im.imshow(rec.img, cmap="gray", vmin=0, vmax=255)
        if rec.features is not None and len(rec.features):
            ax_im.plot(rec.features[:, 0], rec.features[:, 1], "g+", ms=5, mew=1.0)
        ax_im.set_title(f"frame {rec.index}: {0 if rec.features is None else len(rec.features)} tracked")
        ax_im.axis("off")
        self._follow_axes(ax_map, rec.T_cw, mrec)
        ax_map.set_title("local map (follow)")
        fig.tight_layout()
        return fig

    def _map_record_for(self, index: int) -> Optional[_MapRecord]:
        best = None
        for m in self.map_history:
            if m.index <= index + 1:
                best = m
            else:
                break
        return best

    def save(
        self,
        out_dir: str,
        ground_truth: Optional[np.ndarray] = None,
        gif: bool = True,
        frame_dumps: bool = True,
    ) -> List[str]:
        """Write trajectory / map / per-frame overlay images (+GIF); returns paths."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            log.warning("matplotlib unavailable; viewer output skipped")
            return []

        os.makedirs(out_dir, exist_ok=True)
        paths = []

        if self.trajectory:
            T_wc = np.linalg.inv(np.stack(self.trajectory))
            pos = T_wc[:, :3, 3]
            fig, ax = plt.subplots(figsize=(7, 7))
            ax.plot(pos[:, 0], pos[:, 2], "b-", lw=1.5, label="estimate")
            if ground_truth is not None:
                gt = np.asarray(ground_truth)[:, :3, 3]
                ax.plot(gt[:, 0], gt[:, 2], "k--", lw=1.0, label="ground truth")
            if self.keyframe_poses is not None and len(self.keyframe_poses):
                kf = np.linalg.inv(self.keyframe_poses)[:, :3, 3]
                ax.plot(kf[:, 0], kf[:, 2], "g^", ms=6, label="active keyframes")
            if self.landmarks is not None and len(self.landmarks):
                ax.plot(self.landmarks[:, 0], self.landmarks[:, 2], "r.", ms=1, alpha=0.4, label="landmarks")
            ax.set_xlabel("x [m]")
            ax.set_ylabel("z [m]")
            ax.axis("equal")
            ax.legend()
            ax.set_title("legoslam trajectory (top view)")
            p = os.path.join(out_dir, "trajectory.png")
            fig.savefig(p, dpi=120, bbox_inches="tight")
            plt.close(fig)
            paths.append(p)

        # Per-frame overlay stream + GIF (the reference's continuous windows).
        overlay_pngs = []
        if self.frames and frame_dumps:
            fdir = os.path.join(out_dir, "frames")
            os.makedirs(fdir, exist_ok=True)
            for rec in self.frames:
                fig = self._render_frame(plt, rec, self._map_record_for(rec.index))
                p = os.path.join(fdir, f"frame_{rec.index:05d}.png")
                fig.savefig(p, dpi=90)
                plt.close(fig)
                overlay_pngs.append(p)
            paths.extend(overlay_pngs)
        if overlay_pngs and gif and len(overlay_pngs) > 1:
            try:
                from PIL import Image

                ims = [Image.open(p).convert("P", palette=Image.ADAPTIVE) for p in overlay_pngs]
                gif_path = os.path.join(out_dir, "tracking.gif")
                ims[0].save(
                    gif_path, save_all=True, append_images=ims[1:],
                    duration=max(40, 40 * self.every_n), loop=0,
                )
                paths.append(gif_path)
            except Exception as e:  # PIL missing or codec issue — non-fatal
                log.warning("GIF assembly skipped: %s", e)

        if self.last_frame_img is not None and not self.frames:
            # legacy single-frame overlay (viewer fed only at the end)
            fig, ax = plt.subplots(figsize=(10, 4))
            ax.imshow(self.last_frame_img, cmap="gray")
            if self.last_features is not None and len(self.last_features):
                ax.plot(self.last_features[:, 0], self.last_features[:, 1], "g+", ms=6)
            ax.set_title("tracked features (last frame)")
            ax.axis("off")
            p = os.path.join(out_dir, "features.png")
            fig.savefig(p, dpi=120, bbox_inches="tight")
            plt.close(fig)
            paths.append(p)

        return paths
