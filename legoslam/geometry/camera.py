"""Pinhole stereo camera model as a JAX pytree.

Re-designs the reference's `Camera` class (include/legoslam/camera.h:13-55,
src/camera.cpp:8-34): intrinsics fx/fy/cx/cy + baseline, plus the rig
extrinsic `pose` (``T_camera_from_rig``; the left camera is the rig origin).
Stored as arrays so a `StereoCamera` can ride through `jit` boundaries; every
transform broadcasts over batched points and poses.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from legoslam.geometry import se3


class Camera(NamedTuple):
    """One pinhole camera of the rig.

    Attributes:
      fx, fy, cx, cy: scalar intrinsics (arrays so dtype flows through jit).
      baseline: scalar stereo baseline (norm of the extrinsic translation,
        mirroring dataset.cpp:41-42).
      pose: (4, 4) extrinsic, camera-from-rig.
      pose_inv: (4, 4) rig-from-camera.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    baseline: jnp.ndarray
    pose: jnp.ndarray
    pose_inv: jnp.ndarray

    @staticmethod
    def create(fx, fy, cx, cy, baseline=0.0, pose=None, dtype=jnp.float32) -> "Camera":
        if pose is None:
            pose = jnp.eye(4, dtype=dtype)
        pose = jnp.asarray(pose, dtype)
        return Camera(
            fx=jnp.asarray(fx, dtype),
            fy=jnp.asarray(fy, dtype),
            cx=jnp.asarray(cx, dtype),
            cy=jnp.asarray(cy, dtype),
            baseline=jnp.asarray(baseline, dtype),
            pose=pose,
            pose_inv=se3.se3_inv(pose),
        )

    def K(self) -> jnp.ndarray:
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )

    # --- coordinate transforms (camera.cpp:8-34) -------------------------
    def world2camera(self, p_w: jnp.ndarray, T_cw: jnp.ndarray) -> jnp.ndarray:
        return se3.transform(self.pose, se3.transform(T_cw, p_w))

    def camera2world(self, p_c: jnp.ndarray, T_cw: jnp.ndarray) -> jnp.ndarray:
        return se3.transform(se3.se3_inv(T_cw), se3.transform(self.pose_inv, p_c))

    def camera2pixel(self, p_c: jnp.ndarray) -> jnp.ndarray:
        z = p_c[..., 2]
        return jnp.stack(
            [
                self.fx * p_c[..., 0] / z + self.cx,
                self.fy * p_c[..., 1] / z + self.cy,
            ],
            axis=-1,
        )

    def pixel2camera(self, p_p: jnp.ndarray, depth=1.0) -> jnp.ndarray:
        depth = jnp.asarray(depth, p_p.dtype)
        return jnp.stack(
            [
                (p_p[..., 0] - self.cx) / self.fx * depth,
                (p_p[..., 1] - self.cy) / self.fy * depth,
                jnp.broadcast_to(depth, p_p[..., 0].shape),
            ],
            axis=-1,
        )

    def pixel2world(self, p_p: jnp.ndarray, T_cw: jnp.ndarray, depth=1.0) -> jnp.ndarray:
        return self.camera2world(self.pixel2camera(p_p, depth), T_cw)

    def world2pixel(self, p_w: jnp.ndarray, T_cw: jnp.ndarray) -> jnp.ndarray:
        return self.camera2pixel(self.world2camera(p_w, T_cw))


class StereoRig(NamedTuple):
    """Left + right camera pair (left camera frame == rig frame)."""

    left: Camera
    right: Camera

    @staticmethod
    def from_kitti_projections(P0, P1, scale=1.0, dtype=jnp.float32) -> "StereoRig":
        """Build a rig from two KITTI 3x4 projection matrices.

        Mirrors Dataset::Init (dataset.cpp:13-51): ``t = K^-1 P[:, 3]``,
        intrinsics scaled by `scale` (the reference always uses 0.5 because it
        halves image resolution), baseline = ||t||, extrinsic = pure
        translation camera-from-rig.
        """
        import numpy as np

        cams = []
        for P in (np.asarray(P0, np.float64), np.asarray(P1, np.float64)):
            K = P[:, :3]
            t = np.linalg.solve(K, P[:, 3])
            Ks = K * scale
            pose = np.eye(4)
            pose[:3, 3] = t
            cams.append(
                Camera.create(
                    Ks[0, 0], Ks[1, 1], Ks[0, 2], Ks[1, 2],
                    baseline=float(np.linalg.norm(t)), pose=pose, dtype=dtype,
                )
            )
        return StereoRig(left=cams[0], right=cams[1])
