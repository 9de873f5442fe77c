"""Closed-form reprojection residuals and analytic Jacobians, batched per edge.

Re-designs the SLAM<->solver adapter types (include/legoslam/lego_types.h):

- `EdgeProjectionPoseOnly` (lego_types.h:117-185): unary edge, residual
  ``z - pi(K (T pw))`` with a 2x6 pose Jacobian,
- `EdgeProjection` (lego_types.h:188-261): binary pose+point edge with camera
  extrinsic, residual ``z - pi(K (ext T pw))``, 2x6 pose and 2x3 point
  Jacobians.

Where the reference evaluates one edge per virtual call, here every edge of a
problem is a lane of a batched computation: inputs are gathered per-edge
arrays and all outputs come from a single fused elementwise pipeline.

Conventions (identical to the reference): residual = measurement - projection;
pose tangent is [rho, phi] with the left-multiplicative update Exp(d)T; the
pose Jacobian is evaluated at the *post-extrinsic* camera point — exact for
identity-rotation extrinsics like the KITTI stereo rig (lego_types.h:232-248),
and reproduced as-is for parity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from legoslam.geometry import se3

_EPS = 1e-18  # reference's divide guard (lego_types.h:143, 167)


class Intrinsics(NamedTuple):
    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def from_K(K: jnp.ndarray) -> "Intrinsics":
        return Intrinsics(K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2])


def project(intr: Intrinsics, p_cam: jnp.ndarray) -> jnp.ndarray:
    z = p_cam[..., 2] + _EPS
    return jnp.stack(
        [
            intr.fx * p_cam[..., 0] / z + intr.cx,
            intr.fy * p_cam[..., 1] / z + intr.cy,
        ],
        axis=-1,
    )


def _pose_jacobian(intr: Intrinsics, p_cam: jnp.ndarray) -> jnp.ndarray:
    """2x6 Jacobian of the residual wrt the pose tangent [rho, phi]
    (lego_types.h:147-178): rows stacked for u and v."""
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    zinv = 1.0 / (Z + _EPS)
    zinv2 = zinv * zinv
    fx, fy = intr.fx, intr.fy
    zero = jnp.zeros_like(X)
    row_u = jnp.stack(
        [-fx * zinv, zero, fx * X * zinv2, fx * X * Y * zinv2, -fx - fx * X * X * zinv2, fx * Y * zinv],
        axis=-1,
    )
    row_v = jnp.stack(
        [zero, -fy * zinv, fy * Y * zinv2, fy + fy * Y * Y * zinv2, -fy * X * Y * zinv2, -fy * X * zinv],
        axis=-1,
    )
    return jnp.stack([row_u, row_v], axis=-2)


def pose_only_edge(intr: Intrinsics, T_cw: jnp.ndarray, p_world: jnp.ndarray, uv: jnp.ndarray):
    """Batched `EdgeProjectionPoseOnly`.

    Args:
      intr: shared intrinsics (scalars).
      T_cw: (..., 4, 4) current pose estimate (broadcast against edges).
      p_world: (..., 3) per-edge landmark position (held constant).
      uv: (..., 2) per-edge pixel measurement.

    Returns (residual (..., 2), J_pose (..., 2, 6)).
    """
    p_cam = se3.transform(T_cw, p_world)
    r = uv - project(intr, p_cam)
    return r, _pose_jacobian(intr, p_cam)


def projection_edge(
    intr: Intrinsics,
    T_cw: jnp.ndarray,
    ext: jnp.ndarray,
    p_world: jnp.ndarray,
    uv: jnp.ndarray,
):
    """Batched `EdgeProjection` (pose + point, with camera extrinsic).

    Args:
      intr: shared intrinsics.
      T_cw: (..., 4, 4) per-edge keyframe pose (already gathered).
      ext: (..., 4, 4) per-edge camera-from-rig extrinsic (left/right).
      p_world: (..., 3) per-edge landmark position (already gathered).
      uv: (..., 2) per-edge measurement.

    Returns (residual (..., 2), J_pose (..., 2, 6), J_point (..., 2, 3)).
    """
    p_rig = se3.transform(T_cw, p_world)
    p_cam = se3.transform(ext, p_rig)
    r = uv - project(intr, p_cam)
    J_pose = _pose_jacobian(intr, p_cam)
    # J_point = J_pose[:, :3] @ R_ext @ R_T   (lego_types.h:251-253)
    R = ext[..., :3, :3] @ T_cw[..., :3, :3]
    J_point = J_pose[..., :, :3] @ R
    return r, J_pose, J_point
