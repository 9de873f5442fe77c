"""Pose-graph optimization — the loop-closure backend scaffold.

The reference declares loop closure a TODO (CMakeLists.txt:74-77); the
BASELINE north star calls for "pose-graph optimization for the planned
loop-closure path".  This module provides it on device: all relative-pose
constraints are lanes of a batched residual/Jacobian computation, the dense
(6N x 6N) system assembles with one-hot matmuls, and the same functional
LM driver used for BA (solver/lm.py) runs the optimization.

Edge model: measurement M_ij ~= T_i T_j^-1 over camera-from-world poses,
residual r = Log(M_ij^-1 T_i T_j^-1), Gauss-Newton Jacobians in the standard
small-residual approximation (J_i = Ad(M^-1), J_j = -I), robustified by the
same Huber/Cauchy/Tukey kernels as BA.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from legoslam.geometry import se3
from legoslam.solver import lm as lm_ops
from legoslam.solver import robust


class PoseGraph(NamedTuple):
    """Fixed-shape constraint set over N poses.

    `weight` scales the translation components of the residual, `rot_weight`
    (defaulting to `weight` via `make`) the rotation components.  Relative
    ROTATIONS from odometry are usually far more reliable than relative
    translations (a distributed yaw correction moves downstream poses by
    lever-arm meters per radian), so loop distribution should bend the chain
    through translations first — weight rotations higher to express that."""

    e_i: jnp.ndarray      # (E,) int32 first vertex
    e_j: jnp.ndarray      # (E,) int32 second vertex
    T_meas: jnp.ndarray   # (E, 4, 4) measured T_i T_j^-1
    weight: jnp.ndarray   # (E,) translation information
    valid: jnp.ndarray    # (E,)
    fixed: jnp.ndarray    # (N,) gauge-fixing mask
    rot_weight: jnp.ndarray = None  # (E,) rotation information; None = weight

    def comp_weight(self) -> jnp.ndarray:
        """(E, 6) per-residual-component information, [rho, phi] order."""
        wt = self.weight
        wr = self.rot_weight if self.rot_weight is not None else self.weight
        return jnp.concatenate(
            [jnp.broadcast_to(wt[:, None], wt.shape + (3,)),
             jnp.broadcast_to(wr[:, None], wr.shape + (3,))], axis=-1
        )


def residuals(graph: PoseGraph, poses: jnp.ndarray) -> jnp.ndarray:
    Ti = poses[graph.e_i]
    Tj = poses[graph.e_j]
    rel = Ti @ se3.se3_inv(Tj)
    return se3.se3_log(se3.se3_inv(graph.T_meas) @ rel)  # (E, 6)


def graph_chi(
    poses: jnp.ndarray,
    graph: PoseGraph,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
) -> jnp.ndarray:
    """0.5 * robust chi2 of the whole graph — the quantity `optimize`
    minimizes, exposed for accept/reject gating by callers."""
    r = residuals(graph, poses)
    e2 = jnp.sum(graph.comp_weight() * r * r, axis=-1)
    rho0, _, _ = robust.rho(kernel, e2, delta)
    return 0.5 * jnp.sum(jnp.where(graph.valid, rho0, 0.0))


def _terms(graph: PoseGraph, poses: jnp.ndarray, kernel: str, delta: float):
    r = residuals(graph, poses)
    r = jnp.where(graph.valid[:, None], r, 0.0)
    cw = graph.comp_weight()                                       # (E, 6)
    e2 = jnp.sum(cw * r * r, axis=-1)
    _, rho1, _ = robust.rho(kernel, e2, delta)
    # Per-component effective information rho1 * diag(cw).
    wv = jnp.where(graph.valid[:, None], rho1[:, None] * cw, 0.0)  # (E, 6)
    # Small-residual GN Jacobians: left-perturbation on T_i maps through the
    # measurement frame; right-perturbation on T_j enters negated.
    Ji = se3.adjoint(se3.se3_inv(graph.T_meas))                    # (E, 6, 6)
    Jj = -jnp.broadcast_to(jnp.eye(6, dtype=poses.dtype), Ji.shape)
    # Fixed vertices contribute no Jacobian (problem.cpp:297).
    Ji = jnp.where((graph.fixed[graph.e_i])[:, None, None], 0.0, Ji)
    Jj = jnp.where((graph.fixed[graph.e_j])[:, None, None], 0.0, Jj)
    return r, Ji, Jj, wv


def _build(graph: PoseGraph, poses: jnp.ndarray, kernel: str, delta: float):
    N = poses.shape[0]
    E = graph.e_i.shape[0]
    dtype = poses.dtype
    r, Ji, Jj, wv = _terms(graph, poses, kernel, delta)

    onehot_i = (graph.e_i[:, None] == jnp.arange(N)[None, :]).astype(dtype)  # (E, N)
    onehot_j = (graph.e_j[:, None] == jnp.arange(N)[None, :]).astype(dtype)

    def blocks(Ja, Jb, oa, ob):
        # H[a, b] += Ja^T diag(wv) Jb routed by the one-hot vertex assignments.
        JtJ = jnp.einsum("eca,ec,ecb->eab", Ja, wv, Jb)              # (E, 6, 6)
        Va = JtJ.reshape(E, 36)[None, :, :] * oa.T[:, :, None]       # (N, E, 36)
        return jnp.einsum("en,aev->anv", ob, Va).reshape(N, N, 6, 6).transpose(1, 0, 2, 3)

    H = (
        blocks(Ji, Ji, onehot_i, onehot_i)
        + blocks(Ji, Jj, onehot_i, onehot_j)
        + blocks(Jj, Ji, onehot_j, onehot_i)
        + blocks(Jj, Jj, onehot_j, onehot_j)
    )
    bi = -jnp.einsum("eca,ec->ea", Ji, wv * r)
    bj = -jnp.einsum("eca,ec->ea", Jj, wv * r)
    b = onehot_i.T @ bi + onehot_j.T @ bj                            # (N, 6)
    H = H.transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)
    return H, b.reshape(-1)


def optimize(
    poses: jnp.ndarray,
    graph: PoseGraph,
    kernel: str = robust.HUBER,
    delta: float = 5.991,
    cfg: lm_ops.LMConfig = lm_ops.LMConfig(iterations=15),
) -> Tuple[jnp.ndarray, lm_ops.LMResult]:
    """LM over the pose graph; fixed poses stay put (gauge)."""
    N = poses.shape[0]

    def build(P):
        H, b = _build(graph, P, kernel, delta)
        return (H, b)

    def chi_fn(P):
        r = residuals(graph, P)
        e2 = jnp.sum(graph.comp_weight() * r * r, axis=-1)
        rho0, _, _ = robust.rho(kernel, e2, delta)
        return 0.5 * jnp.sum(jnp.where(graph.valid, rho0, 0.0))

    def solve_fn(aux, lam):
        H, b = aux
        diag = jnp.diagonal(H)
        if cfg.strategy == "strategy1":
            damped = diag + lam * diag
        else:
            damped = diag + lam
        damped = damped + jnp.where(jnp.abs(diag) <= 1e-12, 1.0, 0.0)
        n = H.shape[0]
        Hd = H.at[jnp.arange(n), jnp.arange(n)].set(damped)
        return jnp.linalg.solve(Hd, b).reshape(N, 6)

    def retract_fn(P, dx):
        dx = jnp.where(graph.fixed[:, None], 0.0, dx)
        return se3.retract(P, dx)

    def dot_scale(aux, dx, lam):
        H, b = aux
        flat = dx.reshape(-1)
        if cfg.strategy == "strategy1":
            return 0.5 * jnp.dot(flat, lam * jnp.diagonal(H) * flat + b)
        return 0.5 * jnp.dot(flat, lam * flat + b)

    def max_diag(aux):
        return jnp.max(jnp.abs(jnp.diagonal(aux[0])))

    fns = lm_ops.LMFunctions(build=build, chi=chi_fn, solve=solve_fn,
                             retract=retract_fn, dot_scale=dot_scale, max_diag=max_diag)
    res = lm_ops.lm_optimize(fns, poses, cfg)
    return res.state, res
