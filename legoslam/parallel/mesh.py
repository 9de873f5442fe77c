"""Device-mesh helpers.

The reference's only parallelism is threads in one process (SURVEY §2); here
work is distributed over a `jax.sharding.Mesh`.  One flat axis ("ba") is all
this workload needs, and it suits GPUs joined all to all by NVLink: BA edges/landmarks shard across it
(parallel/dist_ba.py) and KLT keypoint lanes shard across it for tracking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


BA_AXIS = "ba"


def make_mesh(devices: Optional[Sequence] = None, axis: str = BA_AXIS) -> Mesh:
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def edge_sharding(mesh: Mesh, axis: str = BA_AXIS) -> NamedSharding:
    """Sharding for (E, ...) per-edge / per-keypoint arrays."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
