"""Device mesh helpers.

The reference's distributed backend is Julia ``Distributed`` workers (one
chain per process, TCP master/worker — SURVEY.md §2 'Distributed
communication backend'). Here it is a 1-D ``chains`` mesh over all devices
(every GPU of a host reaches every other over NVLink at the same rate, so the
mesh follows the algorithm alone): chains live as a sharded array axis,
there is no serialization boundary, and plain MH/MALA/RAM need zero
collectives in the hot loop.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(
    n_devices: Optional[int] = None,
    axis: str = "chains",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all local-process devices)."""
    devs = list(devices if devices is not None else jax.devices())
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"Requested {n_devices} devices but only {len(devs)} available."
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def chain_sharding(mesh: Mesh, axis: str = "chains") -> NamedSharding:
    """Sharding that splits the leading (chain/walker) axis over the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis))
