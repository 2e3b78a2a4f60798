"""Multi-host orchestration helpers.

≙ the reference's ``MCMCDistributed`` process-level chain parallelism
(SURVEY.md §2), scaled to several hosts: one JAX process per host, a
global 1-D ``chains`` mesh spanning all devices (NVLink within a host, the
network across), chains sharded over the global axis. Plain MH/MALA/RAM run with **zero hot-loop
collectives**; per-host shards never communicate until bundling.

Usage on each host::

    from advancedmh_tpu.parallel import multihost
    multihost.initialize()                      # jax.distributed.initialize()
    mesh = multihost.global_chain_mesh()
    chains = sample(model, spl, N, num_chains=131072,
                    chain_method=MCMCDistributed(mesh=mesh))

Determinism: the vectorized path derives per-step keys from the master key
and absolute iteration only, and partitionable threefry makes the sharded
random bits independent of the device layout — the same seed gives the same
chains at any host count.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from .mesh import make_mesh

_initialized = False

# Env vars whose presence marks a multi-host launch (explicit
# jax.distributed setups set one of these before process start).
_COORDINATOR_ENV_VARS = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")


def _multi_host_env() -> bool:
    return any(os.environ.get(v) for v in _COORDINATOR_ENV_VARS)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host runtime (no-op for a single process).

    Wraps ``jax.distributed.initialize``. **Call this before any other jax
    API** — even ``jax.process_count()`` initializes the local backend,
    after which distributed init is impossible; this function therefore
    decides single- vs multi-process from its arguments and the launch
    environment, never by probing jax, and lets real initialization errors
    propagate instead of silently degrading to per-host worlds.
    """
    global _initialized
    if _initialized:
        return
    explicit = coordinator_address is not None or num_processes not in (None, 1)
    if not explicit and not _multi_host_env():
        _initialized = True  # single-process run (tests, one host)
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def global_chain_mesh(axis: str = "chains") -> Mesh:
    """1-D mesh over *all* devices across all hosts."""
    return make_mesh(axis=axis, devices=jax.devices())


def process_local_chains(num_chains: int) -> int:
    """Chains hosted by this process under even sharding."""
    return num_chains // jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
