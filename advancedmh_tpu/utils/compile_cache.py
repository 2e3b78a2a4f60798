"""Persistent XLA compilation cache for the scripts that drive the device.

Called by ``chip_smoke.py``, ``bench.py`` and ``benchmarks/*.py`` at start
(never at library import). If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and nothing is set here. Otherwise the cache goes to one
fixed, git-ignored directory of the checkout: the path is part of what a
cache entry is found by, so it is never built from a temporary name, a pid
or the time.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
