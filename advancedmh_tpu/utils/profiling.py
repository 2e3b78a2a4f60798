"""Profiling & instrumentation hooks (SURVEY.md §5 'tracing/profiling').

The reference's only instrumentation is a progress bar; here profiling is
first-class: ``trace()`` wraps ``jax.profiler`` for TensorBoard-viewable
device traces of the sampling kernels, and ``Timer``/``throughput`` give
walltime that ends in ``jax.block_until_ready`` for honest samples/s
numbers (JAX returns before the device finishes; a timing without the
block measures the enqueue).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False) -> Iterator[None]:
    """Capture a device trace of the enclosed block (view in TensorBoard)."""
    jax.profiler.start_trace(logdir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Walltime of the enclosed block; end the block in
    ``jax.block_until_ready`` so that it times the device work."""

    def __init__(self):
        self.elapsed: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0


def throughput(fn, *args, iters: int = 3, warmup: int = 1, items: int = 1):
    """Measure items/s of ``fn(*args)`` with compile excluded.

    Runs ``warmup`` untimed calls (compile + cache) then ``iters`` timed
    calls; returns (items_per_s, seconds_per_call).
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return items / dt, dt
