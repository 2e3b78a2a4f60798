"""Hardened device→host transfers for large sampler outputs.

A host pull of a large sampler output is transferred in bounded slices and
a handful of elements are verified against direct on-device reads. The
guard was added after large (≥512 MB) pulls came back wrong on an earlier
accelerator setup while smaller slices of the same buffer were exact;
whether it is still needed on the GPU is decided by the 512 MiB transfer
check in ``chip_smoke.py``.

:func:`safe_device_get` is the library-level guard: ``sample_chunked``
routes every host offload through it.
"""
from __future__ import annotations

from typing import Any

import jax
import numpy as np

# Slice size under the regime where corruption was seen (524 MB pulls bad,
# ≤65 MB pulls exact).
DEFAULT_MAX_CHUNK_BYTES = 64 << 20
_N_PROBES = 256  # elements spot-checked per array (one small gather)


class TransferVerificationError(RuntimeError):
    """A host-pulled element disagreed with the on-device value."""


def _get_chunked(arr, max_chunk_bytes: int) -> np.ndarray:
    """Pull ``arr`` in transfers each ≤ ``max_chunk_bytes``.

    Slices the *flattened* view, so every transfer is bounded regardless
    of shape (a single >64 MB leading-axis row, or shape[0] == 1, would
    defeat row-based slicing). The host buffer is preallocated and filled
    slice-by-slice — peak host memory is size + one slice, not 2·size.
    """
    nbytes = arr.size * arr.dtype.itemsize
    if nbytes <= max_chunk_bytes or arr.ndim == 0:
        return np.asarray(arr)
    flat = arr.reshape(-1)
    step = max(1, max_chunk_bytes // arr.dtype.itemsize)
    out = np.empty(arr.size, arr.dtype)
    for i in range(0, arr.size, step):
        out[i : i + step] = np.asarray(flat[i : i + step])
    return out.reshape(arr.shape)


_probe_calls = 0  # varies the probe set across calls (ADVICE r3: a
# size-only seed re-checked the identical indices on every re-pull retry,
# systematically missing a size-correlated corruption pattern)


def _probe_indices(size: int) -> np.ndarray:
    """Pseudo-random probe set (always incl. first/last), different on
    every call so re-pull retries sample independent index sets."""
    global _probe_calls
    _probe_calls += 1
    n = min(_N_PROBES, size)
    idx = np.random.default_rng((size, _probe_calls)).integers(
        0, size, size=n
    )
    idx[0] = 0
    if n > 1:
        idx[1] = size - 1
    return np.unique(idx)


def _verify(arr, host: np.ndarray) -> None:
    """Spot-check the pulled buffer against on-device values.

    ~256 pseudo-random elements are gathered ON DEVICE and transferred as
    one tiny (safe-regime) buffer, then compared bitwise. Against the
    observed ~2%-sparse corruption this detects a bad pull with
    probability ≈ 1 − 0.98²⁵⁶ ≈ 99.4% per array (and the corrupted-run
    incident involved several arrays) — a probabilistic tripwire, not a
    proof; reduce on device when the statistic allows it.
    """
    if host.size == 0:
        return
    idx = _probe_indices(host.size)
    dev_vals = np.asarray(jax.device_get(arr.reshape(-1)[idx]))
    host_vals = host.reshape(-1)[idx]
    ok = (dev_vals == host_vals) | (
        np.isnan(dev_vals) & np.isnan(host_vals)
    )
    if not ok.all():
        i = int(idx[int(np.argmin(ok))])
        raise TransferVerificationError(
            f"device→host transfer mismatch at flat index {i} "
            f"({int((~ok).sum())}/{ok.size} probes disagree; shape "
            f"{host.shape}, {host.nbytes >> 20} MB). Re-pull with a "
            "smaller max_chunk_bytes, or reduce on device and transfer "
            "scalars/slices."
        )


def safe_device_get(
    tree: Any,
    *,
    max_chunk_bytes: int = DEFAULT_MAX_CHUNK_BYTES,
    verify: bool = True,
) -> Any:
    """Transfer a pytree of device arrays to host numpy, hardened.

    Arrays larger than ``max_chunk_bytes`` are pulled in flat-view slices
    (each ≤ the bound), keeping every individual transfer below the
    observed-bad regime with peak host memory of size + one slice. With
    ``verify=True`` (default), ~256 deterministic pseudo-random elements
    of each pulled array are gathered on device, transferred as one tiny
    buffer, and compared bitwise — a mismatch raises
    :class:`TransferVerificationError` instead of silently returning
    corrupted statistics (≈99% detection against the observed ~2%-sparse
    corruption; a tripwire, not a proof). Host-side inputs (numpy arrays,
    scalars) pass through untouched.
    """

    def leaf(x):
        if not isinstance(x, jax.Array):
            return np.asarray(x) if hasattr(x, "__array__") else x
        host = _get_chunked(x, max_chunk_bytes)
        if verify:
            _verify(x, host)
        return host

    return jax.tree_util.tree_map(leaf, tree)
