"""Posterior agreement checks with Monte-Carlo standard errors.

Many-chain runs give an MCSE without any autocorrelation estimate: chains
that start independently and never interact are independent replicates, so
the standard error of a grand mean is the spread of the per-chain means
over √C. For samplers whose chains interact (ensembles, cross-chain
adaptation) the chains are not independent; :func:`batch_moments` instead
takes batch means over time of the cross-chain average.

Moments compared: the mean and the variance about a fixed center (the
reference's mean), so both estimates are plain averages with an MCSE.
Device arrays are reduced over the draw axis on the device (float32), and
only the per-chain or per-step averages come to the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _reduce(draws, axis: int, center):
    """Average of ``draws`` and of ``(draws - center)²`` over ``axis``, as
    float64 host arrays; ``center`` defaults to the grand mean."""
    xp = jnp if isinstance(draws, jax.Array) else np
    x = draws if xp is jnp else np.asarray(draws, np.float64)
    m = np.asarray(xp.mean(x, axis=axis), np.float64)
    c = m.mean(0) if center is None else np.asarray(center, np.float64)
    v = xp.mean((x - xp.asarray(c, x.dtype)) ** 2, axis=axis)
    return m, np.asarray(v, np.float64)


def chain_moments(draws, center=None) -> Dict[str, np.ndarray]:
    """Mean and variance (about ``center``, default the grand mean) of
    ``draws (C, N, d)`` with MCSEs from the spread over independent chains.
    """
    per_mean, per_var = _reduce(draws, 1, center)  # (C, d) each
    n = per_mean.shape[0]
    return {
        "mean": per_mean.mean(0),
        "mean_se": per_mean.std(0, ddof=1) / np.sqrt(n),
        "var": per_var.mean(0),
        "var_se": per_var.std(0, ddof=1) / np.sqrt(n),
    }


def batch_moments(draws, center=None, n_batches: int = 40):
    """As :func:`chain_moments` for interacting chains. ``draws (N, C, d)``
    (time first) is folded to the cross-chain average per step, and the
    MCSE comes from ``n_batches`` batch means over time."""
    n = draws.shape[0] // n_batches * n_batches
    m, v = _reduce(draws[:n], 1, center)  # (N, d) each
    bm = m.reshape(n_batches, -1, m.shape[-1]).mean(1)
    bv = v.reshape(n_batches, -1, v.shape[-1]).mean(1)
    return {
        "mean": bm.mean(0),
        "mean_se": bm.std(0, ddof=1) / np.sqrt(n_batches),
        "var": bv.mean(0),
        "var_se": bv.std(0, ddof=1) / np.sqrt(n_batches),
    }


def moments_agree(
    a: Dict[str, np.ndarray],
    b: Dict[str, np.ndarray],
    n_sigma: float = 4.0,
) -> Tuple[bool, float]:
    """Whether two moment sets agree within ``n_sigma`` combined MCSEs.
    Returns ``(ok, worst z)``."""
    z = []
    for k in ("mean", "var"):
        se = np.sqrt(a[k + "_se"] ** 2 + b[k + "_se"] ** 2)
        z.append(np.abs(a[k] - b[k]) / se)
    worst = float(np.max(np.concatenate(z)))
    return worst <= n_sigma, worst


def against_exact(
    m: Dict[str, np.ndarray],
    mean,
    var: Optional[np.ndarray] = None,
    n_sigma: float = 4.0,
) -> Tuple[bool, float]:
    """Whether estimated moments agree with exact ones within ``n_sigma``
    MCSEs; ``var`` is compared only if given (about the same center)."""
    z = [np.abs(m["mean"] - np.asarray(mean)) / m["mean_se"]]
    if var is not None:
        z.append(np.abs(m["var"] - np.asarray(var)) / m["var_se"])
    worst = float(np.max(np.concatenate(z)))
    return worst <= n_sigma, worst
