"""Rank-1 Cholesky update/downdate.

≙ the reference's ``LinearAlgebra.lowrankupdate!``/``lowrankdowndate!`` calls
(reference src/RobustAdaptiveMetropolis.jl:167-170) — the one dense-linear-
algebra op in the reference with **no XLA primitive**, so it is hand-written
here as a JAX kernel (SURVEY.md §2 "native-code audit").

Given lower-triangular ``L`` with ``A = L Lᵀ`` and a vector ``v``, computes
the Cholesky factor of ``A + sign·v vᵀ`` via the classical O(d²) column sweep
(Givens for update, hyperbolic rotation for downdate — a single formula
parameterized by ``sign`` so the traced sign of RAM's Δα needs no
``lax.cond``).

:func:`chol_rank1_update` is a ``lax.fori_loop`` sweep with full-column
masked vector ops (statically unrolled for small ``d``); it ``vmap``s
cleanly over a chain batch.

A failed downdate (the updated matrix is not positive definite — the case
where Julia throws ``PosDefException``) is reported through the returned
``ok`` flag instead of an exception; RAM keeps the previous factor in that
case, which matches the *spirit* of the reference's eigenvalue clamp
(src/RobustAdaptiveMetropolis.jl:259-264) and is strictly more robust under
jit, where exceptions cannot exist.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


# Largest d whose sweep is statically unrolled; above it the masked
# fori_loop keeps the program small. The crossover on the GPU is not
# measured.
UNROLL_MAX_DIM = 16


def chol_rank1_update(
    L: jax.Array, v: jax.Array, sign: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Return (L', ok) with L' L'ᵀ = L Lᵀ + sign·v vᵀ.

    ``sign`` is a traced scalar in {+1, -1} (0 degrades to a no-op update).
    ``ok`` is False when a downdate loses positive-definiteness; callers
    should then discard ``L'``.

    For ``d <= UNROLL_MAX_DIM`` the column sweep is *statically unrolled*:
    every index is compile-time constant, so the batched (vmapped) form
    compiles to pure dense vector ops with no dynamic gather/scatter.
    Larger ``d`` falls back to a ``fori_loop`` with masked column ops.
    """
    d = L.shape[-1]
    dtype = L.dtype
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    if d <= UNROLL_MAX_DIM:
        # Work on the list of columns; all indices static.
        ok = jnp.asarray(True)
        cols = [L[:, k] for k in range(d)]
        mask = [jnp.arange(d) > k for k in range(d)]
        for k in range(d):
            col = cols[k]
            Lkk = col[k]
            vk = v[k]
            r2 = Lkk * Lkk + sign * vk * vk
            ok = ok & (r2 > 0)
            r = jnp.sqrt(jnp.maximum(r2, tiny))
            c = r / Lkk
            s = vk / Lkk
            newcol = jnp.where(mask[k], (col + sign * s * v) / c, col)
            newcol = newcol.at[k].set(r)
            cols[k] = newcol
            v = jnp.where(mask[k], c * v - s * newcol, v)
        return jnp.stack(cols, axis=1), ok

    rows = jnp.arange(d)

    def body(k, carry):
        L, v, ok = carry
        Lkk = L[k, k]
        vk = v[k]
        r2 = Lkk * Lkk + sign * vk * vk
        ok = ok & (r2 > 0)
        r = jnp.sqrt(jnp.maximum(r2, tiny))
        c = r / Lkk
        s = vk / Lkk
        below = rows > k
        col = L[:, k]
        # Updated column k: rows below the diagonal rotate with v.
        newcol = jnp.where(below, (col + sign * s * v) / c, col)
        newcol = newcol.at[k].set(r)
        L = L.at[:, k].set(newcol)
        # Rotate the remainder of v against the *updated* column.
        v = jnp.where(below, c * v - s * newcol, v)
        return L, v, ok

    L, _, ok = lax.fori_loop(0, d, body, (L, v, jnp.asarray(True)))
    return L, ok


def chol_rank1_update_batched(
    L: jax.Array, v: jax.Array, sign: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Batched over leading axes: L (..., d, d), v (..., d), sign (...)."""
    batch = L.shape[:-2]
    if not batch:
        return chol_rank1_update(L, v, sign)
    fn = chol_rank1_update
    for _ in batch:
        fn = jax.vmap(fn)
    return fn(L, v, jnp.broadcast_to(sign, batch))
