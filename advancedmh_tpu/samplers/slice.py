"""Slice sampling (Neal 2003, Annals of Statistics §4-5).

Beyond-parity sampler completing the slice family next to
:class:`EllipticalSlice` (≙ the reference's commented-out slice experiments,
src/emcee.jl:104-214, which mix slice and stretch moves). Unlike ESS it
needs no Gaussian-prior factorization — it slices the **full target log
density** along a line:

    u  ~ random direction (per-step; unit vector over the whole params
         pytree, or a coordinate axis — Neal §4 "multivariate via a
         sequence of directions"; random directions keep one slice/step)
    log y = log π(x) − Exponential(1)                (slice height)
    [L, R] = [−w·U, w(1−U)] expanded by Neal's stepping-out with budget m
             split randomly between the two ends (Fig. 3: J = ⌊m·V⌋,
             K = m−1−J) — finite budgets preserve correctness
    shrink: t ~ U(L, R); accept x + t·u iff log π > log y, else the
            rejected t becomes the new bracket end toward 0 (Fig. 5)

Rejection-free in the same sense as ESS: every step ends at an in-slice
point (up to the ``max_shrink`` safety bound — exhausted chains keep their
state and report ``accepted=False``).

Batched mapping: both data-dependent loops run as masked batched loops — the
stepping-out phase is a ``lax.fori_loop`` of ``max_stepout − 1`` trips
(static budget; each trip evaluates *both* bracket ends for the whole chain
batch and expands only lanes with budget left and an in-slice end), the
shrinkage phase a ``lax.while_loop`` that exits when every chain accepts.
All density evaluations are full-batch fused vmapped passes.

RNG: one key per step; loop redraws use ``fold_in(key, trip)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..models.density import as_model, logdensity, logdensity_batched
from ..utils import KeyArray
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class SliceSampler(Sampler):
    """``SliceSampler(width)``: random-direction slice sampling.

    ``width`` — the stepping-out unit w (Neal's only tuning knob; the
    sampler is robust to it within a couple orders of magnitude — too small
    costs stepping-out trips, too large costs shrinkage trips).

    ``max_stepout`` — Neal's interval budget m (the bracket can grow to
    ``m·width``; finite m is part of the correct algorithm, not a truncation).

    ``max_shrink`` — hard bound on shrinkage trips (safety; the loop exits
    as soon as every chain in the batch accepts).
    """

    width: float = 1.0
    max_stepout: int = 8
    max_shrink: int = 32

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """Requires initial parameters (the target is a black-box density —
        there is nothing to draw a start from, ≙ MALA src/MALA.jl:37)."""
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        lp = logdensity(model, initial_params)
        t = Transition(initial_params, lp, jnp.zeros((), dtype=bool))
        return t, t

    # -- shared core (batch_shape=() is the single-chain step) ---------------

    def _step_impl(
        self, key: KeyArray, state: Transition, model, batch_shape
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        bn = len(batch_shape)
        leaves, treedef = jax.tree_util.tree_flatten(state.params)

        k_dir, k_y, k_int, k_split, k_shrink = jax.random.split(key, 5)

        # Random unit direction over the WHOLE pytree: per-leaf normals
        # normalized by the global L2 norm (reduced over event dims only).
        dir_keys = jax.random.split(k_dir, len(leaves))
        raw = [
            jax.random.normal(k, jnp.shape(l)) for k, l in zip(dir_keys, leaves)
        ]
        sq = sum(
            jnp.sum(
                r * r, axis=tuple(range(bn, r.ndim))
            )
            for r in raw
        )  # (batch,)
        inv_norm = lax.rsqrt(jnp.maximum(sq, 1e-30))

        def bcast(v, like):
            return jnp.reshape(v, batch_shape + (1,) * (like.ndim - bn))

        u_dir = [r * bcast(inv_norm, r) for r in raw]

        def at(t):
            """Point x + t·u as leaves (t shaped (batch,))."""
            return tuple(
                l + bcast(t, l) * ul for l, ul in zip(leaves, u_dir)
            )

        def ld(point_leaves):
            params = treedef.unflatten(list(point_leaves))
            if bn == 0:
                return logdensity(model, params)
            if bn == 1:
                return logdensity_batched(model, params)
            fn = model.logdensity_fn
            for _ in range(bn):
                fn = jax.vmap(fn)
            return fn(params)

        logy = state.lp - jax.random.exponential(k_y, batch_shape)
        w = jnp.float32(self.width)

        # --- stepping out (Neal Fig. 3) ---------------------------------
        u0 = jax.random.uniform(k_int, batch_shape)
        L = -w * u0
        R = L + w
        m = self.max_stepout
        v = jax.random.uniform(k_split, batch_shape)
        J = jnp.floor(m * v)  # left budget
        K = (m - 1) - J  # right budget

        def expand(i, carry):
            L, R, J, K = carry
            grow_l = jnp.logical_and(J > 0, ld(at(L)) > logy)
            L = jnp.where(grow_l, L - w, L)
            J = jnp.where(grow_l, J - 1, jnp.zeros_like(J))
            grow_r = jnp.logical_and(K > 0, ld(at(R)) > logy)
            R = jnp.where(grow_r, R + w, R)
            K = jnp.where(grow_r, K - 1, jnp.zeros_like(K))
            return L, R, J, K

        if m > 1:
            L, R, _, _ = lax.fori_loop(0, m - 1, expand, (L, R, J, K))
        # final end checks consume the last budget units implicitly: ends
        # still in-slice after the loop simply stay — valid per Neal's
        # finite-m scheme (the interval is what the budget allowed).

        # --- shrinkage (Neal Fig. 5) -------------------------------------
        def cond(c):
            i, done = c[0], c[1]
            return jnp.logical_and(i < self.max_shrink, ~jnp.all(done))

        def body(c):
            i, done, L, R, res, res_lp = c
            u = jax.random.uniform(jax.random.fold_in(k_shrink, i), batch_shape)
            t = L + u * (R - L)
            cand = at(t)
            lp_c = ld(cand)
            ok = lp_c > logy
            newly = jnp.logical_and(ok, ~done)
            res = tuple(
                jnp.where(bcast(newly, cl) > 0, cl, rl)
                for cl, rl in zip(cand, res)
            )
            res_lp = jnp.where(newly, lp_c, res_lp)
            done = jnp.logical_or(done, ok)
            running = ~done
            L = jnp.where(jnp.logical_and(running, t < 0), t, L)
            R = jnp.where(jnp.logical_and(running, t >= 0), t, R)
            return (i + 1, done, L, R, res, res_lp)

        carry0 = (
            jnp.zeros((), jnp.int32),
            jnp.zeros(batch_shape, bool),
            L,
            R,
            tuple(leaves),
            state.lp,
        )
        _, done, _, _, res, res_lp = lax.while_loop(cond, body, carry0)
        t = Transition(treedef.unflatten(list(res)), res_lp, done)
        return t, t

    def step(
        self, key: KeyArray, state: Transition, model
    ) -> Tuple[Transition, Transition]:
        return self._step_impl(key, state, model, ())

    def step_batched(
        self, key: KeyArray, state: Transition, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, Transition]:
        """Vectorized step: one shared stepping-out/shrinkage loop for the
        whole chain batch; each trip is one fused batched density pass."""
        return self._step_impl(key, state, model, tuple(batch_shape))
