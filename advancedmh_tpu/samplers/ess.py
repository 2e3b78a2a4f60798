"""Elliptical slice sampling (Murray, Adams & MacKay 2010, AISTATS).

≙ the reference's commented-out elliptical-slice ensemble moves
(src/emcee.jl:104-214: the ``EllipticalSlice`` / ``EllipticalSliceStretch``
proposal styles with the θ-bracket shrinkage ``while true`` loop), promoted
to a first-class, rejection-free sampler.

The target must factor as ``π(f) ∝ L(f) · N(f; μ, Σ)``: the **model's log
density is the log-likelihood ``log L`` only**, and the Gaussian factor is
supplied to the sampler as ``prior`` (a :class:`Normal`/:class:`MvNormal`
leaf or a pytree of them matching the params pytree). One step:

    ν  ~ N(μ, Σ)                                 (one draw per leaf)
    log y = log L(f) − Exponential(1)            (slice height, ≙ the
                                                  reference's ``walker.lp -
                                                  randexp()``, emcee.jl:123)
    θ  ~ U(0, 2π);  bracket [θ − 2π, θ]
    repeat: f' = μ + (f−μ)cos θ + (ν−μ)sin θ;  accept iff log L(f') > log y,
            else shrink the bracket toward 0 and redraw θ    (emcee.jl:131-150)

Every iteration of the shrinkage loop proposes on an ellipse through the
current state and the prior draw, so the prior marginal is preserved exactly
and the step has **no rejections and no tuning parameters**.

Batched mapping: the data-dependent ``while true`` becomes one
``lax.while_loop`` over the whole chain batch — each trip evaluates the
likelihood for *all* chains in one fused vmapped pass and updates only the
not-yet-done chains (masked select), exiting when every chain has accepted
(typically < 10 trips; ``max_shrink`` bounds the loop so a chain started in
a zero-likelihood region cannot hang the program — it keeps its state and
reports ``accepted=False``). This keeps shapes static and the density
evaluation batched, instead of the reference's per-walker scalar loop.

RNG: one key per step; the loop redraw at trip ``i`` uses
``fold_in(key, i)`` so the step is deterministic and chunking-independent.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..distributions import Distribution, MvNormal, Normal
from ..models.density import as_model, logdensity, logdensity_batched
from ..utils import KeyArray
from .base import Sampler, Transition

_TWO_PI = 2.0 * math.pi


def _is_dist(x) -> bool:
    return isinstance(x, Distribution)


def _flatten_prior(prior):
    """Prior pytree → (distribution leaves, treedef); validates Gaussianity."""
    dists, treedef = jax.tree_util.tree_flatten(prior, is_leaf=_is_dist)
    for d in dists:
        if not isinstance(d, (Normal, MvNormal)):
            raise TypeError(
                "EllipticalSlice requires a Gaussian prior on every leaf "
                f"(Normal or MvNormal), got {type(d).__name__}. The target "
                "must factor as likelihood × Gaussian prior; pass the "
                "non-Gaussian parts in the model's log density."
            )
    return dists, treedef


def _base_shape(d: Distribution) -> Tuple[int, ...]:
    """Shape of one unbatched draw from ``d`` (no RNG spent)."""
    return jax.eval_shape(d.sample, jax.random.key(0)).shape


@dataclasses.dataclass(frozen=True)
class EllipticalSlice(Sampler):
    """``EllipticalSlice(prior)``: rejection-free sampler for targets
    ``likelihood × Gaussian prior``.

    ``prior`` — a :class:`Normal` / :class:`MvNormal`, or a pytree of them
    matching the structure of the params pytree (dict ≙ NamedTuple
    composition, like proposal trees). The model's log density must be the
    **log-likelihood only** (the Gaussian prior enters through the ellipse).

    ``max_shrink`` — hard bound on bracket-shrinkage trips per step (the
    loop exits as soon as every chain in the batch accepts; Murray et al.
    report a handful of trips in practice).
    """

    prior: Any
    max_shrink: int = 64

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """First step: draw from the prior unless ``initial_params`` is given
        (≙ the step-init prior draw pattern, reference src/mh-core.jl:76-86)."""
        model = as_model(model)
        dists, treedef = _flatten_prior(self.prior)
        if initial_params is None:
            keys = jax.random.split(key, len(dists))
            params = treedef.unflatten(
                [d.sample(k) for k, d in zip(keys, dists)]
            )
        else:
            params = initial_params
        lp = logdensity(model, params)
        t = Transition(params, lp, jnp.zeros((), dtype=bool))
        return t, t

    # -- shared core (batch_shape=() is the single-chain step) ---------------

    def _step_impl(
        self, key: KeyArray, state: Transition, model, batch_shape
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        bn = len(batch_shape)
        dists, treedef = _flatten_prior(self.prior)
        f_leaves = tuple(jax.tree_util.tree_leaves(state.params))
        if len(f_leaves) != len(dists):
            raise ValueError(
                f"prior has {len(dists)} leaves but params has "
                f"{len(f_leaves)} — the pytrees must match."
            )

        k_nu, k_y, k_theta, k_shrink = jax.random.split(key, 4)

        # One prior draw per leaf, shaped like the (possibly chain-batched)
        # params leaf: sample_shape covers the leading batch axes.
        nu_keys = jax.random.split(k_nu, len(dists))
        m_leaves, nu_leaves = [], []
        for k, d, fl in zip(nu_keys, dists, f_leaves):
            base = _base_shape(d)
            m_leaves.append(jnp.asarray(d.loc, dtype=fl.dtype))
            nu_leaves.append(d.sample(k, jnp.shape(fl)[: fl.ndim - len(base)]))

        logy = state.lp - jax.random.exponential(k_y, batch_shape)
        theta0 = jax.random.uniform(
            k_theta, batch_shape, minval=0.0, maxval=_TWO_PI
        )

        def point(theta):
            """Ellipse point f'(θ) per leaf (θ broadcast over event dims)."""
            out = []
            for fl, nl, ml in zip(f_leaves, nu_leaves, m_leaves):
                shp = batch_shape + (1,) * (fl.ndim - bn)
                c = jnp.cos(theta).reshape(shp)
                s = jnp.sin(theta).reshape(shp)
                out.append(ml + (fl - ml) * c + (nl - ml) * s)
            return tuple(out)

        def loglike(leaves):
            params = treedef.unflatten(list(leaves))
            if bn == 0:
                return logdensity(model, params)
            if bn == 1:
                return logdensity_batched(model, params)
            fn = model.logdensity_fn
            for _ in range(bn):
                fn = jax.vmap(fn)
            return fn(params)

        def mask_sel(newly, cand, prev):
            m = newly.reshape(batch_shape + (1,) * (cand.ndim - bn))
            return jnp.where(m, cand, prev)

        def cond(carry):
            i, done = carry[0], carry[1]
            return jnp.logical_and(i < self.max_shrink, ~jnp.all(done))

        def body(carry):
            i, done, theta, tmin, tmax, res, res_lp = carry
            cand = point(theta)
            lp = loglike(cand)
            ok = lp > logy
            newly = jnp.logical_and(ok, ~done)
            res = tuple(
                mask_sel(newly, c, r) for c, r in zip(cand, res)
            )
            res_lp = jnp.where(newly, lp, res_lp)
            done = jnp.logical_or(done, ok)
            # Shrink the bracket toward θ=0 for still-running chains
            # (≙ reference emcee.jl:142-148).
            shrink = ~done
            tmin = jnp.where(jnp.logical_and(shrink, theta < 0), theta, tmin)
            tmax = jnp.where(jnp.logical_and(shrink, theta >= 0), theta, tmax)
            u = jax.random.uniform(jax.random.fold_in(k_shrink, i), batch_shape)
            theta = tmin + u * (tmax - tmin)
            return (i + 1, done, theta, tmin, tmax, res, res_lp)

        carry0 = (
            jnp.zeros((), jnp.int32),
            jnp.zeros(batch_shape, bool),
            theta0,
            theta0 - _TWO_PI,
            theta0,
            f_leaves,
            state.lp,
        )
        _, done, _, _, _, res, res_lp = lax.while_loop(cond, body, carry0)
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
        """Vectorized step: the whole chain batch shares one shrinkage loop —
        each trip is one fused batched likelihood evaluation; the loop exits
        when the slowest chain accepts."""
        return self._step_impl(key, state, model, tuple(batch_shape))
