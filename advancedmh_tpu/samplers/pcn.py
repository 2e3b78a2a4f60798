"""Preconditioned Crank-Nicolson MH (Cotter et al. 2013; Beskos et al. 2008).

Beyond-parity sampler — the MH cousin of :class:`EllipticalSlice`
(samplers/ess.py) for targets ``likelihood × Gaussian prior``: the proposal

    x' = m + √(1−β²)·(x − m) + β·(ν − m),        ν ~ N(m, C)  (the prior)

is *reversible with respect to the prior*, so the acceptance ratio is the
**likelihood difference only** — the model's logdensity must be the
log-likelihood (the Gaussian prior enters through the proposal), exactly the
ESS contract. The dimension-independence property that makes pCN the
function-space standard: β controls mixing without any d-dependent scale
collapse, so the same β works for d=2 and d=10⁴ latent fields.

Where ESS is rejection-free but costs a shrinkage loop of likelihood
evaluations per step, pCN costs exactly ONE likelihood evaluation per step —
that makes it the throughput workhorse for GP/latent-field targets,
with ESS as the tuning-free fallback.

Promoted from the custom-sampler template (tests/test_custom_sampler.py
keeps the standard-normal demo as the extensibility example).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model, logdensity, logdensity_batched
from ..utils import KeyArray
from .base import Sampler, Transition, select_tree
from .ess import _base_shape, _flatten_prior


@dataclasses.dataclass(frozen=True)
class PreconditionedCrankNicolson(Sampler):
    """``PreconditionedCrankNicolson(prior, beta=0.2)``.

    ``prior`` — a :class:`Normal` / :class:`MvNormal`, or a pytree of them
    matching the params pytree (each leaf an independent Gaussian block, as
    in EllipticalSlice). ``beta`` ∈ (0, 1]: β→0 is a timid prior-preserving
    walk, β=1 is independent prior resampling.
    """

    prior: Any
    beta: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.beta <= 1.0:
            raise ValueError(f"beta must be in (0, 1], got {self.beta}")

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """First step: draw from the prior unless ``initial_params`` given."""
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

    def _step_impl(self, key, state, model, batch_shape, lp_fn):
        model = as_model(model)
        dists, _ = _flatten_prior(self.prior)
        f_leaves = tuple(jax.tree_util.tree_leaves(state.params))
        if len(f_leaves) != len(dists):
            raise ValueError(
                f"prior has {len(dists)} leaves but params has "
                f"{len(f_leaves)} — the pytrees must match."
            )
        k_nu, k_acc = jax.random.split(key)
        rho = math.sqrt(1.0 - self.beta * self.beta)

        nu_keys = jax.random.split(k_nu, len(dists))
        cand_leaves = []
        for k, d, fl in zip(nu_keys, dists, f_leaves):
            base = _base_shape(d)
            m = jnp.asarray(d.loc, dtype=fl.dtype)
            nu = d.sample(k, jnp.shape(fl)[: fl.ndim - len(base)])
            cand_leaves.append(m + rho * (fl - m) + self.beta * (nu - m))
        treedef = jax.tree_util.tree_structure(state.params)
        cand = jax.tree_util.tree_unflatten(treedef, cand_leaves)

        lp_cand = lp_fn(cand)  # log-LIKELIHOOD only (prior in the proposal)
        accepted = (
            -jax.random.exponential(k_acc, batch_shape) < lp_cand - state.lp
        )
        bn = len(batch_shape)
        params = jax.tree_util.tree_map(
            lambda c, p: jnp.where(
                accepted.reshape(batch_shape + (1,) * (c.ndim - bn)), c, p
            ),
            cand,
            state.params,
        )
        lp = jnp.where(accepted, lp_cand, state.lp)
        t = Transition(params, lp, accepted)
        return t, t

    def step(
        self, key: KeyArray, state: Transition, model
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        return self._step_impl(
            key, state, model, (), lambda p: logdensity(model, p)
        )

    def step_batched(
        self, key: KeyArray, state: Transition, model, batch_shape: Tuple[int, ...]
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        return self._step_impl(
            key, state, model, batch_shape,
            lambda p: logdensity_batched(model, p),
        )
