"""Delayed-rejection Metropolis-Hastings (Mira 2001; Haario et al. 2006).

Beyond-parity sampler (not in the reference). When the first-stage proposal
is rejected, a *second* proposal — typically a narrower kernel — gets a try
within the same step, with the acceptance probability corrected so the
composite kernel still satisfies detailed balance:

    α₂ = min(1, π(y₂) q₁(y₁|y₂) (1−α₁(y₂→y₁)) / [π(x) q₁(y₁|x) (1−α₁(x→y₁))])

(second-stage kernel terms cancel because q₂ is required symmetric and
depends only on the current point). DR lets one chain combine a bold scale
(good moves when accepted) with a timid fallback (keeps the chain moving
when the bold move fails) — with the AdaptiveMetropolis-style covariance
this composite is the classic DRAM.

Batched formulation: the reference CPU pattern ("only evaluate stage 2 when
stage 1 rejects") is a data-dependent branch that would serialize a chain
batch. Here BOTH stages are evaluated unconditionally — exactly two density
evaluations per step for every chain — and the stage-2 result is masked in
branchlessly, which is the natural shape for a vectorized/jit kernel (the
same always-evaluate-then-mask strategy as the fused MTM engine). The
1−α₁ factors are computed in log space with a −1e30 floor instead of −inf
so masked-out lanes can never produce inf−inf = NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model, logdensity, logdensity_batched
from ..proposals import (
    is_proposal,
    logratio_proposal_density,
    propose,
    propose_initial,
    q,
)
from ..utils import KeyArray
from .base import Sampler, Transition, accept_reject


def _log1m_exp(a: jax.Array) -> jax.Array:
    """log(1 − eᵃ) for a ≤ 0, floored at −1e30 (never −inf: masked lanes
    must not meet inf − inf). Stable on both branches (Mächler 2012)."""
    neg = a < 0
    a_s = jnp.where(neg, a, -1.0)  # dummy on the a ≥ 0 lanes (floored below)
    out = jnp.where(
        a_s > -0.693,
        jnp.log(-jnp.expm1(a_s)),
        jnp.log1p(-jnp.exp(a_s)),
    )
    return jnp.where(neg, jnp.maximum(out, -1e30), -1e30)


@dataclasses.dataclass(frozen=True)
class DelayedRejection(Sampler):
    """Two-stage delayed-rejection MH.

    ``first`` / ``second`` are proposal pytrees (as in MetropolisHastings).
    ``first`` must have evaluable leaf log-densities (its cross densities
    q₁(y₁|y₂), q₁(y₁|x) enter the stage-2 ratio even when symmetric);
    ``second`` must be symmetric — its terms then cancel from the ratio.
    Typical use: a bold Gaussian random walk first, the same shape scaled
    down ~5× second.
    """

    first: Any
    second: Any

    def __post_init__(self):
        leaves, _ = jax.tree_util.tree_flatten(self.second, is_leaf=is_proposal)
        if not all(getattr(p, "symmetric", False) for p in leaves):
            raise ValueError(
                "DelayedRejection requires a symmetric second-stage proposal "
                "(its q₂ terms must cancel from the stage-2 ratio); use a "
                "zero-mean random-walk leaf or SymmetricRandomWalkProposal."
            )

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        params = (
            propose_initial(key, self.first)
            if initial_params is None
            else initial_params
        )
        lp = logdensity(model, params)
        t = Transition(params, lp, jnp.zeros((), dtype=bool))
        return t, t

    def _step(self, key, state, model, batch_shape, lp_fn):
        bn = len(batch_shape)
        key_p1, key_a1, key_p2, key_a2 = jax.random.split(key, 4)
        x, lp0 = state.params, state.lp

        # Stage 1: standard MH try.
        y1 = propose(key_p1, self.first, x, batch_shape)
        lp1 = lp_fn(y1)
        la1 = lp1 - lp0 + logratio_proposal_density(
            self.first, x, y1, batch_ndim=bn
        )
        acc1 = accept_reject(key_a1, la1)

        # Stage 2 (evaluated unconditionally, masked in): timid retry.
        y2 = propose(key_p2, self.second, x, batch_shape)
        lp2 = lp_fn(y2)
        # Reverse-path stage-1 acceptance α₁(y₂→y₁).
        la1_rev = lp1 - lp2 + logratio_proposal_density(
            self.first, y2, y1, batch_ndim=bn
        )
        num = lp2 + q(self.first, y1, y2, batch_ndim=bn) + _log1m_exp(la1_rev)
        den = lp0 + q(self.first, y1, x, batch_ndim=bn) + _log1m_exp(la1)
        la2 = num - den
        acc2 = accept_reject(key_a2, la2) & ~acc1

        def sel(a, b, c):
            m1 = jnp.reshape(acc1, batch_shape + (1,) * (a.ndim - bn))
            m2 = jnp.reshape(acc2, batch_shape + (1,) * (a.ndim - bn))
            return jnp.where(m1, a, jnp.where(m2, b, c))

        params = jax.tree_util.tree_map(sel, y1, y2, x)
        lp = jnp.where(acc1, lp1, jnp.where(acc2, lp2, lp0))
        t = Transition(params, lp, acc1 | acc2)
        return t, t

    def step(
        self, key: KeyArray, state: Transition, model
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        return self._step(
            key, state, model, (), lambda p: logdensity(model, p)
        )

    def step_batched(
        self, key: KeyArray, state: Transition, model, batch_shape: Tuple[int, ...]
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        return self._step(
            key, state, model, batch_shape,
            lambda p: logdensity_batched(model, p),
        )
