"""Generic Metropolis-Hastings kernel (≙ reference src/mh-core.jl).

One fused step: propose → logdensity → Hastings ratio → branchless
accept/reject. Under ``vmap`` this is a single XLA program over the whole
chain batch; under ``lax.scan`` the per-step Python dispatch of the reference
disappears entirely — N steps compile to one while-loop.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..distributions import MvNormal
from ..models.density import as_model, logdensity, logdensity_batched
from ..proposals import (
    RandomWalkProposal,
    StaticProposal,
    logratio_proposal_density,
    propose,
    propose_initial,
)
from ..utils import KeyArray
from .base import Sampler, Transition, accept_reject, select_tree
import dataclasses


@dataclasses.dataclass(frozen=True)
class MetropolisHastings(Sampler):
    """≙ ``MetropolisHastings(proposal)`` (src/mh-core.jl:44-46).

    ``proposal`` is a :class:`Proposal` leaf or an arbitrary pytree of
    proposals (dict ≙ NamedTuple, tuple, list); samples come back in the
    shape of the proposal.

    Samplers are plain (non-pytree) frozen dataclasses: kernels close over
    them, so their contents are baked into the compiled program as constants.
    """

    proposal: Any

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """First step (≙ src/mh-core.jl:76-86): draw from the proposal unless
        ``initial_params`` is given; the initial sample is the initial state."""
        model = as_model(model)
        params = (
            propose_initial(key, self.proposal)
            if initial_params is None
            else initial_params
        )
        lp = logdensity(model, params)
        t = Transition(params, lp, jnp.zeros((), dtype=bool))
        return t, t

    def step(
        self, key: KeyArray, state: Transition, model
    ) -> Tuple[Transition, Transition]:
        """Subsequent steps (≙ src/mh-core.jl:92-117)."""
        model = as_model(model)
        key_prop, key_acc = jax.random.split(key)

        candidate = propose(key_prop, self.proposal, state.params)
        lp_candidate = logdensity(model, candidate)
        logalpha = (
            lp_candidate
            - state.lp
            + logratio_proposal_density(self.proposal, state.params, candidate)
        )
        accepted = accept_reject(key_acc, logalpha)
        params = select_tree(accepted, candidate, state.params)
        lp = jnp.where(accepted, lp_candidate, state.lp)
        t = Transition(params, lp, accepted)
        return t, t

    def step_batched(
        self, key: KeyArray, state: Transition, model, batch_shape: Tuple[int, ...]
    ) -> Tuple[Transition, Transition]:
        """Vectorized step over a chain batch — the device hot path.

        Semantically equal to ``vmap(step)`` but with *batched RNG*: one key
        per step instead of one per (chain, step), so the per-step threefry
        cost is O(1) key hashing + O(chains) bit generation, all fused by XLA
        into the propose→logdensity→accept kernel.
        """
        model = as_model(model)
        key_prop, key_acc = jax.random.split(key)

        candidate = propose(key_prop, self.proposal, state.params, batch_shape)
        lp_candidate = logdensity_batched(model, candidate)
        logalpha = (
            lp_candidate
            - state.lp
            + logratio_proposal_density(
                self.proposal, state.params, candidate, batch_ndim=len(batch_shape)
            )
        )
        accepted = -jax.random.exponential(key_acc, batch_shape) < logalpha

        def sel(c, p):
            mask = accepted.reshape(batch_shape + (1,) * (c.ndim - len(batch_shape)))
            return jnp.where(mask, c, p)

        params = jax.tree_util.tree_map(sel, candidate, state.params)
        lp = jnp.where(accepted, lp_candidate, state.lp)
        t = Transition(params, lp, accepted)
        return t, t


def StaticMH(d) -> MetropolisHastings:
    """≙ ``StaticMH`` (src/mh-core.jl:48-49): independence sampler.

    ``StaticMH(k)`` with an int builds a standard k-dim MvNormal proposal
    (≙ ``MvNormal(Zeros(d), I)``).
    """
    if isinstance(d, int):
        d = MvNormal.standard(d)
    return MetropolisHastings(StaticProposal(d))


def _provably_symmetric_increment(payload) -> bool:
    """A random-walk increment with an even density (zero-mean Gaussian with
    any concrete scale) gives q(x'|x) = q(x|x') identically — safe to
    short-circuit the Hastings ratio to a trace-time 0."""
    from ..distributions import Normal

    if isinstance(payload, (MvNormal, Normal)):
        try:
            import numpy as np

            return bool(np.allclose(np.asarray(payload.loc), 0.0))
        except Exception:  # loc is a tracer — cannot prove at build time
            return False
    return False


def RWMH(d) -> MetropolisHastings:
    """≙ ``RWMH`` (src/mh-core.jl:50-51): random-walk Metropolis.

    ``RWMH(k)`` with an int builds a standard k-dim MvNormal increment.
    Zero-mean Gaussian increments (including the int form) are flagged
    symmetric: their q-ratio is identically 0 and the static flag removes it
    at trace time — the reference computes-and-cancels two d-dim logpdfs per
    step instead (src/proposal.jl:190-196 only short-circuits the
    ``Symmetric*`` aliases). Other payloads keep symmetric=False; wrap in
    ``SymmetricRandomWalkProposal`` to assert symmetry yourself.
    """
    if isinstance(d, int):
        d = MvNormal.standard(d)
    return MetropolisHastings(
        RandomWalkProposal(d, symmetric=_provably_symmetric_increment(d))
    )
