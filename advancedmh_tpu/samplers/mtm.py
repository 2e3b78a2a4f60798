"""Multiple-Try Metropolis (Liu, Liang & Wong 2000), vectorized.

Beyond-parity sampler (no reference equivalent — the reference's samplers are
all one-candidate-per-step, src/mh-core.jl:92-117). MTM is the natural
batched generalization of :class:`MetropolisHastings`: each step draws
``k`` candidates, evaluates all their log densities *in one batched call*,
selects one proportionally to its density (Gumbel-argmax), and accepts with
the multiple-try ratio

    logα = logsumexp(lp(y₁..y_k)) − logsumexp(lp(x*₁..x*_{k−1}), lp(x))

where the reference set ``x*`` is drawn around the selected candidate. With
``k = 1`` this reduces exactly to standard Metropolis-Hastings.

This is the symmetric-weight form (w(x, y) = π(y)), which requires a
*symmetric* proposal — asymmetric proposals raise at construction. The
2k−1 density evaluations per step are a batch axis fused with the chain axis,
so they are one batched density call per phase, while acceptance (and ESS
per step) rises with ``k``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from ..models.density import as_model, logdensity_batched
from ..proposals import RandomWalkProposal, is_proposal, propose
from ..utils import KeyArray
from .base import Transition, accept_reject
from .mh import MetropolisHastings, _provably_symmetric_increment


def _check_symmetric(proposals) -> None:
    leaves = jax.tree_util.tree_leaves(proposals, is_leaf=is_proposal)
    for p in leaves:
        if not is_proposal(p):
            raise ValueError(
                f"MultipleTryMetropolis proposal tree contains a non-proposal "
                f"leaf of type {type(p).__name__}"
            )
        if p.symmetric:
            continue
        if isinstance(p, RandomWalkProposal) and _provably_symmetric_increment(
            p.payload
        ):
            continue
        raise ValueError(
            "MultipleTryMetropolis uses the symmetric-weight form w(x, y) = "
            "π(y) and therefore requires a symmetric proposal; wrap the "
            "payload in SymmetricRandomWalkProposal (or use a zero-mean "
            "Gaussian random walk)."
        )


def _lp_leading(model, tree, lead_ndim: int) -> jax.Array:
    """Log density over ``lead_ndim`` leading batch axes: flatten them into
    the one chain axis ``logdensity_batched`` contracts over, then restore —
    so the model's batched density (or the vmapped fallback) sees a single
    ``k·chains`` batch per call."""
    if lead_ndim == 1:
        return logdensity_batched(model, tree)
    lead = jax.tree_util.tree_leaves(tree)[0].shape[:lead_ndim]
    flat = jax.tree_util.tree_map(
        lambda x: x.reshape((-1,) + x.shape[lead_ndim:]), tree
    )
    return logdensity_batched(model, flat).reshape(lead)


@dataclasses.dataclass(frozen=True)
class MultipleTryMetropolis(MetropolisHastings):
    """MTM(proposal, k): k-candidate Metropolis-Hastings.

    ``proposal`` is a symmetric :class:`Proposal` leaf or pytree of symmetric
    proposals (validated at construction). ``k`` is the static number of
    candidates per step; each step costs ``2k − 1`` log-density evaluations,
    all vectorized (and fused with the chain batch in ``step_batched``).

    Initialization is inherited from :class:`MetropolisHastings`
    (≙ src/mh-core.jl:76-86: draw from the proposal unless ``initial_params``
    is given).
    """

    k: int = 4

    def __post_init__(self):
        if int(self.k) < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        _check_symmetric(self.proposal)

    # -- shared core ---------------------------------------------------------

    def _mtm_core(self, key, state, model, batch_shape: Tuple[int, ...]):
        """One MTM step over ``batch_shape`` chains (may be ``()``).

        All candidate/reference axes are *leading* so chain layouts match the
        rest of the framework ((k,) + batch_shape + event).
        """
        k = int(self.k)
        key_cand, key_sel, key_ref, key_acc = jax.random.split(key, 4)
        bn = len(batch_shape)

        # k candidates around the current state, one RNG call per leaf.
        candidates = propose(
            key_cand, self.proposal, state.params, (k,) + batch_shape
        )
        lps = _lp_leading(model, candidates, 1 + bn)  # (k,) + batch_shape

        # Select J ∝ exp(lp_j): Gumbel-argmax (exact categorical draw).
        g = jax.random.gumbel(key_sel, (k,) + batch_shape, lps.dtype)
        J = jnp.argmax(lps + g, axis=0)  # batch_shape, int

        def take(leaf):
            idx = J.reshape((1,) + batch_shape + (1,) * (leaf.ndim - 1 - bn))
            idx = jnp.broadcast_to(idx, (1,) + leaf.shape[1:])
            return jnp.take_along_axis(leaf, idx, axis=0)[0]

        y = jax.tree_util.tree_map(take, candidates)
        lp_y = take(lps)

        if k == 1:
            # Degenerate MTM ≡ plain MH: reference set is exactly {x}.
            logalpha = lp_y - state.lp
        else:
            # k−1 reference points around the selected candidate; the current
            # state completes the reference set (Liu-Liang-Wong eq. 2).
            refs = propose(key_ref, self.proposal, y, (k - 1,) + batch_shape)
            ref_lps = _lp_leading(model, refs, 1 + bn)  # (k-1,) + batch_shape
            denom = jnp.concatenate([ref_lps, state.lp[None]], axis=0)
            logalpha = logsumexp(lps, axis=0) - logsumexp(denom, axis=0)

        accepted = accept_reject(key_acc, logalpha)

        def sel(c, p):
            mask = accepted.reshape(batch_shape + (1,) * (c.ndim - bn))
            return jnp.where(mask, c, p)

        params = jax.tree_util.tree_map(sel, y, state.params)
        lp = jnp.where(accepted, lp_y, state.lp)
        t = Transition(params, lp, accepted)
        return t, t

    # -- kernel --------------------------------------------------------------

    def step(
        self, key: KeyArray, state: Transition, model
    ) -> Tuple[Transition, Transition]:
        model = as_model(model)
        return self._mtm_core(key, state, model, ())

    def step_batched(
        self, key: KeyArray, state: Transition, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, Transition]:
        """Vectorized over the chain batch: the density sees one
        ``(k · chains)``-sized batch per phase — the device hot path."""
        model = as_model(model)
        return self._mtm_core(key, state, model, batch_shape)
