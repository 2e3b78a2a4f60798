"""Affine-invariant ensemble sampler (emcee / Goodman-Weare stretch moves).

≙ reference src/emcee.jl. The reference updates walkers *sequentially*, each
against a random mix of already-moved and old walkers (src/emcee.jl:50-55) —
a data dependence that would serialize the walker batch. This implementation uses the
standard **red-black / complementary-ensemble** parallel formulation
(Foreman-Mackey et al. 2013, §3): the ensemble splits into two halves; each
half moves *in parallel* against the frozen other half, then they swap. This
preserves detailed balance and matches the reference's stochastic scheme
statistically (the reference's posterior-moment tests pass), though not
bitwise — SURVEY.md §3.5.

Under ``vmap`` the whole half-move is one fused kernel over the walker batch;
when walkers shard across devices, the complementary half is exchanged with a
single ``all_gather`` (see parallel/emcee.py) — the only
collective in any hot loop of this framework.

Note: the reference evaluates the accepted candidate's log density *twice*
(src/emcee.jl:88,94); SURVEY.md flags this as an inefficiency, not a
semantic requirement — here each candidate costs exactly one evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.density import as_model, logdensity
from ..proposals import as_static_proposal_tree, propose_initial
from ..utils import KeyArray
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class StretchProposal:
    """≙ ``StretchProposal(p, stretch_length=2.0)`` (src/emcee.jl:63-68).

    ``payload`` (a Distribution or list of Distributions) is only used for the
    initial per-walker prior draws; the stretch move itself is parameter-free
    apart from ``stretch_length`` (the Goodman-Weare ``a``).
    """

    payload: Any
    stretch_length: float = 2.0


@dataclasses.dataclass(frozen=True)
class WalkProposal:
    """Goodman-Weare 2010 *walk move* (beyond-parity; the reference has only
    the stretch move — this is emcee's ``WalkMove`` companion).

    Each walker proposes x' = x + scale·W with W = (1/√H)·Σ_j z_j(x_j − x̄)
    summed over the whole frozen complementary half (z_j iid N(0,1)), i.e. a
    Gaussian whose covariance is the (biased) sample covariance of the frozen
    half times ``scale``² — affine-invariant and self-tuning like the stretch
    move, but with a full-covariance Gaussian shape. Symmetric given the
    frozen half, so acceptance is plain Δlp (no Jacobian term).

    ``payload`` seeds the initial per-walker prior draws, as in
    StretchProposal.
    """

    payload: Any
    scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class Ensemble(Sampler):
    """≙ ``Ensemble(n_walkers, proposal)`` (src/emcee.jl:1-4). ``proposal``
    is a :class:`StretchProposal` or :class:`WalkProposal`."""

    n_walkers: int
    proposal: Any

    is_population = True

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _dim_of(params) -> int:
        """Per-walker parameter dimension (walker axis excluded) — the ``n``
        in the stretch-move Jacobian ``(n-1)·log z`` (src/emcee.jl:82-83)."""
        leaves = jax.tree_util.tree_leaves(params)
        return int(sum(int(np.prod(l.shape[1:])) for l in leaves))

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """≙ initial proposal (src/emcee.jl:29-34): each walker drawn from the
        payload as a static prior draw. ``initial_params`` (with a leading
        walker axis) overrides the draws."""
        model = as_model(model)
        if initial_params is None:
            keys = jax.random.split(key, self.n_walkers)
            static = as_static_proposal_tree(self.proposal.payload)
            params = jax.vmap(lambda k: propose_initial(k, static))(keys)
        else:
            params = initial_params
            got = jax.tree_util.tree_leaves(params)[0].shape[0]
            if got != self.n_walkers:
                raise ValueError(
                    f"initial_params carries {got} walkers but the Ensemble "
                    f"was built with n_walkers={self.n_walkers}"
                )
        lp = jax.vmap(lambda p: logdensity(model, p))(params)
        t = Transition(params, lp, jnp.zeros((self.n_walkers,), bool))
        return t, t

    def _half_move(self, key, active_params, active_lp, other_params, other_lp, model):
        """Parallel move of one half against the frozen other half
        (stretch ≙ ``move``, src/emcee.jl:70-102, vectorized over the half;
        walk = GW10 walk move, one (H_a × H_o) einsum per leaf)."""
        n_active = jax.tree_util.tree_leaves(active_lp)[0].shape[0]
        n_other = jax.tree_util.tree_leaves(other_lp)[0].shape[0]

        if isinstance(self.proposal, WalkProposal):
            key_z, key_acc = jax.random.split(key)
            # One z_j per (active walker, frozen walker), SHARED across
            # leaves/dims — the walk direction couples the whole tree.
            z = jax.random.normal(key_z, (n_active, n_other))
            coef = self.proposal.scale / jnp.sqrt(float(n_other))

            def walk(xi, xo):
                c = xo - jnp.mean(xo, axis=0, keepdims=True)  # centered
                w = jnp.einsum(
                    "ao,o...->a...", z, c.reshape(n_other, -1)
                ).reshape(xi.shape)
                return xi + coef * w

            y = jax.tree_util.tree_map(walk, active_params, other_params)
            lp_y = jax.vmap(lambda p: logdensity(model, p))(y)
            logalpha = lp_y - active_lp  # symmetric given the frozen half
            accepted = -jax.random.exponential(key_acc, (n_active,)) <= logalpha
            new_params = jax.tree_util.tree_map(
                lambda yy, pp: jnp.where(
                    accepted.reshape((n_active,) + (1,) * (yy.ndim - 1)),
                    yy, pp,
                ),
                y,
                active_params,
            )
            return new_params, jnp.where(accepted, lp_y, active_lp), accepted

        a = self.proposal.stretch_length
        ndim = self._dim_of(active_params)

        key_j, key_z, key_acc = jax.random.split(key, 3)
        # Random partner from the complementary half.
        j = jax.random.randint(key_j, (n_active,), 0, n_other)
        partner = jax.tree_util.tree_map(lambda p: p[j], other_params)

        # z = ((a-1)u + 1)² / a (src/emcee.jl:84)
        u = jax.random.uniform(key_z, (n_active,))
        z = jnp.square((a - 1.0) * u + 1.0) / a

        def stretch(op, wp):
            zb = z.reshape((n_active,) + (1,) * (wp.ndim - 1))
            return op + zb * (wp - op)

        y = jax.tree_util.tree_map(stretch, partner, active_params)
        lp_y = jax.vmap(lambda p: logdensity(model, p))(y)

        # logα = (n-1)·log z + lp(y) − lp(walker); accept iff −randexp ≤ logα
        # (src/emcee.jl:85-93; note ≤, unlike mh-core's <).
        logalpha = (ndim - 1) * jnp.log(z) + lp_y - active_lp
        accepted = -jax.random.exponential(key_acc, (n_active,)) <= logalpha

        new_params = jax.tree_util.tree_map(
            lambda yy, pp: jnp.where(
                accepted.reshape((n_active,) + (1,) * (yy.ndim - 1)), yy, pp
            ),
            y,
            active_params,
        )
        new_lp = jnp.where(accepted, lp_y, active_lp)
        return new_params, new_lp, accepted

    def step(self, key: KeyArray, state: Transition, model) -> Tuple[Transition, Transition]:
        """One full ensemble update = two complementary half-moves."""
        model = as_model(model)
        h = self.n_walkers // 2
        key_a, key_b = jax.random.split(key)

        take = lambda tree, sl: jax.tree_util.tree_map(lambda x: x[sl], tree)
        pA, lpA = take(state.params, slice(0, h)), state.lp[:h]
        pB, lpB = take(state.params, slice(h, None)), state.lp[h:]

        pA, lpA, accA = self._half_move(key_a, pA, lpA, pB, lpB, model)
        pB, lpB, accB = self._half_move(key_b, pB, lpB, pA, lpA, model)

        params = jax.tree_util.tree_map(
            lambda x, y: jnp.concatenate([x, y], axis=0), pA, pB
        )
        lp = jnp.concatenate([lpA, lpB])
        accepted = jnp.concatenate([accA, accB])
        t = Transition(params, lp, accepted)
        return t, t
