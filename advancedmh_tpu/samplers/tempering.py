"""Replica-exchange (parallel tempering) meta-sampler.

Beyond-parity feature (not in the reference — its sampler zoo is
single-temperature): K tempered replicas of any inner sampler run per
chain, targeting ``β_k · logdensity`` with ``β_0 = 1`` the cold chain, and
adjacent-temperature swaps are proposed after every inner step with the
standard exchange acceptance ``logα = (β_i − β_j)(ℓ_j − ℓ_i)`` on the raw
log densities ℓ.

Batched shape: the K replicas are a *leading array axis* of one chain's
state — the inner sampler steps under ``vmap`` over (replica, β), and the
even-odd swap sweep is two vectorized half-exchanges (the same red-black
pattern as the emcee ensemble, samplers/emcee.py). The runtime then vmaps
whole replica stacks over chains: 10k chains × K temperatures run as one
(K·C)-wide SIMD batch with zero collectives. Composes with everything the
Sampler protocol grants: schedules, bundling, checkpoint/resume, meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import DensityModel, as_model
from ..utils import KeyArray, pytree_dataclass, replace as _replace
from .base import Sampler, Transition


@pytree_dataclass
class ReplicaExchangeState:
    """Stacked inner states (leading axis K = len(betas)) + swap statistics."""

    inner: Any  # inner-sampler state pytree, each leaf (K, ...)
    swap_accept_count: jax.Array  # (K-1,) accepted adjacent swaps
    swap_proposal_count: jax.Array  # (K-1,)


@dataclasses.dataclass(frozen=True)
class ReplicaExchange(Sampler):
    """Parallel tempering around any inner :class:`Sampler`.

    ``betas`` are inverse temperatures, descending, with ``betas[0] == 1.0``
    (the cold replica whose draws are emitted). The inner sampler must carry
    its log density in ``state.lp`` (Transition-shaped states — MH/MALA
    families); RAM's bespoke state is not supported.
    """

    sampler: Sampler
    betas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.1)
    replica_scales: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if len(self.betas) < 2:
            raise ValueError("ReplicaExchange needs at least 2 temperatures")
        if abs(self.betas[0] - 1.0) > 1e-12:
            raise ValueError("betas[0] must be 1.0 (the cold chain)")
        if any(b2 >= b1 for b1, b2 in zip(self.betas, self.betas[1:])):
            raise ValueError("betas must be strictly descending")
        if any(b <= 0 for b in self.betas):
            raise ValueError("betas must be positive")
        if self.replica_scales is not None:
            rs = tuple(float(c) for c in self.replica_scales)
            if len(rs) != len(self.betas):
                raise ValueError(
                    "replica_scales must match betas "
                    f"({len(rs)} vs {len(self.betas)})"
                )
            if any(c <= 0 for c in rs):
                raise ValueError("replica_scales must be positive")
            object.__setattr__(self, "replica_scales", rs)
            self._scaled_inner(1.0)  # validate the inner sampler eagerly

    @staticmethod
    def geometric_scales(betas) -> Tuple[float, ...]:
        """The standard β^{-1/2} step-size ladder: a replica tempered to β
        targets a distribution whose scale grows like β^{-1/2} (exactly so
        for Gaussians), so hotter replicas should take proportionally larger
        steps to hold their acceptance rate."""
        return tuple(float(b) ** -0.5 for b in betas)

    # -- helpers -------------------------------------------------------------

    def _betas(self):
        return jnp.asarray(self.betas, jnp.float32)

    def _scaled_inner(self, c: float) -> Sampler:
        """The inner sampler with its random-walk scale multiplied by ``c``
        (requires a Gaussian-RW ``MetropolisHastings`` inner — the only
        family where 'scale' has one unambiguous meaning)."""
        from ..distributions import MvNormal as _MvN, Normal as _N
        from ..proposals import RandomWalkProposal
        from .mh import MetropolisHastings

        spl = self.sampler
        p = getattr(spl, "proposal", None)
        payload = getattr(p, "payload", None)
        if not (
            isinstance(spl, MetropolisHastings)
            and isinstance(p, RandomWalkProposal)
            and isinstance(payload, (_N, _MvN))
        ):
            raise ValueError(
                "replica_scales requires a Gaussian random-walk "
                "MetropolisHastings inner sampler"
            )
        if isinstance(payload, _N):
            newp = _N(payload.loc, payload.scale * c)
        elif payload.scale_tril is not None:
            newp = _MvN(payload.loc, scale_tril=payload.scale_tril * c)
        elif payload.scale_diag is not None:
            newp = _MvN(payload.loc, scale_diag=payload.scale_diag * c)
        else:
            newp = _MvN(payload.loc, scale=payload.scale * c)
        return dataclasses.replace(
            spl, proposal=dataclasses.replace(p, payload=newp)
        )

    def _tempered_step(self, model):
        base_ld = as_model(model).logdensity_fn

        def step_one(key, state, beta):
            tm = DensityModel(lambda x: beta * base_ld(x))
            _, s = self.sampler.step(key, state, tm)
            return s

        return step_one

    def _inner_steps(self, model, keys, inner, betas):
        """One tempered step of every replica: a single vmap when all
        replicas share the inner sampler, or a statically-unrolled loop of
        per-replica scaled samplers when ``replica_scales`` is set."""
        if self.replica_scales is None:
            return jax.vmap(self._tempered_step(model))(keys, inner, betas)
        base_ld = as_model(model).logdensity_fn
        K = len(self.betas)
        outs = []
        for k in range(K):
            beta = float(self.betas[k])
            tm = DensityModel(lambda x, b=beta: b * base_ld(x))
            spl_k = self._scaled_inner(self.replica_scales[k])
            st_k = jax.tree_util.tree_map(lambda x: x[k], inner)
            _, s = spl_k.step(keys[k], st_k, tm)
            outs.append(s)
        return jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *outs
        )

    # -- kernel ----------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, ReplicaExchangeState]:
        model = as_model(model)
        base_ld = model.logdensity_fn
        K = len(self.betas)
        keys = jax.random.split(key, K)
        betas = self._betas()

        def init_one(k, beta):
            tm = DensityModel(lambda x: beta * base_ld(x))
            _, s = self.sampler.init(k, tm, initial_params)
            return s

        inner = jax.vmap(init_one)(keys, betas)
        zero = jnp.zeros((K - 1,), jnp.float32)
        state = ReplicaExchangeState(inner, zero, zero)
        return self.transition_of(state), state

    def transition_of(self, state: ReplicaExchangeState):
        """Emit the cold (β=1) replica's transition."""
        return jax.tree_util.tree_map(lambda x: x[0], state.inner)

    def step(
        self, key: KeyArray, state: ReplicaExchangeState, model
    ) -> Tuple[Transition, ReplicaExchangeState]:
        model = as_model(model)
        K = len(self.betas)
        betas = self._betas()
        key_step, key_swap = jax.random.split(key)

        # 1. independent tempered inner steps (vmap over the replica axis,
        # or per-replica scaled samplers when replica_scales is set)
        inner = self._inner_steps(
            model, jax.random.split(key_step, K), state.inner, betas
        )

        # 2. even-odd adjacent swap sweep. Raw log density ℓ = lp / β (the
        # inner state's lp is w.r.t. the tempered target β·ℓ).
        def sweep(carry, parity_key):
            inner, acc, prop = carry
            parity, k_u = parity_key
            lps = inner.lp  # (K,)
            ell = lps / betas
            # candidate pair (k, k+1) for k ≡ parity (mod 2)
            ks = jnp.arange(K - 1)
            active = (ks % 2) == parity
            logalpha = (betas[:-1] - betas[1:]) * (ell[1:] - ell[:-1])
            u = jax.random.uniform(k_u, (K - 1,))
            do_swap = active & (jnp.log(u) < logalpha)  # (K-1,)

            # Build a permutation: swap k ↔ k+1 where accepted. Even-odd
            # parity guarantees accepted swaps are disjoint.
            idx = jnp.arange(K)
            down = jnp.concatenate([do_swap, jnp.zeros((1,), bool)])  # at k: take k+1
            up = jnp.concatenate([jnp.zeros((1,), bool), do_swap])  # at k+1: take k
            perm = jnp.where(down, idx + 1, jnp.where(up, idx - 1, idx))

            # Exchange *parameters* (and any cached gradient) — lp must be
            # re-tempered to the receiving replica's β: lp_new = β_k · ℓ_perm.
            def take(x):
                return x[perm] if x.ndim >= 1 and x.shape[0] == K else x

            swapped = jax.tree_util.tree_map(take, inner)
            new_lp = betas * ell[perm]
            swapped = _replace(swapped, lp=new_lp)
            if hasattr(swapped, "gradient"):
                # cached gradient is ∇(β·ℓ) = β·∇ℓ: re-temper to the
                # receiving replica's β so MALA drifts stay correct
                scale = betas / betas[perm]
                swapped = _replace(
                    swapped,
                    gradient=jax.tree_util.tree_map(
                        lambda g: g
                        * scale.reshape((K,) + (1,) * (g.ndim - 1)),
                        swapped.gradient,
                    ),
                )
            acc = acc + do_swap.astype(jnp.float32)
            prop = prop + active.astype(jnp.float32)
            return (swapped, acc, prop), None

        k0, k1 = jax.random.split(key_swap)
        (inner, acc, prop), _ = jax.lax.scan(
            sweep,
            (inner, state.swap_accept_count, state.swap_proposal_count),
            (jnp.asarray([0, 1]), jnp.stack([k0, k1])),
        )
        new_state = ReplicaExchangeState(inner, acc, prop)
        return self.transition_of(new_state), new_state


def swap_rates(state: ReplicaExchangeState) -> jax.Array:
    """Observed adjacent-swap acceptance rates, shape (K-1,) (batched states
    return (..., K-1)) — tune ``betas`` toward ~0.2-0.4 per pair."""
    return state.swap_accept_count / jnp.maximum(state.swap_proposal_count, 1.0)


def tune_betas(betas, rates, target: float = 0.3, step: float = 1.0):
    """One stochastic-approximation update of the temperature ladder from
    observed adjacent-swap rates (Miasojedow-Moulines-Vihola 2013 style).

    The ladder is parameterized by positive log-spacings
    ``ρ_k = log β_k − log β_{k+1}``; a pair swapping *above* ``target`` is
    too close (wasted replicas) so its spacing grows, below-target pairs
    shrink: ``ρ_k ← ρ_k · exp(step · (rate_k − target))``. β₀ stays 1.
    Pass the per-chain-averaged :func:`swap_rates`; iterate between chunks
    (e.g. ``sample_chunked`` callbacks) until rates flatten near ``target``.
    Returns a plain tuple usable as ``ReplicaExchange(..., betas=...)``.
    """
    import numpy as _np

    b = _np.asarray(betas, _np.float64)
    r = _np.asarray(rates, _np.float64).reshape(-1)
    if r.shape != (len(b) - 1,):
        raise ValueError(
            f"rates must have shape ({len(b) - 1},), got {r.shape}"
        )
    rho = _np.diff(-_np.log(b))  # positive spacings, length K-1
    rho = rho * _np.exp(step * (r - target))
    new = _np.exp(-_np.concatenate([[0.0], _np.cumsum(rho)]))
    return tuple(float(x) for x in new)
