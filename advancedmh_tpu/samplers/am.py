"""Adaptive Metropolis (Haario-Saksman-Tamminen 2001, in the
Roberts-Rosenthal 2009 mixture formulation).

Beyond-parity sampler (no reference equivalent; it complements
:class:`RobustAdaptiveMetropolis` — RAM coerces the *acceptance rate*,
AM learns the full *empirical covariance* of the chain history). Proposal at
iteration n:

    Q_n(x, ·) = (1 − β) · N(x, (2.38²/d) Σ_n)  +  β · N(x, (0.1²/d) I)

where Σ_n is the running empirical covariance of the chain and the fixed
β-component guarantees ergodicity (Roberts & Rosenthal 2009, "Examples of
Adaptive MCMC", §2). For the first ``adapt_start`` iterations (default 2d)
only the fixed component is used, exactly as in RR09.

Batched formulation: Σ_n is never materialized — the state carries its
*Cholesky factor* L_n, advanced exactly by the hand-written rank-1 update
(ops/cholesky.py; the Welford recurrence is symmetric rank-1:
M2_n = M2_{n−1} + ((n−1)/n)·δδᵀ with δ = x_n − μ_{n−1}, hence

    L_n = rank1_update( √((n−1)/n) · L_{n−1},  (√(n−1)/n) · δ )

— always an *update*, never a downdate, so positive-definiteness is
unconditional). Proposing costs one d×d triangular matvec (a batched
matmul over chains), identical to RAM's hot path. Adaptation uses every chain
state (accepted or not) and continues after warmup — the 1/n weighting makes
it diminishing, which is what preserves ergodicity (unlike RAM, whose
finite-step-size adaptation must freeze; src/RobustAdaptiveMetropolis.jl
docstring contract).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model, logdensity, logdensity_batched
from ..ops.cholesky import chol_rank1_update, chol_rank1_update_batched
from ..utils import KeyArray, pytree_dataclass
from .base import Sampler, Transition


@pytree_dataclass
class AdaptiveMetropolisState:
    """Chain state + running moments of the chain history."""

    x: jax.Array  # current realization
    logprob: jax.Array  # log density of x
    mean: jax.Array  # running mean of the chain history
    L: jax.Array  # lower Cholesky factor of the running covariance
    iteration: jax.Array  # number of chain states consumed (int32, ≥ 1)
    isaccept: jax.Array  # whether the previous step was accepted


@dataclasses.dataclass(frozen=True)
class AdaptiveMetropolis(Sampler):
    """AM sampler: ``AdaptiveMetropolis()`` with RR09 defaults.

    ``beta`` is the fixed-component mixture weight; ``fixed_scale`` the fixed
    component's std-dev multiplier (applied as ``fixed_scale/√d``);
    ``opt_scale`` the adapted component's multiplier (2.38 = the
    Roberts-Rosenthal optimal scaling constant, applied as ``opt_scale/√d``
    on the covariance factor); ``adapt_start`` the iteration after which the
    adapted component activates (None → 2d, the RR09 choice).
    """

    beta: float = 0.05
    fixed_scale: float = 0.1
    opt_scale: float = 2.38
    adapt_start: Optional[int] = None
    # pooled=True: all chains feed ONE shared covariance (cross-chain Welford
    # merge) instead of each chain learning its own — C observations per step
    # rather than 1, so Σ converges ~C× faster in wall-clock steps. The
    # chain-axis reductions are plain jnp sums; under GSPMD sharding of the
    # chain axis XLA compiles them to a psum/all-reduce — the SURVEY
    # §2 "cross-chain adaptation stats over collectives" plan. Batched-path
    # (step_batched) only; the single-chain kernel has no chain axis to pool.
    pooled: bool = False

    # -- helpers -------------------------------------------------------------

    def _dim(self, model, initial_params) -> int:
        if initial_params is not None:
            return int(jnp.shape(initial_params)[-1])
        if model.dimension is not None:
            return int(model.dimension)
        raise ValueError(
            "AdaptiveMetropolis needs the model dimension: pass "
            "initial_params or set DensityModel(dimension=...)."
        )

    def _adapt_start(self, d: int) -> int:
        return 2 * d if self.adapt_start is None else int(self.adapt_start)

    def transition_of(self, state: AdaptiveMetropolisState) -> Transition:
        return Transition(state.x, state.logprob, state.isaccept)

    # -- kernel --------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, AdaptiveMetropolisState]:
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = jax.random.normal(key, (d,))
        else:
            x = jnp.asarray(initial_params, dtype=jnp.result_type(float))
        lp = logdensity(model, x)
        # Seed Σ with the fixed component's covariance as one
        # pseudo-observation (≙ Haario's C₀ regularizer): keeps every rank-1
        # step well-conditioned and washes out as 1/n.
        L0 = (self.fixed_scale / math.sqrt(d)) * jnp.eye(d, dtype=x.dtype)
        state = AdaptiveMetropolisState(
            x=x,
            logprob=lp,
            mean=x,
            L=L0,
            iteration=jnp.ones((), jnp.int32),
            isaccept=jnp.ones((), bool),
        )
        return Transition(x, lp, jnp.ones((), bool)), state

    def _increment(self, key, state, d: int):
        """Draw the mixture proposal increment (symmetric by construction)."""
        key_z, key_b = jax.random.split(key)
        z = jax.random.normal(key_z, state.x.shape, state.x.dtype)
        fixed = (self.fixed_scale / math.sqrt(d)) * z
        adapted = (self.opt_scale / math.sqrt(d)) * jnp.einsum(
            "...ij,...j->...i", state.L, z
        )
        # Conditioned on the component choice the increment is exactly the
        # chosen Gaussian (sharing z across components is sound: each branch
        # is a fixed linear map of the same standard normal).
        use_fixed = (
            jax.random.uniform(key_b, state.logprob.shape) < self.beta
        ) | (state.iteration <= self._adapt_start(d))
        return jnp.where(use_fixed[..., None] if use_fixed.ndim else use_fixed,
                         fixed, adapted)

    def _moments_update(self, state, x_new):
        """Advance (mean, L, n) with the new chain state (Welford, exact)."""
        n = state.iteration.astype(state.L.dtype)  # count before x_new
        delta = x_new - state.mean
        # [..., None] broadcasts both the scalar (single-chain) and (C,)
        # (batched) iteration counts against the (..., d) delta.
        mean_new = state.mean + delta * (1.0 / (n + 1.0))[..., None]
        shrink = jnp.sqrt(n / (n + 1.0))
        v = (jnp.sqrt(n) / (n + 1.0))[..., None] * delta
        if state.L.ndim == 2:
            L_new, _ok = chol_rank1_update(
                shrink * state.L, v, jnp.asarray(1.0)
            )
        else:
            L_new, _ok = chol_rank1_update_batched(
                shrink[..., None, None] * state.L, v, jnp.asarray(1.0)
            )
        return mean_new, L_new

    def _moments_update_pooled(self, state, x_new):
        """Cross-chain pooled Welford merge (Chan-Golub-LeVeque parallel
        update): the C new chain states enter one shared (mean, Σ) with the
        exact batch formula

            M2' = M2 + Σ_c (x_c − x̄)(x_c − x̄)ᵀ + (nC/(n+C))·δδᵀ,
            δ = x̄ − mean,

        computed as one (d,C)·(C,d) matmul + a d×d Cholesky (rank-C
        update ⇒ direct refactorization beats C sequential rank-1 sweeps).
        Moments are stored replicated over the chain axis so the state pytree
        matches the per-chain layout (checkpoints, chunked resume, sharding
        annotations all unchanged). Chain 0's moments seed the pool; any
        init-time spread between chains washes out as 1/n.
        """
        d = x_new.shape[-1]
        flat = x_new.reshape(-1, d)
        C = flat.shape[0]
        dt = state.L.dtype
        n = state.iteration.reshape(-1)[0].astype(dt)
        mean0 = state.mean.reshape(-1, d)[0]
        L0 = state.L.reshape(-1, d, d)[0]
        # Precision.HIGHEST on both matmuls: a float32 matmul on the GPU
        # otherwise runs in TF32 (10-bit mantissa), and the L→M2→chol
        # round-trip happens EVERY step — a 2⁻¹¹ relative jitter on the
        # running covariance each iteration
        # (cf. the pooled-RAM adaptation freeze, samplers/ram.py). Both are
        # cheap next to the density eval.
        HIGH = jax.lax.Precision.HIGHEST
        b_mean = jnp.mean(flat, axis=0)
        centered = flat - b_mean
        # chain-axis reduction → psum under GSPMD
        M2_b = jnp.matmul(centered.T, centered, precision=HIGH)
        delta = b_mean - mean0
        n_new = n + C
        mean_new = mean0 + (C / n_new) * delta
        # Σ = M2/n with the C₀ seed as one pseudo-observation (init); the
        # seed keeps M2 strictly PD so the refactorization cannot fail.
        M2 = n * jnp.matmul(L0, L0.T, precision=HIGH)
        M2_new = M2 + M2_b + (n * C / n_new) * jnp.outer(delta, delta)
        L_new = jnp.linalg.cholesky(M2_new / n_new)
        return (
            jnp.broadcast_to(mean_new, x_new.shape),
            jnp.broadcast_to(L_new, x_new.shape[:-1] + (d, d)),
        )

    def _advance_moments(self, state, x_new, batched: bool):
        """(mean, L, iteration) after consuming ``x_new`` — pooled or
        per-chain."""
        if batched and self.pooled:
            mean_new, L_new = self._moments_update_pooled(state, x_new)
            count = int(math.prod(x_new.shape[:-1]))
            return mean_new, L_new, state.iteration + count
        mean_new, L_new = self._moments_update(state, x_new)
        return mean_new, L_new, state.iteration + 1

    def step(
        self, key: KeyArray, state: AdaptiveMetropolisState, model
    ) -> Tuple[Transition, AdaptiveMetropolisState]:
        model = as_model(model)
        key_inc, key_acc = jax.random.split(key)
        d = state.x.shape[-1]
        x_cand = state.x + self._increment(key_inc, state, d)
        lp_cand = logdensity(model, x_cand)
        logalpha = lp_cand - state.logprob  # mixture proposal is symmetric
        isaccept = -jax.random.exponential(key_acc) < logalpha
        x_new = jnp.where(isaccept, x_cand, state.x)
        lp_new = jnp.where(isaccept, lp_cand, state.logprob)
        mean_new, L_new, it_new = self._advance_moments(state, x_new, False)
        state_new = AdaptiveMetropolisState(
            x=x_new,
            logprob=lp_new,
            mean=mean_new,
            L=L_new,
            iteration=it_new,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new

    def step_batched(
        self, key: KeyArray, state: AdaptiveMetropolisState, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, AdaptiveMetropolisState]:
        """Vectorized step: per-chain moments, batched rank-1 sweeps, and the
        triangular matvec as one bmm over the chain batch."""
        model = as_model(model)
        key_inc, key_acc = jax.random.split(key)
        d = state.x.shape[-1]
        x_cand = state.x + self._increment(key_inc, state, d)
        lp_cand = logdensity_batched(model, x_cand)
        logalpha = lp_cand - state.logprob
        isaccept = -jax.random.exponential(key_acc, batch_shape) < logalpha
        x_new = jnp.where(isaccept[..., None], x_cand, state.x)
        lp_new = jnp.where(isaccept, lp_cand, state.logprob)
        mean_new, L_new, it_new = self._advance_moments(state, x_new, True)
        state_new = AdaptiveMetropolisState(
            x=x_new,
            logprob=lp_new,
            mean=mean_new,
            L=L_new,
            iteration=it_new,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new
