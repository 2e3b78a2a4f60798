"""Robust Adaptive Metropolis (Vihola 2012).

≙ reference src/RobustAdaptiveMetropolis.jl. Proposal ``x' = x + S·U`` with
``U ~ N(0, I)``; during warmup the lower-triangular factor ``S`` adapts by a
rank-1 Cholesky update/downdate sized to coerce the acceptance rate to ``α``
(default 0.234), with an eigenvalue clamp keeping the previous ``S`` when the
adapted factor leaves the configured bounds.

Batched mapping: the d×d triangular matvec ``S·U`` batches over chains into
one matmul under ``vmap``; the rank-1 sweep is the hand-written kernel in
ops/cholesky.py. This is the only sampler with a warmup/main phase split
(``step_warmup`` vs ``step``) and the only one whose state carries more than
(params, lp).
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
class RobustAdaptiveMetropolisState:
    """≙ ``RobustAdaptiveMetropolisState`` (src/RobustAdaptiveMetropolis.jl:99-114)."""

    x: jax.Array  # current realization of the chain
    logprob: jax.Array  # log density of x
    S: jax.Array  # current lower-triangular Cholesky factor
    logalpha: jax.Array  # log acceptance ratio of the previous iteration
    eta: jax.Array  # current adaptation step size
    iteration: jax.Array  # current iteration (int32)
    isaccept: jax.Array  # whether the previous iteration was accepted


@dataclasses.dataclass(frozen=True)
class RobustAdaptiveMetropolis(Sampler):
    """≙ ``RobustAdaptiveMetropolis`` kwdef sampler (src/RobustAdaptiveMetropolis.jl:75-87)."""

    alpha: float = 0.234  # target acceptance rate
    gamma: float = 0.6  # negative exponent of the adaptation decay
    S: Optional[Any] = None  # initial Cholesky factor (None → identity)
    eigenvalue_lower_bound: float = 0.0
    eigenvalue_upper_bound: float = math.inf
    # pooled=True: one shared S adapted by ALL chains each warmup step (the
    # natural multi-chain generalization of Vihola's update — the per-chain
    # rank-1 corrections average into one rank-C correction, applied as
    # S' = S·chol(I + η·mean_c Δα_c·û_c û_cᵀ)). The chain-axis mean is a
    # plain reduction; under GSPMD sharding it compiles to a psum
    # (SURVEY §2 "psum for RAM cross-chain adaptation stats"). Batched path
    # only; C chains contribute per step so S converges ~C× faster.
    pooled: bool = False

    # -- helpers -----------------------------------------------------------

    def _dim(self, model, initial_params) -> int:
        if initial_params is not None:
            return int(jnp.shape(initial_params)[-1])
        if model.dimension is not None:
            return int(model.dimension)
        raise ValueError(
            "RobustAdaptiveMetropolis needs the model dimension: pass "
            "initial_params or set DensityModel(dimension=...)."
        )

    def transition_of(self, state: RobustAdaptiveMetropolisState) -> Transition:
        return Transition(state.x, state.logprob, state.isaccept)

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, RobustAdaptiveMetropolisState]:
        """≙ step-init (src/RobustAdaptiveMetropolis.jl:175-214)."""
        model = as_model(model)
        d = self._dim(model, initial_params)
        if initial_params is None:
            x = jax.random.normal(key, (d,))
        else:
            x = jnp.asarray(initial_params, dtype=jnp.result_type(float))
        if self.S is None:
            S = jnp.eye(d, dtype=x.dtype)
        else:
            S = jnp.asarray(self.S, dtype=x.dtype)
            if S.shape != (d, d):
                raise ValueError("The provided `S` has the wrong dimensionality.")
            S = jnp.tril(S)
        lp = logdensity(model, x)
        zero = jnp.zeros((), x.dtype)
        state = RobustAdaptiveMetropolisState(
            x=x,
            logprob=lp,
            S=S,
            logalpha=zero,
            eta=zero,
            iteration=jnp.ones((), jnp.int32),
            isaccept=jnp.ones((), bool),
        )
        return Transition(x, lp, jnp.ones((), bool)), state

    def _step_inner(self, key: KeyArray, state, model):
        """≙ ``ram_step_inner`` (src/RobustAdaptiveMetropolis.jl:123-151)."""
        key_u, key_acc = jax.random.split(key)
        x = state.x
        U = jax.random.normal(key_u, x.shape, x.dtype)
        # muladd(S, U, x): batches to a matmul over the chain axis.
        x_new = state.S @ U + x
        lp_new = logdensity(model, x_new)
        # min(..., 0) so logα is a true log acceptance probability — ram_adapt
        # relies on it and users monitor mean(exp(logα)) (reference comment at
        # src/RobustAdaptiveMetropolis.jl:141-147).
        logalpha = jnp.minimum(lp_new - state.logprob, 0.0)
        isaccept = jax.random.exponential(key_acc) > -logalpha
        return x_new, lp_new, U, logalpha, isaccept

    def _adapt(self, state, logalpha, U):
        """≙ ``ram_adapt`` (src/RobustAdaptiveMetropolis.jl:153-173)."""
        dalpha = jnp.exp(logalpha) - self.alpha
        S = state.S
        eta = jnp.power(state.iteration.astype(S.dtype), -self.gamma)
        dS = (
            jnp.sqrt(eta * jnp.abs(dalpha))
            * (S @ U)
            / jnp.linalg.norm(U)
        )
        S_new, ok = chol_rank1_update(S, dS, jnp.sign(dalpha))
        return S_new, eta, ok

    def _valid_eigenvalues(self, S) -> jax.Array:
        """≙ ``valid_eigenvalues`` (src/RobustAdaptiveMetropolis.jl:239-245).

        For a triangular factor the eigenvalues are the diagonal; the default
        (0, ∞) bounds short-circuit *statically* (no runtime check compiled).
        """
        if self.eigenvalue_lower_bound == 0.0 and math.isinf(
            self.eigenvalue_upper_bound
        ):
            return jnp.asarray(True)
        diag = jnp.diagonal(S)
        return jnp.all(
            (diag >= self.eigenvalue_lower_bound)
            & (diag <= self.eigenvalue_upper_bound)
        )

    def step(
        self, key: KeyArray, state: RobustAdaptiveMetropolisState, model
    ) -> Tuple[Transition, RobustAdaptiveMetropolisState]:
        """Post-warmup step: S frozen (≙ src/RobustAdaptiveMetropolis.jl:216-237)."""
        model = as_model(model)
        x_new, lp_new, _U, logalpha, isaccept = self._step_inner(key, state, model)
        state_new = RobustAdaptiveMetropolisState(
            x=jnp.where(isaccept, x_new, state.x),
            logprob=jnp.where(isaccept, lp_new, state.logprob),
            S=state.S,
            logalpha=logalpha,
            eta=state.eta,
            iteration=state.iteration + 1,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new

    def step_warmup(
        self, key: KeyArray, state: RobustAdaptiveMetropolisState, model
    ) -> Tuple[Transition, RobustAdaptiveMetropolisState]:
        """Warmup step with adaptation (≙ src/RobustAdaptiveMetropolis.jl:247-278)."""
        model = as_model(model)
        x_new, lp_new, U, logalpha, isaccept = self._step_inner(key, state, model)
        S_new, eta, ok = self._adapt(state, logalpha, U)
        # Keep the old S when the adapted factor has out-of-bounds eigenvalues
        # (p. 13 in Vihola 2012) or the downdate lost positive-definiteness.
        valid = ok & self._valid_eigenvalues(S_new)
        S_final = jnp.where(valid, S_new, state.S)
        state_new = RobustAdaptiveMetropolisState(
            x=jnp.where(isaccept, x_new, state.x),
            logprob=jnp.where(isaccept, lp_new, state.logprob),
            S=S_final,
            logalpha=logalpha,
            eta=eta,
            iteration=state.iteration + 1,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new

    # -- vectorized kernels (chain-batched state, batched RNG) -------------

    def _step_inner_batched(self, key, state, model, batch_shape):
        key_u, key_acc = jax.random.split(key)
        x = state.x  # (C, d)
        U = jax.random.normal(key_u, x.shape, x.dtype)
        # Batched triangular matvec — one bmm over the chains.
        x_new = jnp.einsum("...ij,...j->...i", state.S, U) + x
        lp_new = logdensity_batched(model, x_new)
        logalpha = jnp.minimum(lp_new - state.logprob, 0.0)
        isaccept = jax.random.exponential(key_acc, batch_shape) > -logalpha
        return x_new, lp_new, U, logalpha, isaccept

    def step_batched(
        self, key: KeyArray, state: RobustAdaptiveMetropolisState, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, RobustAdaptiveMetropolisState]:
        model = as_model(model)
        x_new, lp_new, _U, logalpha, isaccept = self._step_inner_batched(
            key, state, model, batch_shape
        )
        acc = isaccept[..., None]
        state_new = RobustAdaptiveMetropolisState(
            x=jnp.where(acc, x_new, state.x),
            logprob=jnp.where(isaccept, lp_new, state.logprob),
            S=state.S,
            logalpha=logalpha,
            eta=state.eta,
            iteration=state.iteration + 1,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new

    def _adapt_pooled(self, state, logalpha, U):
        """Rank-C pooled Vihola update: S'S'ᵀ = S(I + η·W)Sᵀ with
        W = mean_c Δα_c û_c û_cᵀ, û = U/‖U‖. ‖W‖₂ ≤ max(α, 1−α) < 1 and
        η ≤ 1, so I + η·W is always PD and the d×d refactorization cannot
        fail; S' = S·chol(I+ηW) stays lower-triangular. One (d,C)·(C,d)
        matmul + one d×d Cholesky per step, shared across all chains.

        Both matmuls run at ``Precision.HIGHEST``: at the default precision
        a float32 matmul on the GPU runs in TF32 (10-bit mantissa), and
        chol(I + ηW) lies within TF32's spacing of I once η·‖W‖ falls below
        ~1e-3 (η = t^−0.6 shrinks every step) — the truncated factor rounds
        to exactly I and adaptation silently FREEZES mid-warmup. The
        matmuls are (d,C)·(C,d) and d×d — small next to the density
        eval."""
        HIGH = jax.lax.Precision.HIGHEST
        d = U.shape[-1]
        Uf = U.reshape(-1, d)
        la = logalpha.reshape(-1)
        C = Uf.shape[0]
        S0 = state.S.reshape(-1, d, d)[0]
        dt = S0.dtype
        eta = jnp.power(state.iteration.reshape(-1)[0].astype(dt), -self.gamma)
        dalpha = jnp.exp(la) - self.alpha  # (C,)
        u = Uf / jnp.linalg.norm(Uf, axis=-1, keepdims=True)
        # chain reduction → psum on mesh
        W = jnp.matmul((u * dalpha[:, None]).T, u, precision=HIGH) / C
        M = jnp.eye(d, dtype=dt) + eta * W
        S_new = jnp.matmul(S0, jnp.linalg.cholesky(M), precision=HIGH)
        valid = self._valid_eigenvalues(S_new)
        S_final = jnp.where(valid, S_new, S0)
        batch = state.S.shape[:-2]
        return jnp.broadcast_to(S_final, batch + (d, d)), eta

    def step_warmup_batched(
        self, key: KeyArray, state: RobustAdaptiveMetropolisState, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, RobustAdaptiveMetropolisState]:
        model = as_model(model)
        x_new, lp_new, U, logalpha, isaccept = self._step_inner_batched(
            key, state, model, batch_shape
        )
        if self.pooled:
            S_final, eta = self._adapt_pooled(state, logalpha, U)
            acc = isaccept[..., None]
            state_new = RobustAdaptiveMetropolisState(
                x=jnp.where(acc, x_new, state.x),
                logprob=jnp.where(isaccept, lp_new, state.logprob),
                S=S_final,
                logalpha=logalpha,
                eta=jnp.broadcast_to(eta, batch_shape),
                iteration=state.iteration + 1,
                isaccept=isaccept,
            )
            return self.transition_of(state_new), state_new
        # Per-chain adaptation (each chain adapts its own S).
        dalpha = jnp.exp(logalpha) - self.alpha  # (C,)
        S = state.S
        eta = jnp.power(state.iteration.astype(S.dtype), -self.gamma)
        scale = jnp.sqrt(eta * jnp.abs(dalpha)) / jnp.linalg.norm(U, axis=-1)
        dS = scale[..., None] * jnp.einsum("...ij,...j->...i", S, U)
        S_new, ok = chol_rank1_update_batched(S, dS, jnp.sign(dalpha))
        valid = ok & self._valid_eigenvalues_batched(S_new)
        S_final = jnp.where(valid[..., None, None], S_new, S)
        acc = isaccept[..., None]
        state_new = RobustAdaptiveMetropolisState(
            x=jnp.where(acc, x_new, state.x),
            logprob=jnp.where(isaccept, lp_new, state.logprob),
            S=S_final,
            logalpha=logalpha,
            eta=eta,
            iteration=state.iteration + 1,
            isaccept=isaccept,
        )
        return self.transition_of(state_new), state_new

    def _valid_eigenvalues_batched(self, S) -> jax.Array:
        if self.eigenvalue_lower_bound == 0.0 and math.isinf(
            self.eigenvalue_upper_bound
        ):
            return jnp.ones(S.shape[:-2], dtype=bool)
        diag = jnp.diagonal(S, axis1=-2, axis2=-1)
        return jnp.all(
            (diag >= self.eigenvalue_lower_bound)
            & (diag <= self.eigenvalue_upper_bound),
            axis=-1,
        )
