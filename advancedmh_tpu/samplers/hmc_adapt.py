"""Adaptive HMC: joint step-size + diagonal mass-matrix warmup adaptation
(beyond-parity; no reference analog).

Combines the two warmup adaptations a practical HMC needs:

- **Step size** ε by Nesterov dual averaging toward the 0.65 acceptance
  optimum (Hoffman & Gelman 2014 §3.2 — the same recurrence as
  :class:`~.adapt.StepSizeAdaptation`).
- **Diagonal inverse mass** M⁻¹ from the running Welford variance of the
  chain positions, regularized toward the identity exactly as Stan's
  windowed estimator does (``(n/(n+5))·var + 1e-3·(5/(n+5))``) so early
  noisy estimates cannot destabilize the dynamics.

Unlike Stan's staged expanding windows (which exist because a *single*
chain needs long stretches to estimate variance), the adaptation here is
**continuous**: every warmup step folds the new position into the running
moments and refreshes M⁻¹. With per-chain moments this matches the
windowless continuous-adaptation regime; with ``pooled=True`` all chains
feed ONE shared estimate via the exact Chan–Golub–LeVeque batch-Welford
merge — C positions of cross-chain information per step, the many-chain
design of Hoffman & Sountsov's MEADS (2022) / ChEES-HMC (2021), and the
natural accelerator shape: the chain-axis mean compiles to a ``psum``
across devices under GSPMD sharding (≙ SURVEY §2 "psum … cross-chain adaptation stats").

The cached gradient stays valid across mass updates (∇log π depends only
on position), so refreshing M⁻¹ costs zero extra density evaluations.

Post-warmup both adaptations freeze (≙ RAM's frozen-S main phase,
src/RobustAdaptiveMetropolis.jl:216-237): ε = exp(log ε̄) and the last
regularized M⁻¹ estimate.

Usage::

    spl = AdaptiveHMC(n_leapfrog=10)
    chains = sample(model, spl, 2000, num_warmup=1000, nchains=4096,
                    initial_params=..., pooled=True)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model
from ..utils import KeyArray, pytree_dataclass, replace
from .base import GradientTransition, Sampler
from .hmc import HamiltonianMC


def _tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


@pytree_dataclass
class AdaptiveHMCState:
    """Inner HMC transition + dual-averaging stats + Welford mass moments."""

    inner: GradientTransition
    log_eps: jax.Array  # current log step size (warmup iterate)
    log_eps_bar: jax.Array  # running average — frozen post-warmup
    h_bar: jax.Array  # dual-averaging error sum H̄_t
    t: jax.Array  # warmup iteration counter (int32, starts at 1)
    mean: Any  # Welford running mean of positions (params-shaped pytree)
    m2: Any  # Welford running sum of squared deviations
    n: jax.Array  # Welford observation count (float32)
    inverse_mass: Any  # current regularized diag(M⁻¹) estimate


@dataclasses.dataclass(frozen=True)
class AdaptiveHMC(Sampler):
    """Fixed-trajectory HMC with joint (ε, diag M⁻¹) warmup adaptation.

    ``pooled=True`` shares ONE mass estimate across the whole chain batch
    (cross-chain Welford merge; ~C× faster variance convergence at equal
    step budget). Moments are stored replicated over chains so the state
    layout — checkpoints, chunked resume, sharding — matches per-chain.
    """

    n_leapfrog: int = 10
    target_accept: float = 0.65
    initial_step_size: float = 0.1
    pooled: bool = False
    # Dual-averaging hyperparameters (HG14 §3.2, same defaults as
    # StepSizeAdaptation).
    t0: float = 10.0
    kappa: float = 0.75
    gamma: float = 0.05
    mu: Optional[float] = None
    # Mass regularization (Stan's shrinkage-to-identity pseudocount) and the
    # step count before the estimate is trusted at all.
    mass_regularization: float = 5.0
    mass_warm_start: int = 10

    def __post_init__(self):
        if int(self.n_leapfrog) < 1:
            raise ValueError("n_leapfrog must be >= 1")
        if not 0.0 < self.target_accept < 1.0:
            raise ValueError("target_accept must be in (0, 1)")
        if self.initial_step_size <= 0.0:
            raise ValueError("initial_step_size must be positive")
        if self.gamma <= 0.0:
            raise ValueError("gamma must be positive")
        if self.t0 < 0.0:
            raise ValueError("t0 must be non-negative")
        if not 0.0 < self.kappa <= 1.0:
            raise ValueError("kappa must be in (0, 1]")
        if self.mass_regularization < 0.0:
            raise ValueError("mass_regularization must be non-negative")
        if int(self.mass_warm_start) < 0:
            raise ValueError("mass_warm_start must be non-negative")

    # -- helpers -----------------------------------------------------------

    @property
    def _mu(self) -> float:
        return (
            math.log(10.0 * self.initial_step_size)
            if self.mu is None
            else self.mu
        )

    def _hmc(self, step_size, inverse_mass) -> HamiltonianMC:
        return HamiltonianMC(
            step_size=step_size,
            n_leapfrog=self.n_leapfrog,
            inverse_mass=inverse_mass,
        )

    def transition_of(self, state: AdaptiveHMCState) -> GradientTransition:
        return state.inner

    def _dual_avg(self, state, accepted):
        """One HG14 update; elementwise, so identical for scalar (single
        chain) and (C,)-shaped (batched per-chain) statistics."""
        a = jnp.asarray(accepted, jnp.float32)
        t = state.t.astype(jnp.float32)
        w = 1.0 / (t + self.t0)
        h_bar = (1.0 - w) * state.h_bar + w * (self.target_accept - a)
        log_eps = self._mu - jnp.sqrt(t) / self.gamma * h_bar
        eta = jnp.power(t, -self.kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar
        return log_eps, log_eps_bar, h_bar

    @staticmethod
    def _bcast(count: jax.Array, leaf: jax.Array) -> jax.Array:
        """Broadcast a per-chain count against a leaf's event dims."""
        return count.reshape(count.shape + (1,) * (leaf.ndim - count.ndim))

    def _regularized_inverse_mass(self, mean, m2, n, prev):
        """Stan's shrunk variance estimate; keeps ``prev`` (the identity at
        init) until ``mass_warm_start`` observations have accumulated."""
        r = self.mass_regularization

        def leaf(m2_leaf, prev_leaf):
            nn = self._bcast(jnp.maximum(n, 1.0), m2_leaf)
            var = m2_leaf / jnp.maximum(nn - 1.0, 1.0)
            est = (nn / (nn + r)) * var + 1e-3 * (r / (nn + r))
            use = self._bcast(n >= float(self.mass_warm_start), m2_leaf)
            return jnp.where(use, est, prev_leaf)

        return _tmap(leaf, m2, prev)

    def _welford_update(self, mean, m2, n, x):
        """Per-chain (or single-chain) Welford: one observation per chain."""
        n_new = n + 1.0
        mean_new = _tmap(
            lambda ml, xl: ml + (xl - ml) / self._bcast(n_new, xl), mean, x
        )
        m2_new = _tmap(
            lambda m2l, ml, mnl, xl: m2l + (xl - ml) * (xl - mnl),
            m2, mean, mean_new, x,
        )
        return mean_new, m2_new, n_new

    def _welford_update_pooled(self, mean, m2, n, x, batch_shape):
        """Cross-chain pooled merge (Chan–Golub–LeVeque, diagonal case):

            M2' = M2 + Σ_c (x_c − x̄)² + (nC/(n+C))·δ²,  δ = x̄ − mean.

        All elementwise + one chain-axis mean (→ psum under GSPMD). Moments
        replicated over chains so the state layout matches per-chain.
        """
        bn = len(batch_shape)
        C = float(math.prod(batch_shape))
        axes = tuple(range(bn))
        n0 = n.reshape(-1)[0]
        n_new = n0 + C

        def mean_leaf(mean_l, x_l):
            mean0 = mean_l.reshape((-1,) + mean_l.shape[bn:])[0]
            b_mean = jnp.mean(x_l, axis=axes)
            out = mean0 + (C / n_new) * (b_mean - mean0)
            return jnp.broadcast_to(out, x_l.shape)

        def m2_leaf(m2_l, mean_l, x_l):
            mean0 = mean_l.reshape((-1,) + mean_l.shape[bn:])[0]
            m20 = m2_l.reshape((-1,) + m2_l.shape[bn:])[0]
            b_mean = jnp.mean(x_l, axis=axes)
            centered = x_l - b_mean
            m2_b = jnp.sum(centered * centered, axis=axes)
            delta = b_mean - mean0
            out = m20 + m2_b + (n0 * C / n_new) * delta * delta
            return jnp.broadcast_to(out, x_l.shape)

        mean_out = _tmap(mean_leaf, mean, x)
        m2_out = _tmap(m2_leaf, m2, mean, x)
        return mean_out, m2_out, jnp.broadcast_to(n_new, n.shape)

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[GradientTransition, AdaptiveHMCState]:
        t, inner = self._hmc(self.initial_step_size, None).init(
            key, model, initial_params
        )
        log_eps0 = jnp.log(jnp.asarray(self.initial_step_size, jnp.float32))
        zero = jnp.zeros((), jnp.float32)
        state = AdaptiveHMCState(
            inner=inner,
            log_eps=log_eps0,
            log_eps_bar=log_eps0,
            h_bar=zero,
            t=jnp.ones((), jnp.int32),
            mean=_tmap(lambda x: jnp.asarray(x, jnp.float32), inner.params),
            m2=_tmap(jnp.zeros_like, inner.params),
            n=jnp.zeros((), jnp.float32),
            inverse_mass=_tmap(jnp.ones_like, inner.params),
        )
        return t, state

    def step_warmup(
        self, key: KeyArray, state: AdaptiveHMCState, model
    ) -> Tuple[GradientTransition, AdaptiveHMCState]:
        model = as_model(model)
        spl = self._hmc(jnp.exp(state.log_eps), state.inverse_mass)
        t_out, inner = spl.step(key, state.inner, model)
        log_eps, log_eps_bar, h_bar = self._dual_avg(state, t_out.accepted)
        mean, m2, n = self._welford_update(
            state.mean, state.m2, state.n, inner.params
        )
        inv_mass = self._regularized_inverse_mass(
            mean, m2, n, state.inverse_mass
        )
        return t_out, AdaptiveHMCState(
            inner=inner,
            log_eps=log_eps,
            log_eps_bar=log_eps_bar,
            h_bar=h_bar,
            t=state.t + 1,
            mean=mean,
            m2=m2,
            n=n,
            inverse_mass=inv_mass,
        )

    def step(
        self, key: KeyArray, state: AdaptiveHMCState, model
    ) -> Tuple[GradientTransition, AdaptiveHMCState]:
        """Post-warmup: frozen ε = exp(log ε̄) and frozen M⁻¹."""
        model = as_model(model)
        spl = self._hmc(jnp.exp(state.log_eps_bar), state.inverse_mass)
        t_out, inner = spl.step(key, state.inner, model)
        return t_out, replace(state, inner=inner)

    # -- vectorized kernels ------------------------------------------------

    def _eps_batched(self, log_eps: jax.Array, batch_shape) -> jax.Array:
        """Per-chain step sizes shaped ``batch_shape``; the leapfrog
        broadcasts them against each leaf's event dims (works for scalar,
        vector, and matrix leaves alike)."""
        return jnp.exp(log_eps).reshape(tuple(batch_shape))

    def step_batched(
        self, key: KeyArray, state: AdaptiveHMCState, model, batch_shape
    ) -> Tuple[GradientTransition, AdaptiveHMCState]:
        spl = self._hmc(
            self._eps_batched(state.log_eps_bar, batch_shape),
            state.inverse_mass,
        )
        t_out, inner = spl.step_batched(key, state.inner, model, batch_shape)
        return t_out, replace(state, inner=inner)

    def step_warmup_batched(
        self, key: KeyArray, state: AdaptiveHMCState, model, batch_shape
    ) -> Tuple[GradientTransition, AdaptiveHMCState]:
        spl = self._hmc(
            self._eps_batched(state.log_eps, batch_shape),
            state.inverse_mass,
        )
        t_out, inner = spl.step_batched(key, state.inner, model, batch_shape)
        log_eps, log_eps_bar, h_bar = self._dual_avg(state, t_out.accepted)
        if self.pooled:
            mean, m2, n = self._welford_update_pooled(
                state.mean, state.m2, state.n, inner.params, batch_shape
            )
        else:
            mean, m2, n = self._welford_update(
                state.mean, state.m2, state.n, inner.params
            )
        inv_mass = self._regularized_inverse_mass(
            mean, m2, n, state.inverse_mass
        )
        return t_out, AdaptiveHMCState(
            inner=inner,
            log_eps=log_eps,
            log_eps_bar=log_eps_bar,
            h_bar=h_bar,
            t=state.t + 1,
            mean=mean,
            m2=m2,
            n=n,
            inverse_mass=inv_mass,
        )
