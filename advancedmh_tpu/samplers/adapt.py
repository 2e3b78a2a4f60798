"""Dual-averaging step-size adaptation (beyond-parity; no reference analog).

Wraps any *step-size-indexed family* of MH-type samplers and tunes the step
size toward a target acceptance rate during warmup using Nesterov dual
averaging (Hoffman & Gelman 2014, §3.2; the stochastic-approximation view is
Andrieu & Thoms 2008, Algorithm 4). The reference leaves step-size choice
entirely to the user (e.g. the fixed ``σ²`` in its MALA README usage,
src/MALA.jl:1-11); RAM (src/RobustAdaptiveMetropolis.jl) adapts a full
covariance factor but not a family-generic scalar scale.

Batched shape: the adaptation statistics (``log ε``, its running average, the
dual-averaging error sum) live in the *state pytree*, so the wrapper works
unchanged under ``vmap`` over chains (each chain adapts its own step size),
``lax.scan`` over steps, and ``shard_map`` over the mesh — the sampler object
itself stays a static frozen dataclass closed over by the kernel.

The acceptance signal is the accept *indicator* from the inner transition
(``E[1_accept] = α``, so the Robbins-Monro fixed point is identical to using
the acceptance probability; the extra variance is absorbed by the 1/t
averaging).

Usage::

    spl = StepSizeAdaptation(
        lambda eps: RWMH(MvNormal(jnp.zeros(2), scale=eps)),
        target_accept=0.234,
    )
    chains = sample(model, spl, 2000, num_warmup=1000, ...)

or via the conveniences ``StepSizeAdaptation.rwmh(d)``,
``StepSizeAdaptation.mala()``, ``StepSizeAdaptation.barker()`` with the
Roberts-Rosenthal / Livingstone-Zanella optimal targets baked in.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils import KeyArray, pytree_dataclass, replace
from .base import Sampler


# Finite-dimension optimal RWMH acceptance rates for product-form targets
# (Gelman, Roberts & Gilks 1996, "Efficient Metropolis jumping rules",
# Table 1 simulation optima); 0.234 is the d→∞ diffusion limit of
# Roberts, Gelman & Gilks 1997 — the reference's RAM default lineage
# (≙ src/RobustAdaptiveMetropolis.jl:77).
_GRG_OPTIMAL_ACCEPT = {
    1: 0.441, 2: 0.352, 3: 0.316, 4: 0.285, 5: 0.275,
    6: 0.273, 7: 0.270, 8: 0.267, 9: 0.262, 10: 0.261,
}


def optimal_rwmh_accept(d: int) -> float:
    """Dimension-aware optimal RWMH acceptance target (GRG96 for d ≤ 10,
    the 0.234 asymptote beyond)."""
    return _GRG_OPTIMAL_ACCEPT.get(int(d), 0.234)


@pytree_dataclass
class StepSizeAdaptationState:
    """Inner sampler state + Nesterov dual-averaging statistics."""

    inner: Any  # wrapped sampler's state pytree
    log_eps: jax.Array  # current log step size (warmup iterate)
    log_eps_bar: jax.Array  # running average — the frozen post-warmup value
    h_bar: jax.Array  # dual-averaging error sum H̄_t
    t: jax.Array  # warmup iteration counter (int32, starts at 1)


@dataclasses.dataclass(frozen=True)
class StepSizeAdaptation(Sampler):
    """Tune ``make_sampler(eps)``'s step size to ``target_accept`` in warmup.

    ``make_sampler`` must be a pure function from a (possibly traced) positive
    scalar to a sampler whose transitions carry an ``accepted`` flag (every
    MH-type sampler here: RWMH/MALA/Barker/pCN/...). During warmup steps the
    current ``exp(log ε)`` is used and adapted; after warmup the averaged
    ``exp(log ε̄)`` is frozen in (the HG14 contract).
    """

    make_sampler: Callable[[jax.Array], Sampler]
    target_accept: float = 0.234
    initial_step_size: float = 1.0
    t0: float = 10.0  # adaptation offset (HG14: stabilizes early iterations)
    kappa: float = 0.75  # averaging decay exponent
    gamma: float = 0.05  # shrinkage toward mu
    mu: Optional[float] = None  # shrinkage point; None → log(10·ε₀) (HG14)

    def __post_init__(self):
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

    # -- helpers -----------------------------------------------------------

    @property
    def _template(self) -> Sampler:
        """A concrete-ε instance for ε-independent protocol queries
        (transition_of, is_population)."""
        return self.make_sampler(jnp.asarray(self.initial_step_size))

    @property
    def _mu(self) -> float:
        import math

        return math.log(10.0 * self.initial_step_size) if self.mu is None else self.mu

    @property
    def is_population(self) -> bool:  # type: ignore[override]
        """Delegate to the wrapped family so population samplers (emcee,
        DE-MC) keep their walker-bundle runtime path."""
        return self._template.is_population

    def transition_of(self, state: StepSizeAdaptationState) -> Any:
        return self._template.transition_of(state.inner)

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Any, StepSizeAdaptationState]:
        log_eps0 = jnp.log(jnp.asarray(self.initial_step_size, jnp.float32))
        t, inner_state = self._template.init(key, model, initial_params)
        zero = jnp.zeros((), jnp.float32)
        state = StepSizeAdaptationState(
            inner=inner_state,
            log_eps=log_eps0,
            log_eps_bar=log_eps0,
            h_bar=zero,
            t=jnp.ones((), jnp.int32),
        )
        return t, state

    def step_warmup(
        self, key: KeyArray, state: StepSizeAdaptationState, model
    ) -> Tuple[Any, StepSizeAdaptationState]:
        """One inner step at exp(log ε) + one dual-averaging update (HG14 §3.2).

        Delegates to the inner sampler's *warmup* step, so wrapping a sampler
        with its own warmup adaptation (RAM's S, AM's Welford moments) keeps
        that adaptation running alongside the scalar-scale tuning.
        """
        inner_spl = self.make_sampler(jnp.exp(state.log_eps))
        t_out, inner_state = inner_spl.step_warmup(key, state.inner, model)

        a = jnp.asarray(t_out.accepted, jnp.float32)  # E[a] = α(ε)
        t = state.t.astype(jnp.float32)
        w = 1.0 / (t + self.t0)
        h_bar = (1.0 - w) * state.h_bar + w * (self.target_accept - a)
        log_eps = self._mu - jnp.sqrt(t) / self.gamma * h_bar
        eta = jnp.power(t, -self.kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar

        new_state = StepSizeAdaptationState(
            inner=inner_state,
            log_eps=log_eps,
            log_eps_bar=log_eps_bar,
            h_bar=h_bar,
            t=state.t + 1,
        )
        return t_out, new_state

    def step(
        self, key: KeyArray, state: StepSizeAdaptationState, model
    ) -> Tuple[Any, StepSizeAdaptationState]:
        """Post-warmup: the averaged step size is frozen (≙ RAM's frozen-S
        main phase, src/RobustAdaptiveMetropolis.jl:216-237)."""
        inner_spl = self.make_sampler(jnp.exp(state.log_eps_bar))
        t_out, inner_state = inner_spl.step(key, state.inner, model)
        return t_out, replace(state, inner=inner_state)

    # -- vectorized kernels (chain-batched state, batched RNG) -------------

    @property
    def has_batched_kernel(self) -> bool:  # type: ignore[override]
        """The wrapper's batched kernels only exist when the wrapped family
        has them — otherwise the runtime must fall back to vmap-of-single."""
        return self._template.has_batched_kernel

    def _eps_batched(self, log_eps: jax.Array, batch_shape) -> jax.Array:
        """Per-chain step sizes shaped ``batch + (1,)`` so ``make_sampler``'s
        scalar-style arithmetic broadcasts over the event axis. The batched
        path therefore requires vector-shaped params (every family built by
        ``.rwmh``/``.mala``/``.barker`` qualifies)."""
        return jnp.exp(log_eps).reshape(tuple(batch_shape) + (1,))

    def step_batched(
        self, key: KeyArray, state: StepSizeAdaptationState, model, batch_shape
    ) -> Tuple[Any, StepSizeAdaptationState]:
        """Post-warmup batched step at the frozen per-chain exp(log ε̄)."""
        inner_spl = self.make_sampler(
            self._eps_batched(state.log_eps_bar, batch_shape)
        )
        t_out, inner_state = inner_spl.step_batched(
            key, state.inner, model, batch_shape
        )
        return t_out, replace(state, inner=inner_state)

    def step_warmup_batched(
        self, key: KeyArray, state: StepSizeAdaptationState, model, batch_shape
    ) -> Tuple[Any, StepSizeAdaptationState]:
        """Batched warmup: one inner batched step + the elementwise HG14
        update — every chain carries and adapts its own (log ε, ε̄, H̄, t),
        exactly the per-chain semantics of the single-chain kernel."""
        inner_spl = self.make_sampler(
            self._eps_batched(state.log_eps, batch_shape)
        )
        t_out, inner_state = inner_spl.step_warmup_batched(
            key, state.inner, model, batch_shape
        )

        a = jnp.asarray(t_out.accepted, jnp.float32)  # (C,): E[a] = α(ε)
        t = state.t.astype(jnp.float32)
        w = 1.0 / (t + self.t0)
        h_bar = (1.0 - w) * state.h_bar + w * (self.target_accept - a)
        log_eps = self._mu - jnp.sqrt(t) / self.gamma * h_bar
        eta = jnp.power(t, -self.kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * state.log_eps_bar

        new_state = StepSizeAdaptationState(
            inner=inner_state,
            log_eps=log_eps,
            log_eps_bar=log_eps_bar,
            h_bar=h_bar,
            t=state.t + 1,
        )
        return t_out, new_state

    # -- convenience families ------------------------------------------------

    @staticmethod
    def rwmh(
        d: int,
        target_accept="auto",
        initial_step_size: float = 1.0,
        **kw,
    ) -> "StepSizeAdaptation":
        """Isotropic random-walk family ``RWMH(MvNormal(0, ε·I))`` tuned to
        the dimension-aware Gelman-Roberts-Gilks optimum.

        ``target_accept="auto"`` (default) resolves via
        :func:`optimal_rwmh_accept`: the 0.234 rule is the d→∞ asymptote
        (Roberts-Gelman-Gilks 1997) — at small d the finite-dimension optima
        are markedly higher (0.44 at d=1, 0.35 at d=2; GRG 1996 Table 1),
        and targeting 0.234 there costs real ESS/s (measured on the README
        2-param Gaussian: the swept optimum sits at acceptance ≈ 0.30-0.35).
        Pass a float to pin the target explicitly."""
        from ..distributions import MvNormal
        from .mh import RWMH

        if target_accept == "auto":
            target_accept = optimal_rwmh_accept(d)
        zeros = jnp.zeros(int(d), jnp.float32)
        spl = StepSizeAdaptation(
            lambda eps: RWMH(MvNormal(zeros, scale=eps)),
            target_accept=target_accept,
            initial_step_size=initial_step_size,
            **kw,
        )
        # Records the family so sample(engine='fused') can run the fused
        # dual-averaging engine (ops/pallas_adapt.py) — same pattern as
        # MALA.langevin's step-size record.
        object.__setattr__(spl, "_fused_family", ("rwmh_iso", int(d)))
        return spl

    @staticmethod
    def mala(
        target_accept: float = 0.574, initial_step_size: float = 0.5, **kw
    ) -> "StepSizeAdaptation":
        """Langevin family ``MvNormal(ε²/2·∇, ε·I)`` tuned to the
        Roberts-Rosenthal MALA optimum 0.574."""
        from ..distributions import MvNormal
        from .mala import MALA

        return StepSizeAdaptation(
            lambda eps: MALA(
                lambda g: MvNormal(
                    0.5 * eps * eps * g, scale=eps.astype(jnp.float32)
                )
            ),
            target_accept=target_accept,
            initial_step_size=initial_step_size,
            **kw,
        )

    @staticmethod
    def hmc(
        n_leapfrog: int = 10,
        target_accept: float = 0.65,
        initial_step_size: float = 0.1,
        inverse_mass=None,
        **kw,
    ) -> "StepSizeAdaptation":
        """Fixed-trajectory HMC family tuned to the Neal/HG14 optimum 0.65
        (Neal 2011 §5.4.4; Hoffman-Gelman 2014 use 0.65 for static HMC)."""
        from .hmc import HamiltonianMC

        return StepSizeAdaptation(
            lambda eps: HamiltonianMC(
                step_size=eps, n_leapfrog=n_leapfrog, inverse_mass=inverse_mass
            ),
            target_accept=target_accept,
            initial_step_size=initial_step_size,
            **kw,
        )

    @staticmethod
    def barker(
        target_accept: float = 0.57, initial_step_size: float = 0.5, **kw
    ) -> "StepSizeAdaptation":
        """Barker-proposal family tuned to the Vogrinc-Livingstone-Zanella
        optimum ≈ 0.57."""
        from .barker import Barker

        return StepSizeAdaptation(
            lambda eps: Barker(step_size=eps),
            target_accept=target_accept,
            initial_step_size=initial_step_size,
            **kw,
        )
