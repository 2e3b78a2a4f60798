"""Sampler kernel protocol and transition pytrees.

The reference architecture is object-dispatch over ``AbstractMCMC.step``
(src/mh-core.jl:76-117). The JAX-native shape is a pure kernel:

    sampler.init(key, model, initial_params) -> (transition, state)
    sampler.step(key, state, model)          -> (transition, state)

with every state/transition an immutable pytree. The runtime composes these
functionally: ``vmap`` over chains → ``lax.scan`` over steps → ``shard_map``
over the device mesh (see runtime/sample.py, parallel/).

Acceptance uses the reference's exact formulation ``-randexp() < logα``
(src/mh-core.jl:108), i.e. ``-Exponential(1) < logα`` — equivalent in
distribution to ``log(U) < logα``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import DensityModel, as_model
from ..utils import KeyArray, pytree_dataclass


@pytree_dataclass
class Transition:
    """≙ reference ``Transition{T,L}(params, lp, accepted)`` (src/AdvancedMH.jl:61-65).

    ``params`` is an arbitrary pytree; ``lp`` caches the log density so it is
    never recomputed (≙ the ``logdensity(model, t::Transition) = t.lp``
    memoization at src/AdvancedMH.jl:75).
    """

    params: Any
    lp: jax.Array
    accepted: jax.Array


@pytree_dataclass
class GradientTransition:
    """≙ reference ``GradientTransition`` (src/MALA.jl:14-19): caches (lp, ∇lp)
    so each MALA step costs exactly one value-and-gradient evaluation."""

    params: Any
    lp: jax.Array
    gradient: Any
    accepted: jax.Array


def accept_reject(key: KeyArray, logalpha: jax.Array) -> jax.Array:
    """MH accept test: ``-randexp() < logα`` (≙ src/mh-core.jl:108)."""
    return -jax.random.exponential(key, jnp.shape(logalpha)) < logalpha


def select_tree(pred: jax.Array, on_true, on_false):
    """Elementwise pytree select (branchless accept/reject under jit)."""
    return jax.tree_util.tree_map(
        lambda t, f: jnp.where(pred, t, f), on_true, on_false
    )


class Sampler:
    """Base class for MH-style samplers (≙ ``MHSampler``, src/AdvancedMH.jl:33)."""

    # True for population samplers (emcee Ensemble, DE-MC) whose state carries
    # a leading member/walker axis — drives the 3-D walker bundle path
    # (≙ ext/AdvancedMHMCMCChainsExt.jl:80-121).
    is_population = False

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Any, Any]:
        raise NotImplementedError

    def step(self, key: KeyArray, state, model) -> Tuple[Any, Any]:
        raise NotImplementedError

    def step_warmup(self, key: KeyArray, state, model) -> Tuple[Any, Any]:
        """≙ ``AbstractMCMC.step_warmup`` — defaults to ``step`` (only RAM
        distinguishes warmup, src/RobustAdaptiveMetropolis.jl:247-278)."""
        return self.step(key, state, model)

    def transition_of(self, state) -> Any:
        """Derive the emitted transition from a state. For most samplers the
        two coincide; RAM overrides (its state carries S, η, iteration)."""
        return state

    @property
    def has_warmup_phase(self) -> bool:
        """True when ``step_warmup`` differs from ``step`` — lets the runtime
        compile a single step body for warmup-free samplers."""
        return type(self).step_warmup is not Sampler.step_warmup

    @property
    def has_batched_kernel(self) -> bool:
        """True when the sampler provides ``step_batched`` (the vectorized
        chain-batched hot path with O(1) per-step key hashing)."""
        return hasattr(self, "step_batched")

    def step_warmup_batched(self, key: KeyArray, state, model, batch_shape):
        """Batched warmup step; defaults to ``step_batched``."""
        return self.step_batched(key, state, model, batch_shape)  # type: ignore[attr-defined]


# --- AbstractMCMC params-interface equivalents (src/AdvancedMH.jl:146-157) ---


def getparams(transition) -> Any:
    """≙ ``AbstractMCMC.getparams``."""
    if hasattr(transition, "params"):
        return transition.params
    if hasattr(transition, "x"):  # RAM state
        return transition.x
    raise TypeError(f"Cannot extract params from {type(transition).__name__}")


def setparams(model, transition, params):
    """≙ ``AbstractMCMC.setparams!!`` — returns a new transition at ``params``
    with the log density (and gradient, if cached) recomputed."""
    from ..models.density import logdensity_and_gradient

    model = as_model(model)
    if isinstance(transition, GradientTransition):
        lp, grad = logdensity_and_gradient(model, params)
        return GradientTransition(params, lp, grad, transition.accepted)
    if isinstance(transition, Transition):
        return Transition(params, model.logdensity_fn(params), transition.accepted)
    if hasattr(transition, "x"):  # RAM state: lp intentionally NOT recomputed,
        # matching reference setparams!! for RobustAdaptiveMetropolisState
        # (src/RobustAdaptiveMetropolis.jl:116-121).
        from ..utils import replace as _replace

        return _replace(transition, x=params)
    raise TypeError(f"Cannot set params on {type(transition).__name__}")
