"""Log-density model layer.

≙ reference src/AdvancedMH.jl:52-77 (``DensityModel``, ``logdensity`` dispatch)
plus the LogDensityProblems.jl 3-function interface the reference accepts
everywhere via ``DensityModelOrLogDensityModel`` (src/AdvancedMH.jl:56), plus
the ForwardDiff AD extension (ext/AdvancedMHForwardDiffExt.jl:13-17) — which
collapses into ``jax.value_and_grad`` here, so gradients need no extension
mechanism at all.

A model is fundamentally a pure function ``params_pytree -> scalar logdensity``
that will be traced into the scanned sampling kernel and vmapped over chains.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils import pytree_dataclass, static_field


class CapabilityOrder:
    """≙ LogDensityProblems.LogDensityOrder: 0 = value only, 1 = value+gradient."""

    ZERO = 0
    ONE = 1


@pytree_dataclass
class DensityModel:
    """Wraps a self-contained log-density function over a params pytree.

    ≙ reference ``DensityModel(f)`` (src/AdvancedMH.jl:52-54).

    ``logdensity_fn`` must be jit-traceable. ``logdensity_and_gradient_fn`` is
    optional: when absent, gradients (for MALA) come from
    ``jax.value_and_grad`` — the built-in equivalent of the reference's
    ForwardDiff extension.

    ``dimension`` is optional metadata (≙ ``LogDensityProblems.dimension``);
    samplers that need it (RAM init without initial params) will error
    helpfully if it is missing and cannot be inferred.
    """

    logdensity_fn: Callable[[Any], jax.Array] = static_field()
    logdensity_and_gradient_fn: Optional[Callable[[Any], Tuple[jax.Array, Any]]] = (
        static_field(default=None)
    )
    dimension: Optional[int] = static_field(default=None)
    capabilities: int = static_field(default=CapabilityOrder.ONE)
    # Optional natively-batched density ``params(C, ...) -> lp(C,)`` for the
    # vectorized kernel path; default is vmap of logdensity_fn (XLA fuses it
    # identically for elementwise densities — supply this only when a manual
    # batched form maps better onto one matmul, e.g. a matmul-heavy
    # likelihood).
    logdensity_batched_fn: Optional[Callable[[Any], jax.Array]] = static_field(
        default=None
    )

    def logdensity(self, params) -> jax.Array:
        return self.logdensity_fn(params)


# ≙ reference's union alias DensityModelOrLogDensityModel: anything with a
# ``logdensity`` method, or a raw callable, is accepted by every sampler.
def as_model(model_or_fn) -> DensityModel:
    """Coerce a callable / LogDensityProblems-style object to a DensityModel."""
    if isinstance(model_or_fn, DensityModel):
        return model_or_fn
    if callable(model_or_fn) and not hasattr(model_or_fn, "logdensity"):
        return DensityModel(logdensity_fn=model_or_fn)
    # LogDensityProblems-style object: .logdensity(x), optional .dimension /
    # .capabilities / .logdensity_and_gradient
    ld = getattr(model_or_fn, "logdensity")
    ldg = getattr(model_or_fn, "logdensity_and_gradient", None)
    dim = getattr(model_or_fn, "dimension", None)
    if callable(dim):
        dim = dim()
    cap = getattr(model_or_fn, "capabilities", None)
    if callable(cap):
        cap = cap()
    if cap is None:
        # No declared capability: an object providing its own gradient is
        # order 1; otherwise order 0, so MALA raises the reference's helpful
        # error (src/MALA.jl:42-52) instead of attempting value_and_grad on
        # a density never declared differentiable. (Plain callables and
        # DensityModel default to order 1 — jax can differentiate them.)
        cap = CapabilityOrder.ONE if ldg is not None else CapabilityOrder.ZERO
    return DensityModel(
        logdensity_fn=ld,
        logdensity_and_gradient_fn=ldg,
        dimension=dim,
        capabilities=cap,
    )


def logdensity(model: DensityModel, params) -> jax.Array:
    """Evaluate the log density (≙ AdvancedMH.logdensity, src/AdvancedMH.jl:74).

    The reference memoizes via ``Transition.lp``; here memoization is
    structural — kernels carry ``lp`` in their state pytree and never
    re-evaluate (see samplers/*).
    """
    return model.logdensity_fn(params)


def logdensity_batched(model: DensityModel, params) -> jax.Array:
    """Chain-batched density for the vectorized kernel path."""
    if model.logdensity_batched_fn is not None:
        return model.logdensity_batched_fn(params)
    return jax.vmap(model.logdensity_fn)(params)


def logdensity_and_gradient(model: DensityModel, params):
    """Value+gradient of the log density.

    ≙ reference ``logdensity_and_gradient`` (src/MALA.jl:100-105 and
    ext/AdvancedMHForwardDiffExt.jl:13-17). Uses the model-provided function
    when available, otherwise ``jax.value_and_grad`` (reverse-mode; one fused
    fwd+bwd pass per step, matching the reference's one-gradient-per-step
    contract, src/MALA.jl:73-75).
    """
    check_capabilities(model)
    if model.logdensity_and_gradient_fn is not None:
        return model.logdensity_and_gradient_fn(params)
    return jax.value_and_grad(model.logdensity_fn)(params)


def check_capabilities(model: DensityModel) -> None:
    """≙ reference ``check_capabilities`` (src/MALA.jl:42-52)."""
    if model.capabilities is None:
        raise ValueError(
            "The log density model does not declare its capabilities; cannot "
            "verify gradient support."
        )
    if (
        model.capabilities == CapabilityOrder.ZERO
        and model.logdensity_and_gradient_fn is None
    ):
        raise ValueError(
            "The gradient of the log density function is not defined: the model "
            "declares capability order 0 and provides no "
            "logdensity_and_gradient_fn. Provide one, or declare order >= 1 to "
            "use jax.value_and_grad."
        )


def guarded_logdensity(
    support_fn: Callable[[Any], jax.Array],
    logdensity_fn: Callable[[Any], jax.Array],
    safe_params_fn: Optional[Callable[[Any], Any]] = None,
) -> Callable[[Any], jax.Array]:
    """Build a support-guarded log density that is safe under ``jax.grad``.

    ≙ the reference test model's guard ``θ[2] >= 0 ? ... : -Inf``
    (reference test/runtests.jl:26-28). A naive ``jnp.where(ok, lp, -inf)``
    still evaluates ``lp`` at invalid params, producing NaN gradients; this
    helper applies the standard double-where trick: out-of-support params are
    first replaced by ``safe_params_fn(params)`` (default: identity — supply
    one if your density NaNs outside the support), the density is evaluated at
    the safe point, and the result is masked to ``-inf``.
    """

    def guarded(params):
        ok = support_fn(params)
        safe = safe_params_fn(params) if safe_params_fn is not None else params
        lp = logdensity_fn(safe)
        return jnp.where(ok, lp, -jnp.inf)

    return guarded
