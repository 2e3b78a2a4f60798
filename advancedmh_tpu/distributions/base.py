"""Distribution protocol.

JAX-native replacement for the slice of Distributions.jl the reference uses
(``rand`` / ``logpdf`` at reference src/proposal.jl:24-35). Distributions are
immutable pytree dataclasses whose parameters may be traced arrays — this is
what lets *state-dependent* proposals (reference src/proposal.jl:92-126, e.g.
``MALA(g -> MvNormal(σ²/2 * g, σ² * I))``) trace straight into the jitted
sampling kernel: the user's function returns a fresh ``Distribution`` pytree
of traced values each step, at zero runtime cost.
"""
from __future__ import annotations

from typing import Tuple

import jax

from ..utils import KeyArray


class Distribution:
    """Base class for all distributions.

    Subclasses are pytree dataclasses implementing:

    - ``sample(key, sample_shape=()) -> Array`` of shape
      ``sample_shape + batch_shape + event_shape``
    - ``log_prob(x) -> Array`` of shape ``batch_shape`` (summed over the event)

    A distribution intentionally *without* ``log_prob`` (like the reference's
    ``CustomNormal`` negative-test distribution, reference test/util.jl:1-7)
    simply doesn't override it and raises ``NotImplementedError`` — symmetric
    proposals never call it, asymmetric ones fail loudly.
    """

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, key: KeyArray, sample_shape: Tuple[int, ...] = ()) -> jax.Array:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement sample()."
        )

    def log_prob(self, x) -> jax.Array:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement log_prob(); "
            "it can only be used as a *symmetric* proposal "
            "(the Hastings correction never evaluates the proposal density)."
        )
