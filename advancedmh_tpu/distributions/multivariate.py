"""Multivariate distributions.

``MvNormal`` keeps *structure-aware fast paths* — isotropic / diagonal scales
avoid the d×d matvec entirely, which matters because the reference's most
common construction is the standard-normal random walk
(``RWMH(d) = MvNormal(Zeros(d), I)``, reference src/mh-core.jl:48-51): that
proposal must compile to a pure elementwise ``randn``-scale-add, not a
matmul. The full ``scale_tril`` path becomes a batched triangular matvec
under ``vmap``, at ``HIGHEST`` precision: pCN and EllipticalSlice are exact
only if this prior draw is, and a float32 matmul on the GPU otherwise runs
in TF32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import random as jr

from ..utils import pytree_dataclass, static_field
from .base import Distribution
from .univariate import _LOG_2PI


@pytree_dataclass
class MvNormal(Distribution):
    """Multivariate normal.

    Exactly one scale parameterization is active:

    - ``scale_tril``: lower-triangular Cholesky factor of the covariance
    - ``scale_diag``: diagonal std-devs (no matmul)
    - ``scale``: scalar isotropic std-dev (default 1.0 → standard normal)

    ``MvNormal(loc)`` is the ≙ of the reference's ``MvNormal(Zeros(d), I)``.
    """

    loc: jax.Array
    scale_tril: Optional[jax.Array] = None
    scale_diag: Optional[jax.Array] = None
    scale: jax.Array = 1.0

    @staticmethod
    def from_cov(loc, cov):
        return MvNormal(loc=loc, scale_tril=jnp.linalg.cholesky(cov))

    @staticmethod
    def standard(d: int, dtype=jnp.float32):
        return MvNormal(loc=jnp.zeros((d,), dtype=dtype))

    @property
    def dim(self) -> int:
        return jnp.shape(self.loc)[-1]

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return (self.dim,)

    def sample(self, key, sample_shape: Tuple[int, ...] = ()):
        shape = sample_shape + jnp.shape(self.loc)
        eps = jr.normal(key, shape, dtype=jnp.result_type(self.loc, float))
        if self.scale_tril is not None:
            # x = loc + L @ eps, in full float32 (not TF32).
            return self.loc + jnp.einsum(
                "...ij,...j->...i", self.scale_tril, eps,
                precision=jax.lax.Precision.HIGHEST,
            )
        if self.scale_diag is not None:
            return self.loc + self.scale_diag * eps
        return self.loc + self.scale * eps

    def log_prob(self, x):
        d = self.dim
        diff = x - self.loc
        if self.scale_tril is not None:
            # triangular_solve does not broadcast batch dims — align L and
            # diff explicitly so a chain-batched x works against a single L
            # (the step_batched hot path for full-covariance proposals).
            L = self.scale_tril
            batch = jnp.broadcast_shapes(
                jnp.shape(L)[:-2], jnp.shape(diff)[:-1]
            )
            L = jnp.broadcast_to(L, batch + jnp.shape(L)[-2:])
            diff = jnp.broadcast_to(diff, batch + (d,))
            z = jax.scipy.linalg.solve_triangular(L, diff[..., None], lower=True)[
                ..., 0
            ]
            half_logdet = jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1)
            maha = jnp.sum(z * z, axis=-1)
        elif self.scale_diag is not None:
            z = diff / self.scale_diag
            half_logdet = jnp.sum(jnp.log(self.scale_diag), axis=-1)
            maha = jnp.sum(z * z, axis=-1)
        else:
            z = diff / self.scale
            s = jnp.asarray(self.scale) * jnp.ones(())
            if s.ndim > 0 and s.shape[-1] == 1:
                # A batch of per-chain scalar scales carries a trailing
                # singleton so it broadcasts over the event axis in sample();
                # collapse it here so log_prob stays (batch,)-shaped.
                s = s[..., 0]
            half_logdet = d * jnp.log(s)
            maha = jnp.sum(z * z, axis=-1)
        return -0.5 * (maha + d * _LOG_2PI) - half_logdet
