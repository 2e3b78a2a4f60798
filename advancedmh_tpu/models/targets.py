"""Prebuilt example target models (the reference's test/README models).

These serve as fixtures for tests/benchmarks and as user-facing examples.
Each returns a :class:`DensityModel`; models whose dimension and data shapes
are powers of two also carry a transposed tile density for the fused RWMH
kernel (ops/pallas_mh.py), written in ops that lower on the Triton route.
"""
from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..distributions import InverseGamma, MvNormal, Normal
from ..ops.pallas_mh import tile_rows
from .density import DensityModel, guarded_logdensity

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _pad_column_pow2(v: np.ndarray):
    """``v`` as an ``(n_pad, 1)`` column padded with zeros to a power of two,
    and the matching 0/1 mask, so a tile density can sum over the rows
    without the padding changing it."""
    n = v.shape[0]
    n_pad = 1 << max(0, (n - 1).bit_length())
    col = np.zeros((n_pad, 1), np.float32)
    col[:n, 0] = v
    mask = np.zeros((n_pad, 1), np.float32)
    mask[:n, 0] = 1.0
    return col, mask


def gaussian_mean_scale_model(
    data: Optional[np.ndarray] = None, n_obs: int = 30, seed: int = 1234
) -> DensityModel:
    """The reference README/test flagship: θ = (μ, σ) posterior of a Normal
    with a σ ≥ 0 support guard (reference README.md:23-40 and
    test/runtests.jl:22-31)."""
    if data is None:
        data = np.random.default_rng(seed).normal(size=n_obs)
    data = jnp.asarray(data, jnp.float32)
    n = data.shape[0]

    def density(theta):
        return jnp.sum(Normal(theta[0], theta[1]).log_prob(data))

    ld = guarded_logdensity(
        support_fn=lambda t: t[1] >= 0,
        logdensity_fn=density,
        safe_params_fn=lambda t: jnp.stack([t[0], jnp.maximum(t[1], 0.1)]),
    )

    def tile_density(p, obs, mask):
        """Transposed tile form for the fused kernel: p (2, TC); ``obs`` is
        the data padded to a power-of-two column, ``mask`` zeroes the
        padding rows. One reciprocal per chain instead of n_obs divides."""
        mu, sigma = tile_rows(p)
        inv = 1.0 / jnp.maximum(sigma, 0.1)
        z = (obs - mu) * inv
        lp = (
            jnp.sum(-0.5 * mask * z * z, axis=0, keepdims=True)
            + n * jnp.log(inv)
            - n * _HALF_LOG_2PI
        )
        return jnp.where(sigma >= 0, lp, -jnp.inf)

    model = DensityModel(ld, dimension=2)
    # attach the tile form without widening the core dataclass
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(
        model, "tile_consts", _pad_column_pow2(np.asarray(data, np.float32))
    )
    return model


def correlated_gaussian_model(cov) -> DensityModel:
    """Zero-mean multivariate Gaussian target (≙ the RAM doctest Gaussian and
    the MALA issue-#95 quadratic density)."""
    cov = jnp.asarray(cov, jnp.float32)
    d = cov.shape[0]
    mv = MvNormal.from_cov(jnp.zeros(d, jnp.float32), cov)
    prec = jnp.linalg.inv(cov)
    logdet_const = float(
        -0.5 * np.log(np.linalg.det(2.0 * np.pi * np.asarray(cov)))
    )

    def ldg(x):
        g = -(prec @ x)
        return mv.log_prob(x), g

    def tile_density(x, prec_c):
        """Tile form: x (d, TC), prec_c (d, d) const; the quadratic form as
        broadcast-multiply-reduce in exact float32 (no tiny matmuls)."""
        px = jnp.sum(prec_c[:, :, None] * x[None, :, :], axis=1)
        q = jnp.sum(x * px, axis=0, keepdims=True)
        return -0.5 * q + logdet_const

    model = DensityModel(
        mv.log_prob, logdensity_and_gradient_fn=ldg, dimension=d
    )
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(model, "tile_consts", (np.asarray(prec),))
    return model


def neal_funnel_model(d: int = 10) -> DensityModel:
    """Neal's funnel (Neal 2003 §8): v ~ N(0, 3²), x_i | v ~ N(0, eᵛ) for
    i = 1..d−1 — the canonical varying-curvature stress test for adaptive
    samplers (beyond-parity validation: the reference's test geometry is
    Gaussian-only, test/runtests.jl:22-31).

    θ = (v, x_1..x_{d−1});  log π = −v²/18 − (d−1)v/2 − e^{−v}·Σx²/2 + C.
    Exact marginal ground truth: v ~ N(0, 9), so the neck mass
    P(v < −c) = Φ(−c/3) — samplers that cannot shrink their step into the
    neck (fixed-ε HMC) underestimate it by orders of magnitude.
    """
    dm1 = d - 1
    const = float(
        -0.5 * math.log(2.0 * math.pi * 9.0) - dm1 * _HALF_LOG_2PI
    )

    def logdensity(theta):
        v, x = theta[0], theta[1:]
        return (
            -v * v / 18.0
            - 0.5 * dm1 * v
            - 0.5 * jnp.exp(-v) * jnp.sum(x * x)
            + const
        )

    def ldg(theta):
        v, x = theta[0], theta[1:]
        e = jnp.exp(-v)
        sq = jnp.sum(x * x)
        lp = -v * v / 18.0 - 0.5 * dm1 * v - 0.5 * e * sq + const
        gv = -v / 9.0 - 0.5 * dm1 + 0.5 * e * sq
        gx = -e * x
        return lp, jnp.concatenate([gv[None], gx])

    return DensityModel(
        logdensity, logdensity_and_gradient_fn=ldg, dimension=d
    )


def banana_model(b: float = 0.03, sigma1: float = 10.0) -> DensityModel:
    """Haario banana (Haario-Saksman-Tamminen 1999 twisted Gaussian):
    y₁ ~ N(0, σ₁²), y₂ ~ N(0, 1) pushed through the *twist*
    x = (y₁, y₂ − b·y₁² + b·σ₁²) — a curved, banana-shaped ridge
    (beyond-parity validation target; Gaussian-only reference geometry).

    The twist is volume-preserving, so exact ground truth comes from
    transformed N(0, diag(σ₁², 1)) draws: E[x] = 0, Var[x₁] = σ₁²,
    Var[x₂] = 1 + 2b²σ₁⁴ (= 19 at the Haario defaults b=0.03, σ₁=10).
    """
    b = float(b)
    s1_sq = float(sigma1) ** 2
    const = float(-0.5 * math.log(2.0 * math.pi * s1_sq) - _HALF_LOG_2PI)

    def logdensity(x):
        y2 = x[1] + b * x[0] * x[0] - b * s1_sq
        return -0.5 * x[0] * x[0] / s1_sq - 0.5 * y2 * y2 + const

    def ldg(x):
        y2 = x[1] + b * x[0] * x[0] - b * s1_sq
        lp = -0.5 * x[0] * x[0] / s1_sq - 0.5 * y2 * y2 + const
        g0 = -x[0] / s1_sq - y2 * 2.0 * b * x[0]
        return lp, jnp.stack([g0, -y2])

    def tile_density(x):
        """Tile form: x (2, TC)."""
        x1, x2 = tile_rows(x)
        y2 = x2 + b * x1 * x1 - b * s1_sq
        return -0.5 * x1 * x1 / s1_sq - 0.5 * y2 * y2 + const

    model = DensityModel(
        logdensity, logdensity_and_gradient_fn=ldg, dimension=2
    )
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(model, "tile_consts", ())
    return model


def logistic_regression_model(
    n_obs: int = 256,
    dim: int = 32,
    *,
    prior_scale: float = 10.0,
    seed: int = 0,
    X: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
) -> DensityModel:
    """Bayesian logistic regression: β ~ N(0, prior_scale²·I),
    yᵢ ~ Bernoulli(σ(xᵢ·β)).

    The higher-dimensional showcase target (the reference's models are all
    d=2 closures; this is the same black-box-DensityModel capability,
    reference src/AdvancedMH.jl:52-54, at production scale). The likelihood
    is a matmul: the vectorized XLA kernel evaluates ``(C, d) @ (d, n)`` at
    the default matmul precision (TF32 on the GPU), and the fused kernel's
    tile form evaluates ``X (n, d) @ β (d, TC)`` at ``HIGHEST`` (IEEE
    float32). Softplus uses the overflow-stable form
    ``max(z, 0) + log1p(exp(−|z|))``.

    When ``X``/``y`` are omitted, a synthetic dataset is generated and the
    generating coefficients are attached as ``model.beta_true``.
    """
    beta_true = None
    if X is None:
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n_obs, dim)).astype(np.float32) / np.sqrt(dim)
        beta_true = 2.0 * rng.normal(size=(dim,)).astype(np.float32)
        logits = X @ beta_true
        y = (rng.uniform(size=n_obs) < 1.0 / (1.0 + np.exp(-logits))).astype(
            np.float32
        )
    elif y is None:
        raise ValueError("supply y along with X")
    X = jnp.asarray(X, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    n, d = X.shape
    inv_var = 1.0 / float(prior_scale) ** 2

    def _softplus(z):
        return jnp.maximum(z, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(z)))

    def logdensity(beta):
        z = X @ beta
        ll = jnp.sum(y * z - _softplus(z))
        return ll - 0.5 * inv_var * jnp.sum(beta * beta)

    def ldg(beta):
        z = X @ beta
        lp = jnp.sum(y * z - _softplus(z)) - 0.5 * inv_var * jnp.sum(
            beta * beta
        )
        g = X.T @ (y - jax.nn.sigmoid(z)) - inv_var * beta
        return lp, g

    def batched(betas):  # (C, d) -> (C,): one matmul for all chains
        z = betas @ X.T  # (C, n)
        ll = jnp.sum(y[None, :] * z - _softplus(z), axis=1)
        return ll - 0.5 * inv_var * jnp.sum(betas * betas, axis=1)

    def tile_density(b, Xc, yc):
        """Tile form: b (d, TC), Xc (n, d), yc (n, 1). The logits matmul is
        a ``pl.dot`` inside the fused kernel, at IEEE float32 precision."""
        z = jax.lax.dot_general(
            Xc, b, (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32,
        )  # (n, TC)
        ll = jnp.sum(yc * z - _softplus(z), axis=0, keepdims=True)
        return ll - 0.5 * inv_var * jnp.sum(b * b, axis=0, keepdims=True)

    model = DensityModel(
        logdensity,
        logdensity_and_gradient_fn=ldg,
        dimension=d,
        logdensity_batched_fn=batched,
    )
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(
        model, "tile_consts",
        (np.asarray(X), np.asarray(y).reshape(-1, 1)),
    )
    if beta_true is not None:
        object.__setattr__(model, "beta_true", beta_true)
    return model


def emcee_demo_model(transformed: bool = False) -> DensityModel:
    """The reference emcee test model (test/emcee.jl): s ~ InverseGamma(2,3),
    m ~ N(0, √s), observations 1.5 and 2.0 from N(m, √s). Analytic posterior
    means s̄ = 49/24, m̄ = 7/6. ``transformed=True`` uses (log s, m) with the
    Jacobian correction."""

    # Closed form of the joint density, shared by the tile forms below
    # (log/div only — no powf, no lgamma; lgamma(2) = 0):
    #   IG(2,3):  2·log 3 − 3·log s − 3/s
    #   N(0,√s)(m) + N(m,√s)(1.5) + N(m,√s)(2.0):
    #             −(3/2)(log s + log 2π) − [m² + (1.5−m)² + (2−m)²]/(2s)
    _IG_CONST = 2.0 * math.log(3.0)

    def _joint_from_s(log_s, inv_s, m):
        quad = m * m + (1.5 - m) * (1.5 - m) + (2.0 - m) * (2.0 - m)
        return (
            _IG_CONST
            - 3.0 * log_s
            - 3.0 * inv_s
            - 1.5 * log_s
            - 3.0 * _HALF_LOG_2PI
            - 0.5 * quad * inv_s
        )

    if transformed:

        def logprob(theta):
            logs, m = theta[0], theta[1]
            s = jnp.exp(logs)
            sqrts = jnp.sqrt(s)
            return (
                InverseGamma(2.0, 3.0).log_prob(s)
                + Normal(0.0, sqrts).log_prob(m)
                + Normal(m, sqrts).log_prob(1.5)
                + Normal(m, sqrts).log_prob(2.0)
                + logs
            )

        def tile_density_t(x):
            """Tile form: x = (log s, m) rows, shape (2, TC)."""
            logs, m = tile_rows(x)
            return _joint_from_s(logs, jnp.exp(-logs), m) + logs

        model = DensityModel(logprob, dimension=2)
        object.__setattr__(model, "tile_density", tile_density_t)
        object.__setattr__(model, "tile_consts", ())
        return model

    def logprob(theta):
        s, m = theta[0], theta[1]
        safe_s = jnp.maximum(s, 1e-6)
        sqrts = jnp.sqrt(safe_s)
        lp = (
            InverseGamma(2.0, 3.0).log_prob(safe_s)
            + Normal(0.0, sqrts).log_prob(m)
            + Normal(m, sqrts).log_prob(1.5)
            + Normal(m, sqrts).log_prob(2.0)
        )
        return jnp.where(s > 0, lp, -jnp.inf)

    def tile_density(x):
        """Tile form: x = (s, m) rows, shape (2, TC). Out-of-support
        proposals (s ≤ 0) get a large-negative lp instead of −inf so in-kernel
        logα arithmetic never produces NaN."""
        s, m = tile_rows(x)
        safe_s = jnp.maximum(s, jnp.float32(1e-6))
        lp = _joint_from_s(jnp.log(safe_s), 1.0 / safe_s, m)
        return jnp.where(s > 0, lp, jnp.float32(-1e30))

    model = DensityModel(logprob, dimension=2)
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(model, "tile_consts", ())
    return model


def gp_latent_model(
    n_points: int = 64,
    likelihood: str = "gaussian",
    noise: float = 0.25,
    lengthscale: float = 0.2,
    amplitude: float = 1.0,
    seed: int = 0,
):
    """1-D Gaussian-process latent field on a uniform grid — the showcase
    target for :class:`EllipticalSlice` (likelihood × Gaussian prior, the
    factorization ESS requires; the reference's commented-out elliptical
    slice code at src/emcee.jl:104-214 was built for exactly this class).

    The latent ``f ∈ R^{n_points}`` has prior ``N(0, K)`` with an RBF kernel
    over grid x ∈ [0, 1]; observations come from a smooth ground-truth draw.

    Returns ``(model, prior, aux)``:

    - ``model`` — :class:`DensityModel` whose logdensity is the
      **log-likelihood only** (what ESS consumes)
    - ``prior`` — ``MvNormal(0, scale_tril=chol(K))``; under a chain batch
      its per-step ellipse draw is a batched triangular matvec
    - ``aux`` — dict with the grid ``x``, observations ``y``, the true
      latent ``f_true``, and for ``likelihood="gaussian"`` the analytic
      posterior ``post_mean``/``post_cov`` (closed form:
      ``Σ = K − K(K+σ²I)⁻¹K``, ``m = K(K+σ²I)⁻¹y``) so tests can assert
      sampler output against exact values.

    ``likelihood="logistic"`` gives GP binary classification
    (y ∈ {−1, +1}, log σ(y·f) pointwise) — non-conjugate, the standard ESS
    application.
    """
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n_points, dtype=np.float64)
    sq = (x[:, None] - x[None, :]) ** 2
    K = amplitude**2 * np.exp(-0.5 * sq / lengthscale**2)
    K += 1e-6 * np.eye(n_points)
    L = np.linalg.cholesky(K)
    f_true = L @ rng.normal(size=n_points)

    prior = MvNormal(
        jnp.zeros(n_points, jnp.float32),
        scale_tril=jnp.asarray(L, jnp.float32),
    )
    aux = {"x": x, "f_true": f_true}

    if likelihood == "gaussian":
        y = f_true + noise * rng.normal(size=n_points)
        A = np.linalg.solve(K + noise**2 * np.eye(n_points), K)  # (K+σ²I)⁻¹K
        aux["post_mean"] = K @ np.linalg.solve(
            K + noise**2 * np.eye(n_points), y
        )
        aux["post_cov"] = K - K @ A
        y_j = jnp.asarray(y, jnp.float32)
        inv2 = 1.0 / (noise * noise)

        def loglik(f):
            r = y_j - f
            return -0.5 * inv2 * jnp.sum(r * r) - n_points * (
                _HALF_LOG_2PI + math.log(noise)
            )

        def batched(fs):  # (C, d) -> (C,)
            r = y_j - fs
            return -0.5 * inv2 * jnp.sum(r * r, axis=-1) - n_points * (
                _HALF_LOG_2PI + math.log(noise)
            )

        def tile_density(f, y_col):  # tile form: f (d, TC)
            r = y_col - f
            return -0.5 * inv2 * jnp.sum(r * r, axis=0, keepdims=True) - (
                n_points * (_HALF_LOG_2PI + math.log(noise))
            )

    elif likelihood == "logistic":
        y = np.where(f_true + noise * rng.normal(size=n_points) > 0, 1.0, -1.0)
        y_j = jnp.asarray(y, jnp.float32)

        def loglik(f):
            return -jnp.sum(jnp.logaddexp(0.0, -y_j * f))

        def batched(fs):
            return -jnp.sum(jnp.logaddexp(0.0, -y_j * fs), axis=-1)

        def tile_density(f, y_col):  # stable softplus with raw exp/log ops
            t = -y_col * f
            sp = jnp.maximum(t, 0.0) + jnp.log(1.0 + jnp.exp(-jnp.abs(t)))
            return -jnp.sum(sp, axis=0, keepdims=True)

    else:
        raise ValueError(f"unknown likelihood {likelihood!r}")

    aux["y"] = y
    model = DensityModel(
        loglik, logdensity_batched_fn=batched, dimension=n_points
    )
    object.__setattr__(model, "tile_density", tile_density)
    object.__setattr__(
        model, "tile_consts", (np.asarray(y, np.float32).reshape(-1, 1),)
    )
    return model, prior, aux
