"""Stein variational gradient descent (SVGD) — deterministic particle
inference.

Beyond-parity subsystem (Liu & Wang 2016): transport a particle cloud
along the steepest-descent direction of KL(q‖π) in the RKHS of an RBF
kernel,

    x_i ← x_i + ε·φ(x_i),
    φ(x_i) = (1/N) Σ_j [ k(x_j, x_i) ∇log π(x_j) + ∇_{x_j} k(x_j, x_i) ],

the attractive (kernel-smoothed gradient) term pulling particles toward
mass and the repulsive (kernel gradient) term spreading them — no
accept/reject, no randomness after init. It complements the MCMC stack
the way SMC does on the evidence side: a small particle budget gives a
deterministic, optimization-shaped posterior approximation (moments,
predictive ensembles) at a fixed, known cost.

Device shape: this is the rare inference algorithm whose hot loop IS a
matmul — the (N, N) RBF kernel, the kernel-gradient row sums, and the
kernel-smoothed gradients are three matmul contractions per step (run at
``Precision.HIGHEST``: pairwise distances enter an exp, and the repulsive
term is a near-cancellation at converged clouds — the TF32 operand
truncation trap, CLAUDE.md). The bandwidth follows the median heuristic
``h = med²/log N`` per step (one on-device sort). The whole run is one
``lax.scan`` under jit.

Scope ≙ the fused-engine family: flat ``(d,)`` array params (wrap a
pytree with ``ravel_pytree`` if needed); the model must provide gradients
(``logdensity_and_gradient_fn`` or autodiff).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.density import as_model
from ..utils import KeyArray, as_key

_HIGH = jax.lax.Precision.HIGHEST


def svgd_sample(
    model,
    *,
    key: KeyArray,
    num_particles: int = 1024,
    num_steps: int = 500,
    step_size: float = 0.1,
    initial_particles: Optional[Any] = None,
    init_scale: float = 1.0,
    adagrad_decay: float = 0.9,
) -> Dict[str, Any]:
    """Run SVGD and return the transported particle cloud.

    Particles start at ``initial_particles`` ((N, d), e.g. prior draws) or
    ``N(0, init_scale²·I)``. Steps use the paper's AdaGrad-with-momentum
    schedule (decay ``adagrad_decay``, the Liu-Wang default 0.9) so one
    ``step_size`` works across targets of different curvature.

    Returns ``particles`` ((N, d)), ``phi_norm`` (mean update magnitude
    per step, (num_steps,) — a convergence trace: it should decay), and
    ``bandwidth`` (the final median-heuristic h).
    """
    model = as_model(model)
    if num_particles < 2:
        raise ValueError("SVGD needs num_particles >= 2")
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    N = int(num_particles)
    master = as_key(key)
    if initial_particles is not None:
        x0 = jnp.asarray(initial_particles, jnp.float32)
        if x0.ndim != 2 or x0.shape[0] != N:
            raise ValueError(
                f"initial_particles must be (num_particles, d) = ({N}, d), "
                f"got {x0.shape}"
            )
        d = x0.shape[1]
        if model.dimension is not None and int(model.dimension) != d:
            raise ValueError(
                f"initial_particles dimension {d} != model.dimension "
                f"{int(model.dimension)}"
            )
    else:
        if model.dimension is None:
            raise ValueError(
                "svgd_sample needs initial_particles or "
                "DensityModel(dimension=...)."
            )
        d = int(model.dimension)
        x0 = init_scale * jax.random.normal(master, (N, d))

    if model.logdensity_and_gradient_fn is not None:
        vg = jax.vmap(model.logdensity_and_gradient_fn)
    else:
        vg = jax.vmap(jax.value_and_grad(model.logdensity_fn))

    def phi(x):
        """The Stein update direction for the whole cloud: three matmul
        contractions (Gram, K·∇, K·x) + the median-bandwidth sort."""
        _, g = vg(x)  # (N, d)
        # Pairwise squared distances via the Gram matrix (HIGHEST: they
        # feed exp(−·/h) and the repulsive near-cancellation).
        gram = jnp.matmul(x, x.T, precision=_HIGH)  # (N, N)
        sq = jnp.diag(gram)[:, None] + jnp.diag(gram)[None, :] - 2.0 * gram
        sq = jnp.maximum(sq, 0.0)
        # Median over a 256-row band of the (symmetric) distance matrix:
        # the full median sorts N² floats EVERY step and dominated the run
        # at N = 4096 (16.7M-element sort ≈ 90 ms/step on-chip); a row
        # band is an exchangeable subsample of the same distribution.
        med = jnp.median(sq[: min(N, 256)])
        h = jnp.maximum(med / math.log(N), 1e-10)
        K = jnp.exp(-sq / h)  # (N, N), K_ji symmetric
        ksum = jnp.sum(K, axis=0)  # (N,) Σ_j k_ji
        attract = jnp.matmul(K, g, precision=_HIGH)  # Σ_j k_ji ∇logπ(x_j)
        repulse = (2.0 / h) * (
            ksum[:, None] * x - jnp.matmul(K, x, precision=_HIGH)
        )  # Σ_j ∇_{x_j} k(x_j, x_i)
        return (attract + repulse) / N, h

    @jax.jit
    def run(x0):
        def body(carry, _):
            x, acc = carry
            p, h = phi(x)
            # AdaGrad with momentum (Liu-Wang): per-coordinate step.
            acc = adagrad_decay * acc + (1.0 - adagrad_decay) * p * p
            x = x + step_size * p / (1e-6 + jnp.sqrt(acc))
            return (x, acc), (jnp.mean(jnp.linalg.norm(p, axis=1)), h)

        (x, _), (norms, hs) = jax.lax.scan(
            body, (x0, jnp.zeros_like(x0)), None, length=num_steps
        )
        return x, norms, hs[-1]

    x, norms, h_final = run(x0)
    return {
        "particles": x,
        "phi_norm": np.asarray(norms),
        "bandwidth": float(h_final),
    }
