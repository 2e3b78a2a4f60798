"""MEADS: Maximum-Eigenvalue Adaptation of Damping and Step size
(beyond-parity; Hoffman & Sountsov, AISTATS 2022).

The warmup-free flagship: generalized HMC (one leapfrog step per iteration
with PERSISTENT, partially-refreshed momentum — Horowitz 1991) whose three
tuning parameters are recomputed EVERY step from cross-chain statistics of
a *complementary fold* of chains:

- **preconditioner** ``σ_d`` — per-dimension std-dev of the fold's positions
  (diagonal mass ``M^{-1/2} = diag(σ)``);
- **step size** ``ε = a·λ̂_g^{-1/2}`` (``a = step_size_multiplier``, paper
  value 1/2) where ``λ̂_g`` is a maximum-eigenvalue estimate of the second
  moment of the *preconditioned gradients* — for a Gaussian target
  ``E[(σ∘∇)(σ∘∇)ᵀ]``'s top eigenvalue is the largest curvature in
  normalized space, so ε lands at half the stability limit;
- **damping** ``γ = λ̂_x^{-1/2}`` from the same estimator on the
  *normalized positions* — the momentum decorrelation timescale is matched
  to the slowest mode; refresh fraction ``α = 1 − e^{−2εγ}``, slice drift
  ``δ = α/2``.

The max-eigenvalue estimator is the paper's pair trick for PSD second
moments ``A = E[vvᵀ]``: ``λ̂ = tr(A²)/tr(A)`` with
``tr(A²) ≈ Σ_{i≠j}⟨v_i,v_j⟩²/(F(F−1))`` and ``tr(A) ≈ Σ_i‖v_i‖²/F`` —
a soft-max over the spectrum needing only one (d,F)·(F,d) Gram matmul
(run at ``Precision.HIGHEST``; the GPU default runs float32 matmuls in TF32).

**Why folds.** Chains are partitioned into ``n_folds`` contiguous blocks;
fold k's parameters come from fold k−1 (mod K), and folds update
SEQUENTIALLY within one iteration. Each fold's kernel therefore conditions
only on chains it does not move — a valid Gibbs-style composition that
leaves the product target invariant *while adapting forever*: MEADS has no
warmup/frozen split and every draw is usable. This is the framework's
many-chain, cross-chain-statistics stance (≙ ChEES/pooled AdaptiveHMC)
taken to its limit: adaptation IS the sampler.

**Acceptance** (``accept="nonreversible"``, the paper's choice): Neal's
(2020) non-reversible slice scheme. Each chain carries a persistent
``u ∈ [0,1)``; accept iff ``u < a`` with ``a = min(1, e^{logα})``, then
``u ← u/a`` (accept) or ``(u−a)/(1−a)`` (reject) — both keep u uniform —
plus the deterministic drift ``u ← (u + δ) mod 1``. Clustered acceptances
mean the persistent momentum is rarely flipped (a flip reverses a GHMC
chain's direction, the failure mode that makes naive GHMC random-walk).
``accept="metropolis"`` swaps in the standard fresh ``−randexp < logα``
test (momentum still flips on rejection). Rejections always negate the
momentum — the GHMC correctness requirement.

Scope: array params (the ``(d,)``-vector family every fused engine
targets); pytree params raise. Requires a chain batch — there is no
single-chain MEADS signal (``step`` raises; ``step_batched`` is the
kernel, ≙ ChEES's batched-only ChEES gradient). Chains shard over the
mesh as usual; the per-fold reductions compile to psums across devices
under GSPMD (SURVEY §2 "psum … cross-chain adaptation stats").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model
from ..utils import KeyArray, pytree_dataclass
from .base import Sampler, Transition

_HIGH = jax.lax.Precision.HIGHEST
_TINY = 1e-30


@pytree_dataclass
class MEADSState:
    """Per-chain GHMC state: position/density/gradient plus the two
    persistent variables (normalized momentum p ~ N(0, I) and Neal's
    slice u ~ U[0,1)) that make the kernel non-reversible."""

    x: jax.Array  # (d,) position (chain-batched by the runtime)
    lp: jax.Array  # log density at x
    grad: jax.Array  # (d,) gradient at x
    p: jax.Array  # (d,) persistent momentum, normalized space
    u: jax.Array  # persistent slice variable in [0, 1)
    iteration: jax.Array  # int32, 1-based (drives the early damping floor)
    isaccept: jax.Array  # previous step's accept flag


@dataclasses.dataclass(frozen=True)
class MEADS(Sampler):
    """Tuning-free generalized HMC with cross-fold adaptation (module
    docstring). ``n_folds`` ≙ the paper's K = 4; ``step_size_multiplier``
    the ½ of ``ε = ½λ̂^{-1/2}``; ``step_size_clip`` caps ε in normalized
    space (a flat-gradient batch would otherwise send ε → ∞);
    ``damping_slowdown`` scales the early-iteration damping floor
    ``γ ≥ damping_slowdown/(ε·(t+1))``."""

    n_folds: int = 4
    step_size_multiplier: float = 0.5
    step_size_clip: float = 1.0
    damping_slowdown: float = 1.0
    diagonal_preconditioning: bool = True
    accept: str = "nonreversible"  # or "metropolis"

    def __post_init__(self):
        if self.n_folds < 2:
            raise ValueError("MEADS needs n_folds >= 2")
        if self.step_size_multiplier <= 0.0:
            raise ValueError("step_size_multiplier must be positive")
        if self.accept not in ("nonreversible", "metropolis"):
            raise ValueError(
                f"accept must be 'nonreversible' or 'metropolis', "
                f"got {self.accept!r}"
            )

    # -- helpers -----------------------------------------------------------

    def transition_of(self, state: MEADSState) -> Transition:
        return Transition(state.x, state.lp, state.isaccept)

    def _vg(self, model):
        model = as_model(model)
        if model.logdensity_and_gradient_fn is not None:
            vg = model.logdensity_and_gradient_fn
        else:
            vg = jax.value_and_grad(model.logdensity_fn)
        return jax.vmap(vg)

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, MEADSState]:
        """Per-chain init (the runtime vmaps this over the chain batch).
        Draws the persistent momentum from its stationary N(0, I) and the
        slice variable from U[0,1)."""
        from ..models.density import logdensity_and_gradient

        model = as_model(model)
        k_x, k_p, k_u = jax.random.split(key, 3)
        if initial_params is None:
            if model.dimension is None:
                raise ValueError(
                    "MEADS needs the model dimension: pass initial_params "
                    "or set DensityModel(dimension=...)."
                )
            x = jax.random.normal(k_x, (int(model.dimension),))
        else:
            if jax.tree_util.tree_structure(
                initial_params
            ) != jax.tree_util.tree_structure(0):
                raise ValueError(
                    "MEADS supports array params (a (d,) vector per "
                    "chain); pytree params are out of scope (module "
                    "docstring)."
                )
            x = jnp.asarray(initial_params, dtype=jnp.result_type(float))
        if x.ndim != 1:
            raise ValueError(
                "MEADS supports array params (a (d,) vector per chain); "
                "pytree params are out of scope (module docstring)."
            )
        lp, grad = logdensity_and_gradient(model, x)
        state = MEADSState(
            x=x,
            lp=lp,
            grad=jnp.asarray(grad),
            p=jax.random.normal(k_p, x.shape, x.dtype),
            u=jax.random.uniform(k_u, (), x.dtype),
            iteration=jnp.ones((), jnp.int32),
            isaccept=jnp.ones((), bool),
        )
        return Transition(x, lp, jnp.ones((), bool)), state

    def step(self, key: KeyArray, state, model):
        raise ValueError(
            "MEADS adapts every parameter from complementary chain folds - "
            "there is no single-chain signal. Run it with num_chains >= "
            f"2*n_folds ({2 * self.n_folds}) on the vectorized path "
            "(the default chain_method)."
        )

    @staticmethod
    def _max_eig(v: jax.Array) -> jax.Array:
        """Soft maximum eigenvalue of A = E[v vᵀ] from F row samples:
        tr(A²)/tr(A) with the unbiased i≠j pair estimate of tr(A²)
        (Hoffman-Sountsov 2022 §3.1). One (d,F)·(F,d) Gram matmul."""
        F = v.shape[0]
        G = jnp.matmul(v.T, v, precision=_HIGH)  # (d, d)
        row2 = jnp.sum(v * v, axis=1)  # (F,)
        tr_a = jnp.sum(row2) / F
        tr_a2 = (jnp.sum(G * G) - jnp.sum(row2 * row2)) / (F * (F - 1))
        return tr_a2 / jnp.maximum(tr_a, _TINY)

    def _fold_parameters(self, xb, gb, it):
        """(σ, ε, α, δ) for the fold being moved, from the complementary
        fold's positions ``xb`` and gradients ``gb`` (module docstring)."""
        dt = xb.dtype
        if self.diagonal_preconditioning:
            sigma = jnp.maximum(jnp.std(xb, axis=0), 1e-10)
        else:
            sigma = jnp.ones(xb.shape[-1], dt)
        lam_g = self._max_eig(gb * sigma)
        eps = self.step_size_multiplier * jax.lax.rsqrt(
            jnp.maximum(lam_g, _TINY)
        )
        eps = jnp.minimum(eps, jnp.asarray(self.step_size_clip, dt))
        z = (xb - jnp.mean(xb, axis=0)) / sigma
        lam_x = self._max_eig(z)
        gamma = jax.lax.rsqrt(jnp.maximum(lam_x, 1.0))
        # Early floor: with t small the position spread understates the
        # slow modes — keep some refresh so momenta cannot lock in.
        gamma = jnp.maximum(
            gamma, self.damping_slowdown / (eps * (it.astype(dt) + 1.0))
        )
        alpha = 1.0 - jnp.exp(-2.0 * eps * gamma)
        return sigma, eps, alpha, 0.5 * alpha

    def _ghmc_fold(self, key, xk, lpk, gk, pk, uk, vg, sigma, eps, alpha,
                   delta):
        """One GHMC step for a fold: partial momentum refresh, ONE
        preconditioned leapfrog step, Neal-slice (or Metropolis) accept
        with momentum negation on rejection."""
        F, d = xk.shape
        k_z, k_e = jax.random.split(key)
        z = jax.random.normal(k_z, (F, d), xk.dtype)
        p1 = jnp.sqrt(1.0 - alpha) * pk + jnp.sqrt(alpha) * z
        ph = p1 + (0.5 * eps) * (sigma * gk)
        y = xk + eps * (sigma * ph)
        lp_y, g_y = vg(y)
        p2 = ph + (0.5 * eps) * (sigma * g_y)
        ke1 = 0.5 * jnp.sum(p1 * p1, axis=1)
        ke2 = 0.5 * jnp.sum(p2 * p2, axis=1)
        logalpha = (lp_y - ke2) - (lpk - ke1)
        # Divergences (non-finite logα) count as acceptance probability 0.
        a = jnp.where(
            jnp.abs(logalpha) < 1e30,
            jnp.exp(jnp.minimum(logalpha, 0.0)),
            0.0,
        )
        if self.accept == "nonreversible":
            acc = uk < a
            u_new = jnp.where(
                acc,
                uk / jnp.maximum(a, _TINY),
                (uk - a) / jnp.maximum(1.0 - a, _TINY),
            )
            u_next = jnp.mod(u_new + delta, 1.0)
        else:
            acc = -jax.random.exponential(k_e, (F,)) < logalpha
            u_next = uk
        mask = acc[:, None]
        x_new = jnp.where(mask, y, xk)
        lp_new = jnp.where(acc, lp_y, lpk)
        g_new = jnp.where(mask, g_y, gk)
        # Momentum negation on rejection: the GHMC correctness requirement
        # (without it persistent momentum breaks detailed balance).
        p_new = jnp.where(mask, p2, -p1)
        return x_new, lp_new, g_new, p_new, u_next, acc

    def step_batched(
        self, key: KeyArray, state: MEADSState, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[Transition, MEADSState]:
        """One MEADS iteration: every fold takes one GHMC step, fold k
        tuned by fold k−1's CURRENT state (sequential sweep — fold 0 sees
        fold K−1 from the previous iteration, fold 1 sees fold 0's fresh
        positions; each conditional kernel leaves the product target
        invariant, so the composition does too)."""
        C = batch_shape[0]
        K = self.n_folds
        if C % K != 0 or C // K < 2:
            raise ValueError(
                f"MEADS needs num_chains divisible by n_folds={K} with "
                f">= 2 chains per fold (got {C})."
            )
        vg = self._vg(model)
        it = state.iteration.reshape(-1)[0]
        split = lambda a: list(jnp.split(a, K, axis=0))
        xs, lps, gs = split(state.x), split(state.lp), split(state.grad)
        ps, us = split(state.p), split(state.u)
        accs = [None] * K
        for k in range(K):
            b = (k - 1) % K
            sigma, eps, alpha, delta = self._fold_parameters(
                xs[b], gs[b], it
            )
            xs[k], lps[k], gs[k], ps[k], us[k], accs[k] = self._ghmc_fold(
                jax.random.fold_in(key, k), xs[k], lps[k], gs[k], ps[k],
                us[k], vg, sigma, eps, alpha, delta,
            )
        cat = lambda parts: jnp.concatenate(parts, axis=0)
        state_new = MEADSState(
            x=cat(xs),
            lp=cat(lps),
            grad=cat(gs),
            p=cat(ps),
            u=cat(us),
            iteration=state.iteration + 1,
            isaccept=cat(accs),
        )
        return self.transition_of(state_new), state_new
