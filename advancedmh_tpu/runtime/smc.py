"""Adaptive-tempering Sequential Monte Carlo (SMC) sampler.

Beyond-parity subsystem (≙ nothing in the reference) — the fourth member
of the evidence stack (TI / stepping-stone / AIS, runtime/evidence.py) and
a qualitatively different capability: a *particle* method whose output is
BOTH a posterior sample and a marginal-likelihood estimate, with the
temperature schedule chosen by the data instead of a fixed ladder.

The Del Moral-Doucet-Jasra (2006) tempered-likelihood scheme:

    π_β(x) ∝ p(x) · L(x)^β,   β: 0 → 1 in ADAPTIVE steps

per stage: (1) pick the next β' so the incremental weights
``w ∝ exp((β'−β)·ℓ)`` retain a target effective sample size (bisection on
the conditional ESS — the standard adaptive-SMC rule); (2) accumulate the
evidence increment ``log Z += log Σ W·w`` (unbiased-in-Ẑ per stage);
(3) systematic-resample the particles; (4) rejuvenate with
``mutation_steps`` RWMH steps targeting π_{β'}, the proposal scale set
per-dimension from the CURRENT particle spread (2.38/√d · σ̂ — the
Roberts-Rosenthal rule on the tempered target itself, so no user knobs).

Device shape: particles are the chain batch. Each stage is ONE jitted
program (bisection as an on-device ``lax.while_loop``, resampling as a
searchsorted gather, mutation as a ``lax.scan``); only the scalar β
crosses to the host between stages, because the NUMBER of stages is
data-dependent — the one loop that genuinely belongs on the host.

Prior/params contract ≙ ``log_evidence``: any pytree of Distributions,
``loglik_fn`` over the same structure, flat-vector machinery inside.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp

from ..utils import KeyArray, as_key
from .evidence import _flatten_prior


def _systematic_resample(key, logw, n):
    """Systematic resampling: indices ~ the categorical(w) coupling with
    one shared uniform offset — O(N), lowest-variance standard scheme."""
    w = jax.nn.softmax(logw)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, ())
    pts = (u0 + jnp.arange(n, dtype=jnp.float32)) / n
    # f32 cumsum can top out just below 1, sending the last stratified
    # points past the end — clamp explicitly rather than relying on JAX's
    # implicit out-of-range gather clamping.
    return jnp.minimum(jnp.searchsorted(cum, pts), n - 1)


def smc_sample(
    loglik_fn: Callable[[Any], jax.Array],
    prior,
    *,
    key: KeyArray,
    num_particles: int = 4096,
    target_ess_frac: float = 0.5,
    mutation_steps: int = 5,
    max_stages: int = 200,
    min_dbeta: float = 1e-5,
) -> Dict[str, Any]:
    """Run adaptive-tempering SMC from the prior to the posterior.

    Returns a dict with ``particles`` (``(N, ...)`` posterior draws in the
    prior's pytree structure — equally weighted after the final mutation),
    ``log_z`` (the SMC evidence estimate), ``betas`` (the adaptive
    schedule actually taken, ending at 1.0), ``ess_frac`` (conditional ESS
    fraction realized per stage, ≈ ``target_ess_frac`` except the last),
    ``acceptance`` (mutation acceptance per stage), and ``n_stages``.

    ``target_ess_frac`` controls the schedule resolution: each β-step is
    chosen (on-device bisection) so the incremental weights keep this
    fraction of effective particles; 0.5 is the standard default.
    ``mutation_steps`` RWMH rejuvenation steps run after every resample
    with the no-knobs 2.38/√d·σ̂ scale from the current particle spread.
    """
    if not 0.0 < target_ess_frac < 1.0:
        raise ValueError("target_ess_frac must be in (0, 1)")
    if mutation_steps < 1:
        raise ValueError("mutation_steps must be >= 1")
    N = int(num_particles)
    master = as_key(key)
    key_init, key_run = jax.random.split(master)
    draw_flat, prior_lp_flat, unravel, d = _flatten_prior(prior, master)
    loglik_b = jax.vmap(lambda v: loglik_fn(unravel(v)))
    prior_lp_b = jax.vmap(prior_lp_flat)
    log_target = math.log(target_ess_frac * N)

    def cess(dbeta, ll):
        """log ESS of the incremental weights exp(dβ·ℓ) (uniform W —
        stages resample every time, so weights enter each stage flat)."""
        a = dbeta * ll
        m = jnp.max(a)
        s1 = jax.scipy.special.logsumexp(a - m)
        s2 = jax.scipy.special.logsumexp(2.0 * (a - m))
        return 2.0 * s1 - s2  # log(‖w‖₁²/‖w‖₂²); the max shift cancels

    @jax.jit
    def pick_beta(beta, ll):
        """Largest β' ≤ 1 with ESS(exp((β'−β)ℓ)) ≥ target — 40 bisection
        trips as ONE on-device while-free fori (monotone in β')."""
        full = cess(1.0 - beta, ll) >= log_target

        def body(_, lohi):
            lo, hi = lohi
            mid = 0.5 * (lo + hi)
            ok = cess(mid - beta, ll) >= log_target
            return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

        lo, hi = jax.lax.fori_loop(
            0, 40, body, (beta, jnp.float32(1.0))
        )
        b_next = jnp.where(full, jnp.float32(1.0), lo)
        # Realized conditional-ESS fraction at the choice (returned so the
        # host loop never re-evaluates cess with eager per-op dispatches).
        return b_next, jnp.exp(cess(b_next - beta, ll)) / N

    @jax.jit
    def stage(k, x, ll, plp, beta, beta_next):
        """One SMC stage: evidence increment, systematic resample at the
        new weights, then `mutation_steps` RWMH rejuvenation steps
        targeting π_{β'} at the 2.38/√d·σ̂ scale."""
        dbeta = beta_next - beta
        logw = dbeta * ll
        # Unbiased stage increment: log mean exp(dβ·ℓ) under uniform W.
        log_z_inc = jax.scipy.special.logsumexp(logw) - math.log(N)
        k_rs, k_mut = jax.random.split(k)
        idx = _systematic_resample(k_rs, logw, N)
        x, ll, plp = x[idx], ll[idx], plp[idx]
        # No-knobs mutation scale from the CURRENT (resampled) spread.
        scale = 2.38 / math.sqrt(d) * jnp.maximum(
            jnp.std(x, axis=0), 1e-10
        )  # (d,)
        lp = plp + beta_next * ll

        def mh(carry, j):
            x, ll, plp, lp, acc = carry
            kj = jax.random.fold_in(k_mut, j)
            kp, ka = jax.random.split(kj)
            cand = x + scale * jax.random.normal(kp, x.shape, x.dtype)
            ll_c = loglik_b(cand)
            plp_c = prior_lp_b(cand)
            lp_c = plp_c + beta_next * ll_c
            a = -jax.random.exponential(ka, (N,)) < lp_c - lp
            return (
                jnp.where(a[:, None], cand, x),
                jnp.where(a, ll_c, ll),
                jnp.where(a, plp_c, plp),
                jnp.where(a, lp_c, lp),
                acc + a.astype(jnp.float32),
            ), None

        (x, ll, plp, _, acc), _ = jax.lax.scan(
            mh, (x, ll, plp, lp, jnp.zeros((N,), jnp.float32)),
            jnp.arange(mutation_steps),
        )
        return x, ll, plp, log_z_inc, jnp.mean(acc) / mutation_steps

    x = jax.vmap(draw_flat)(jax.random.split(key_init, N))  # (N, d)
    ll = loglik_b(x)
    plp = prior_lp_b(x)
    if not bool(jnp.isfinite(ll).all() & jnp.isfinite(plp).all()):
        raise ValueError(
            "smc_sample: non-finite log-likelihood or prior log-density "
            "at the initial prior draws - the ESS bisection cannot make "
            "progress. Guard the likelihood (e.g. clamp its support) "
            "before running SMC."
        )
    beta = 0.0
    log_z = 0.0
    betas, accs, ess_hist = [0.0], [], []
    for s in range(max_stages):
        beta_dev, cess_dev = pick_beta(jnp.float32(beta), ll)
        beta_next, logw_cess = float(beta_dev), float(cess_dev)
        if beta_next <= beta + min_dbeta and beta_next < 1.0:
            # Degenerate likelihood spread (e.g. huge N, tiny target ESS):
            # force minimal progress rather than stalling forever.
            beta_next = min(1.0, beta + min_dbeta)
        k_s = jax.random.fold_in(key_run, s)
        x, ll, plp, log_z_inc, acc = stage(
            k_s, x, ll, plp, jnp.float32(beta), jnp.float32(beta_next)
        )
        log_z += float(log_z_inc)
        betas.append(beta_next)
        accs.append(float(acc))
        ess_hist.append(logw_cess)
        beta = beta_next
        if beta >= 1.0:
            break
    else:
        raise RuntimeError(
            f"SMC did not reach beta=1 in {max_stages} stages "
            f"(stalled at {beta:.4g}); raise max_stages or "
            "target_ess_frac."
        )

    return {
        "particles": jax.vmap(unravel)(x),
        "log_z": log_z,
        "betas": tuple(betas),
        "ess_frac": tuple(ess_hist),
        "acceptance": tuple(accs),
        "n_stages": len(accs),
    }
