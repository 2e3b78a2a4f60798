"""Marginal-likelihood (evidence) estimation via power posteriors.

Beyond-parity subsystem (the reference has no evidence machinery; it is the
natural companion to the tempering stack, samplers/tempering.py). The
power-posterior family tempers the **likelihood only** (Friel-Pettitt 2008):

    π_β(x) ∝ p(x) · L(x)^β,     Z(0) = 1 (proper prior),  Z(1) = evidence

and two estimators are computed from the same ladder run (a third — AIS —
sweeps the ladder instead; see :func:`log_evidence_ais`):

- **Thermodynamic integration** (path sampling):
  log Z = ∫₀¹ E_β[log L] dβ, trapezoid over the rungs.
- **Stepping-stone** (Xie et al. 2011):
  log Z = Σ_k log E_{β_k}[ L^{β_{k+1}−β_k} ], each expectation a logsumexp
  over that rung's draws — consistent even with a coarse ladder (TI's
  discretization bias is one-sided; SS is the recommended estimator). A
  Monte-Carlo standard error ``se_ss`` is attached: per-chain rung
  estimates are independent (independent chains), so the delta-method SE of
  each rung's log-ratio is the between-chain spread of the normalized
  per-chain weights, and rung SEs add in quadrature (Xie 2011 §SE, adapted
  to the many-independent-chains setting).

Device formulation: the whole ladder runs as ONE flat chain batch — rung k
contributes ``num_chains`` chains whose density closes over a per-chain β
vector, so K rungs × C chains is a single batched MH kernel under one
``lax.scan`` (no Python loop over rungs, no replica swaps needed: rungs are
independent targets here, and the β-ladder's mixing aid is irrelevant
because every rung starts from the prior and burns in independently).

Proposal scaling: hot rungs (β → 1) concentrate like the posterior while
cold rungs stay prior-wide; one global scale is wrong somewhere on the
ladder. ``proposal_scale="auto"`` (default) runs per-chain dual averaging
(Hoffman-Gelman 2014 §3.2 — the same scheme as samplers/adapt.py) toward
0.234 during burn-in and freezes each chain's averaged scale for the
estimation phase. Scalar and per-rung sequences are also accepted. Rungs
whose realized acceptance is still degenerate trigger a loud warning.

Params may be a flat vector OR any pytree: pass a *pytree of
Distributions* as the prior (dict/tuple/nested — mirrors the proposal
algebra) and ``loglik_fn`` receives params in that same pytree structure;
internally everything runs on the raveled flat vector.

The default ladder β_k = (k/(K−1))^5 concentrates rungs near β=0 where
E_β[log L] changes fastest (the Xie/Friel recommendation).
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, Dict, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree

from ..distributions import Distribution
from ..utils import KeyArray, as_key


def power_ladder(n_rungs: int = 16, c: float = 5.0):
    """β_k = (k/(K−1))^c, k = 0..K−1 — rungs concentrated near the prior."""
    return tuple((k / (n_rungs - 1.0)) ** c for k in range(n_rungs))


def _is_dist(x) -> bool:
    return isinstance(x, Distribution)


def _flatten_prior(prior, key_proto):
    """A prior pytree of Distributions → flat-vector machinery.

    Returns ``(draw_flat(key) -> (d,), prior_lp_flat((d,)) -> (), unravel,
    d)``. A single Distribution over vectors is the 1-leaf case: ravel of an
    array is the array itself, so ``loglik_fn`` keeps seeing plain vectors.
    """
    leaves, treedef = jax.tree_util.tree_flatten(prior, is_leaf=_is_dist)
    if not leaves or not all(_is_dist(leaf) for leaf in leaves):
        raise TypeError(
            "prior must be a Distribution or a pytree of Distributions "
            "(each needs .sample and .log_prob)"
        )
    proto = treedef.unflatten(
        [
            leaf.sample(k)
            for leaf, k in zip(leaves, jax.random.split(key_proto, len(leaves)))
        ]
    )
    flat0, unravel = ravel_pytree(proto)
    d = int(flat0.shape[0])

    def draw_flat(k):
        ks = jax.random.split(k, len(leaves))
        tree = treedef.unflatten(
            [leaf.sample(kk) for leaf, kk in zip(leaves, ks)]
        )
        return ravel_pytree(tree)[0]

    def prior_lp_flat(v):
        tree = unravel(v)
        vals = treedef.flatten_up_to(tree)
        return sum(
            jnp.sum(leaf.log_prob(x)) for leaf, x in zip(leaves, vals)
        )

    return draw_flat, prior_lp_flat, unravel, d


def _evidence_estimates(
    lls, acc_np, scales, betas_t, n_samples, C, min_acceptance,
    stacklevel: int = 3,
) -> Dict[str, Any]:
    """Stepping-stone + TI estimates from rung draws ``lls (N, K, C)``.

    Runs on the HOST in float64: the draws are f32 device output, but the
    logsumexp chain accumulates K·N·C transcendentals — on-device f32
    exp/log at a few ULP leaves ~5e-4 of noise on log Z, visible against
    the exact-zero flat-likelihood contract and needlessly inflating the
    SE-vs-bias margin. The pull routes through ``utils.safe_device_get``
    (sliced ≤64 MB transfers + element verification)."""
    from ..utils import safe_device_get

    lls = np.asarray(safe_device_get(lls), np.float64)
    betas_arr = np.asarray(betas_t, np.float64)
    mean_ll = lls.mean(axis=(0, 2))  # (K,) E_β[log L]
    # TI: trapezoid over the ladder
    log_z_ti = float(np.sum(
        0.5 * (mean_ll[1:] + mean_ll[:-1]) * np.diff(betas_arr)
    ))

    def lse(a, axis):
        mx = np.max(a, axis=axis, keepdims=True)
        out = mx.squeeze(axis) + np.log(
            np.sum(np.exp(a - mx), axis=axis)
        )
        return out

    # Stepping-stone: Σ_k logmeanexp((β_{k+1}−β_k)·ℓ_k) over rung-k draws
    db = np.diff(betas_arr).reshape(-1, 1, 1)  # (K-1, 1, 1)
    rung_draws = lls[:, :-1, :].transpose(1, 0, 2)  # (K-1, N, C)
    # per-chain log-mean-exp (chains are independent → SE from their spread)
    m_kc = lse(db * rung_draws, axis=1) - math.log(n_samples)  # (K-1, C)
    m_k = lse(m_kc, axis=1) - math.log(C)  # (K-1,)
    log_z_ss = float(np.sum(m_k))
    # delta method: SE(log r̂_k) ≈ sd_c(w̃)/√C with w̃ = exp(m_kc − m_k)
    # (mean-1 normalized per-chain weights); rungs independent ⇒ quadrature.
    w = np.exp(m_kc - m_k[:, None])
    se_k = w.std(axis=1, ddof=1) / math.sqrt(C)
    se_ss = float(np.sqrt(np.sum(se_k**2)))

    bad = np.nonzero(acc_np < min_acceptance)[0]
    if bad.size:
        warnings.warn(
            f"log_evidence: ladder rungs {bad.tolist()} (β = "
            f"{[round(betas_t[i], 4) for i in bad.tolist()]}) have acceptance "
            f"{[round(float(acc_np[i]), 3) for i in bad.tolist()]} < "
            f"{min_acceptance}; their stepping-stone factors come from "
            "near-frozen chains and may bias log Z. Increase n_samples, use "
            "proposal_scale='auto', or refine the ladder.",
            UserWarning,
            stacklevel=stacklevel,
        )

    return {
        "log_z_ss": float(log_z_ss),
        "se_ss": se_ss,
        "log_z_ti": float(log_z_ti),
        "betas": betas_t,
        "mean_loglik": np.asarray(mean_ll),
        "acceptance": acc_np,
        "proposal_scales": scales,
    }


def log_evidence(
    loglik_fn: Callable[[Any], jax.Array],
    prior,
    n_samples: int,
    *,
    key: KeyArray,
    betas: Optional[Sequence[float]] = None,
    num_chains: int = 64,
    proposal_scale: Union[str, float, Sequence[float]] = "auto",
    discard_initial: Optional[int] = None,
    target_accept: float = 0.234,
    min_acceptance: float = 0.1,
    d: Optional[int] = None,  # kept for API compat; inferred from the prior
) -> Dict[str, Any]:
    """Estimate log Z = log ∫ p(x) L(x) dx.

    ``loglik_fn`` — log-likelihood over a params pytree (flat vector, or
    whatever structure the prior pytree produces); ``prior`` — a
    :class:`Distribution` or pytree of Distributions (the proper prior p).
    Each ladder rung runs ``num_chains`` RWMH chains on p(x)·L(x)^{β_k};
    every chain starts at a prior draw and burns ``discard_initial`` steps
    (default ``n_samples``).

    ``proposal_scale``: ``"auto"`` (default — per-chain dual averaging to
    ``target_accept`` during burn-in, frozen after), a scalar, or a
    per-rung sequence of length ``len(betas)``.

    Returns a dict with ``log_z_ss`` (stepping-stone — use this), ``se_ss``
    (its Monte-Carlo standard error), ``log_z_ti`` (thermodynamic
    integration, trapezoid), the ladder ``betas``, per-rung
    ``mean_loglik``, ``acceptance``, and ``proposal_scales`` (per-rung
    median of the scales actually used). Any rung with acceptance below
    ``min_acceptance`` raises a ``UserWarning`` — its stepping-stone factor
    is built from a frozen chain and may silently bias log Z.
    """
    if betas is None:
        betas = power_ladder()
    betas_t = tuple(float(b) for b in betas)
    if betas_t != tuple(sorted(betas_t)) or betas_t[0] != 0.0 or betas_t[-1] != 1.0:
        raise ValueError(
            "betas must ascend from 0.0 (prior) to 1.0 (posterior); "
            "use power_ladder() for the default schedule."
        )
    K = len(betas_t)
    C = num_chains
    B = K * C
    burn = n_samples if discard_initial is None else int(discard_initial)
    master = as_key(key)
    key_init, key_run = jax.random.split(master)

    draw_flat, prior_lp_flat, unravel, d = _flatten_prior(prior, master)

    # flat (B,) β vector: rung k occupies chains [k*C, (k+1)*C)
    beta_vec = jnp.repeat(jnp.asarray(betas_t, jnp.float32), C)

    loglik_b = jax.vmap(lambda v: loglik_fn(unravel(v)))
    prior_lp_b = jax.vmap(prior_lp_flat)

    def density_batched(xs):  # (B, d) -> (B,)
        return prior_lp_b(xs) + beta_vec * loglik_b(xs)

    x0 = jax.vmap(draw_flat)(jax.random.split(key_init, B))  # (B, d)

    # -- proposal scales ----------------------------------------------------
    adapt = proposal_scale == "auto"
    if adapt:
        eps0 = jnp.full((B,), 0.5, jnp.float32)
    elif isinstance(proposal_scale, str):
        raise ValueError(f"unknown proposal_scale: {proposal_scale!r}")
    else:
        ps = jnp.asarray(proposal_scale, jnp.float32)
        if ps.ndim == 0:
            eps0 = jnp.full((B,), ps)
        elif ps.shape == (K,):
            eps0 = jnp.repeat(ps, C)  # per-rung scales
        else:
            raise ValueError(
                f"proposal_scale must be 'auto', a scalar, or a length-{K} "
                f"per-rung sequence; got shape {ps.shape}"
            )

    # Dual-averaging constants (HG14 §3.2; ≙ samplers/adapt.py defaults).
    t0_da, kappa, gamma = 10.0, 0.75, 0.05
    mu_da = jnp.log(10.0 * eps0)

    def mh_step(kj, x, lp, eps):
        kp, ka = jax.random.split(kj)
        cand = x + eps[:, None] * jax.random.normal(kp, x.shape, x.dtype)
        lp_cand = density_batched(cand)
        acc = -jax.random.exponential(ka, (B,)) < lp_cand - lp
        x = jnp.where(acc[:, None], cand, x)
        lp = jnp.where(acc, lp_cand, lp)
        return x, lp, acc

    @jax.jit
    def run(x0):
        lp0 = density_batched(x0)
        zero = jnp.zeros((B,), jnp.float32)

        def warm_body(carry, j):
            x, lp, log_eps, log_eps_bar, h_bar = carry
            x, lp, acc = mh_step(
                jax.random.fold_in(key_run, j), x, lp, jnp.exp(log_eps)
            )
            if adapt:
                t = (j + 1).astype(jnp.float32)
                w = 1.0 / (t + t0_da)
                h_bar = (1.0 - w) * h_bar + w * (
                    target_accept - acc.astype(jnp.float32)
                )
                log_eps = mu_da - jnp.sqrt(t) / gamma * h_bar
                eta = jnp.power(t, -kappa)
                log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
            return (x, lp, log_eps, log_eps_bar, h_bar), None

        carry = (x0, lp0, jnp.log(eps0), jnp.log(eps0), zero)
        carry, _ = jax.lax.scan(warm_body, carry, jnp.arange(burn))
        x, lp, _, log_eps_bar, _ = carry
        eps_final = jnp.exp(log_eps_bar) if adapt else eps0

        def body2(carry, j):
            x, lp = carry
            x, lp, acc = mh_step(
                jax.random.fold_in(key_run, burn + j), x, lp, eps_final
            )
            return (x, lp), (loglik_b(x), acc)

        _, (lls, accs) = jax.lax.scan(body2, (x, lp), jnp.arange(n_samples))
        return lls, accs, eps_final  # (N, B), (N, B), (B,)

    lls, accs, eps_final = run(x0)
    lls = lls.reshape(n_samples, K, C)
    acc = accs.reshape(n_samples, K, C).mean(axis=(0, 2))  # (K,)
    scales = np.median(
        np.asarray(eps_final).reshape(K, C), axis=1
    )  # (K,)
    return _evidence_estimates(
        lls, np.asarray(acc), scales, betas_t, n_samples, C,
        min_acceptance,
    )


def log_evidence_ais(
    loglik_fn: Callable[[Any], jax.Array],
    prior,
    *,
    key: KeyArray,
    betas: Optional[Sequence[float]] = None,
    num_chains: int = 1024,
    n_steps_per_rung: int = 4,
    proposal_scale: Union[str, float, Sequence[float]] = "auto",
    n_pilot: int = 200,
    target_accept: float = 0.234,
    min_acceptance: float = 0.05,
) -> Dict[str, Any]:
    """Annealed importance sampling (Neal 2001) estimate of log Z.

    The third evidence estimator, complementing :func:`log_evidence`'s TI and
    stepping-stone: every chain *sweeps* the ladder prior → posterior,
    accumulating the incremental importance weight

        w += (β_k − β_{k−1}) · log L(x)     (x ~ π_{β_{k−1}})

    then moves under ``n_steps_per_rung`` RWMH transitions targeting
    π_{β_k}. ``log Z = logmeanexp(w)`` is unbiased in Ẑ for ANY ladder and
    ANY number of inner steps — bad tuning widens the weight spread (visible
    in the returned ``ess_weights``) but never biases the estimator, unlike
    a frozen stepping-stone rung. Device shape: one ``lax.scan`` over rungs ×
    ``num_chains`` vmapped sweeps; inner transitions are a nested scan with
    absolute-iteration keys.

    ``proposal_scale="auto"`` (default) runs a *pilot* flat ladder batch
    (``n_pilot`` steps of per-chain dual averaging, exactly the
    :func:`log_evidence` scheme) to freeze one scale per rung BEFORE the
    measured sweep — scales fixed ahead of the run keep AIS exact. Scalar
    and per-rung sequences are also accepted.

    Returns ``log_z_ais``, ``se_ais`` (delta-method SE from the independent-
    chain weight spread), ``ess_weights`` (Kish effective sample size of the
    normalized weights), ``betas``, per-rung ``acceptance``, and
    ``proposal_scales``. Low acceptance on a rung only *inflates* the weight
    spread (unlike stepping-stone bias) but still warns below
    ``min_acceptance``.
    """
    if betas is None:
        betas = power_ladder(32)
    betas_t = tuple(float(b) for b in betas)
    if betas_t != tuple(sorted(betas_t)) or betas_t[0] != 0.0 or betas_t[-1] != 1.0:
        raise ValueError(
            "betas must ascend from 0.0 (prior) to 1.0 (posterior); "
            "use power_ladder() for the default schedule."
        )
    if n_steps_per_rung < 1:
        raise ValueError("n_steps_per_rung must be >= 1")
    K = len(betas_t)
    C = num_chains
    T = int(n_steps_per_rung)
    master = as_key(key)
    key_init, key_pilot, key_run = jax.random.split(master, 3)

    draw_flat, prior_lp_flat, unravel, d = _flatten_prior(prior, master)
    loglik_b = jax.vmap(lambda v: loglik_fn(unravel(v)))
    prior_lp_b = jax.vmap(prior_lp_flat)
    betas_arr = jnp.asarray(betas_t, jnp.float32)

    # -- per-rung proposal scales (frozen BEFORE the measured sweep) --------
    if proposal_scale == "auto":
        # pilot: the log_evidence flat-batch trick — K rungs × Cp chains
        # dual-average per chain, freeze the per-rung median.
        Cp = min(64, C)
        B = K * Cp
        beta_vec = jnp.repeat(betas_arr, Cp)
        x0p = jax.vmap(draw_flat)(jax.random.split(key_pilot, B))
        t0_da, kappa, gamma = 10.0, 0.75, 0.05
        eps0 = jnp.full((B,), 0.5, jnp.float32)
        mu_da = jnp.log(10.0 * eps0)

        @jax.jit
        def pilot(x0):
            lp0 = prior_lp_b(x0) + beta_vec * loglik_b(x0)

            def body(carry, j):
                x, lp, log_eps, leb, h_bar = carry
                kj = jax.random.fold_in(key_pilot, j)
                kp, ka = jax.random.split(kj)
                eps = jnp.exp(log_eps)
                cand = x + eps[:, None] * jax.random.normal(kp, x.shape, x.dtype)
                lp_cand = prior_lp_b(cand) + beta_vec * loglik_b(cand)
                acc = -jax.random.exponential(ka, (B,)) < lp_cand - lp
                x = jnp.where(acc[:, None], cand, x)
                lp = jnp.where(acc, lp_cand, lp)
                t = (j + 1).astype(jnp.float32)
                w = 1.0 / (t + t0_da)
                h_bar = (1.0 - w) * h_bar + w * (
                    target_accept - acc.astype(jnp.float32)
                )
                log_eps = mu_da - jnp.sqrt(t) / gamma * h_bar
                eta = jnp.power(t, -kappa)
                leb = eta * log_eps + (1.0 - eta) * leb
                return (x, lp, log_eps, leb, h_bar), None

            carry = (x0, lp0, jnp.log(eps0), jnp.log(eps0),
                     jnp.zeros((B,), jnp.float32))
            carry, _ = jax.lax.scan(body, carry, jnp.arange(n_pilot))
            return jnp.exp(carry[3])

        eps_k = jnp.median(pilot(x0p).reshape(K, Cp), axis=1)  # (K,)
    elif isinstance(proposal_scale, str):
        raise ValueError(f"unknown proposal_scale: {proposal_scale!r}")
    else:
        ps = jnp.asarray(proposal_scale, jnp.float32)
        if ps.ndim == 0:
            eps_k = jnp.full((K,), ps)
        elif ps.shape == (K,):
            eps_k = ps
        else:
            raise ValueError(
                f"proposal_scale must be 'auto', a scalar, or a length-{K} "
                f"per-rung sequence; got shape {ps.shape}"
            )

    # -- the measured AIS sweep --------------------------------------------
    x0 = jax.vmap(draw_flat)(jax.random.split(key_init, C))  # (C, d)

    @jax.jit
    def sweep(x0, eps_k):
        ll0 = loglik_b(x0)
        plp0 = prior_lp_b(x0)
        w0 = jnp.zeros((C,), jnp.float32)

        # scan over rungs k = 1..K-1: weight increment uses the CURRENT
        # x ~ π_{β_{k-1}}, then T transitions re-equilibrate at β_k.
        def rung(carry, xs):
            x, plp, ll, w = carry
            k, beta, dbeta, eps = xs
            w = w + dbeta * ll
            lp = plp + beta * ll

            def step(t, carry):
                x, plp, ll, lp = carry
                kj = jax.random.fold_in(key_run, k * T + t)
                kp, ka = jax.random.split(kj)
                cand = x + eps * jax.random.normal(kp, x.shape, x.dtype)
                plp_c = prior_lp_b(cand)
                ll_c = loglik_b(cand)
                lp_c = plp_c + beta * ll_c
                acc = -jax.random.exponential(ka, (C,)) < lp_c - lp
                x = jnp.where(acc[:, None], cand, x)
                plp = jnp.where(acc, plp_c, plp)
                ll = jnp.where(acc, ll_c, ll)
                lp = jnp.where(acc, lp_c, lp)
                return x, plp, ll, lp, acc

            accs = jnp.zeros((C,), jnp.float32)
            def body(t, c):
                x, plp, ll, lp, accs = c
                x, plp, ll, lp, acc = step(t, (x, plp, ll, lp))
                return x, plp, ll, lp, accs + acc.astype(jnp.float32)

            x, plp, ll, lp, accs = jax.lax.fori_loop(
                0, T, body, (x, plp, ll, lp, accs)
            )
            return (x, plp, ll, w), jnp.mean(accs) / T

        xs = (
            jnp.arange(1, K),
            betas_arr[1:],
            betas_arr[1:] - betas_arr[:-1],
            eps_k[1:],
        )
        (x, _, _, w), acc = jax.lax.scan(rung, (x0, plp0, ll0, w0), xs)
        return w, acc  # (C,), (K-1,)

    w, acc = sweep(x0, eps_k)
    log_z = float(jax.scipy.special.logsumexp(w) - math.log(C))
    # delta method: Ẑ = mean(exp w) ⇒ SE(log Ẑ) ≈ sd(w̃)/√C with
    # w̃ = exp(w − log Ẑ) the mean-1 normalized weights.
    wt = np.exp(np.asarray(w, np.float64) - log_z)
    se = float(wt.std(ddof=1) / math.sqrt(C))
    ess_w = float(wt.sum() ** 2 / (wt**2).sum())  # Kish ESS

    acc_np = np.asarray(acc)
    bad = np.nonzero(acc_np < min_acceptance)[0]
    if bad.size:
        warnings.warn(
            f"log_evidence_ais: ladder rungs {(bad + 1).tolist()} (β = "
            f"{[round(betas_t[i + 1], 4) for i in bad.tolist()]}) have "
            f"acceptance {[round(float(a), 3) for a in acc_np[bad]]} < "
            f"{min_acceptance}; AIS stays unbiased but the weight spread "
            "grows — check ess_weights, and increase n_steps_per_rung or "
            "refine the ladder.",
            UserWarning,
            stacklevel=2,
        )

    return {
        "log_z_ais": log_z,
        "se_ais": se,
        "ess_weights": ess_w,
        "betas": betas_t,
        "acceptance": acc_np,
        "proposal_scales": np.asarray(eps_k),
    }
