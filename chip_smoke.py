"""Smoke run of advancedmh_tpu on an NVIDIA GPU, through the public API.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

One card, at the sizes users run:

- README model (d=2, 30 obs), 16384 chains, 500 burn-in + 4000 draws:
  RWMH (scale 0.35), MALA, RobustAdaptiveMetropolis, AdaptiveHMC, ChEESHMC,
  MEADS, and emcee (``Ensemble``) with 16384 walkers. Posterior means and
  variances must match the closed form within 4·MCSE.
- Bayesian logistic regression (d=32, 256 obs), 8192 chains: RWMH, MALA,
  ChEESHMC, MEADS against a ChEESHMC reference run at ``highest`` matmul
  precision, within 4·MCSE (combined).
- The fused RWMH kernel on both targets against the XLA engine.
- ``log_evidence`` on a conjugate model (256 chains): within 3·SE (+0.02,
  the library's ladder allowance) of the closed form.
- ``sample_chunked`` with host offload (512 MiB of draws), and an exact
  512 MiB device→host transfer.
- pCN and EllipticalSlice on a d=16 Gaussian-process target against its
  closed-form posterior.

Four cards (``--four``): chain-sharded RWMH against the same run on one card
(≤2 ULP), pooled RAM and pooled AdaptiveHMC under the mesh, the
walker-sharded emcee step, and the fused kernel under ``shard_map``
(in distribution against one card).

Every phase prints one line (name, PASS/FAIL, compile s, run s,
chain-steps/s; the times are informational). The script fails, and prints
no result line, when JAX's default device is not a GPU or any phase fails.
The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

N_WARM, N_DRAWS = 500, 4000
C_README, C_LOGREG = 16384, 8192


def _header(n_cards: int):
    dev = jax.devices()[0]
    print(f"jax {jax.__version__}")
    print(f"platform {dev.platform} device_kind {dev.device_kind} "
          f"count {len(jax.devices())}", flush=True)
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    if len(jax.devices()) < n_cards:
        sys.exit(f"chip_smoke: needs {n_cards} GPUs, found "
                 f"{len(jax.devices())}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from advancedmh_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile_cache {enable_compile_cache()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)


# --- helpers -----------------------------------------------------------------


def _twice(call):
    """Run ``call(key)`` twice (keys 0 and 1); the first includes compiling.
    Returns (second result, compile s ≈ t1 − t2, run s = t2)."""
    t0 = time.perf_counter()
    jax.block_until_ready(call(0))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(call(1))
    t2 = time.perf_counter() - t0
    return out, max(t1 - t2, 0.0), t2


def _acc(res):
    return float(jnp.mean(res.transitions.accepted.astype(jnp.float32)))


def _readme_exact(model):
    """Closed-form posterior of (μ, σ) under the flat prior of the README
    model: σ² ~ InvGamma(n/2 − 1, S/2), μ | σ ~ N(x̄, σ²/n)."""
    obs, mask = (np.asarray(c, np.float64)[:, 0] for c in model.tile_consts)
    x = obs[mask > 0]
    n, xbar = x.size, x.mean()
    S = ((x - xbar) ** 2).sum()
    a, b = n / 2.0 - 1.0, S / 2.0
    e_s2 = b / (a - 1.0)
    e_s = math.sqrt(b) * math.exp(math.lgamma(a - 0.5) - math.lgamma(a))
    return np.array([xbar, e_s]), np.array([e_s2 / n, e_s2 - e_s**2])


def _line(name, ok, compile_s, run_s, chain_steps, detail):
    rate = chain_steps / run_s if run_s > 0 else float("nan")
    print(f"phase {name}: {'PASS' if ok else 'FAIL'} compile_s={compile_s:.2f} "
          f"run_s={run_s:.3f} chain_steps_per_s={rate:.4g} {detail}",
          flush=True)
    return ok


# --- one-card phases ----------------------------------------------------------


def _readme_phases():
    from advancedmh_tpu import (
        MALA, MEADS, AdaptiveHMC, ChEESHMC, Ensemble, MvNormal, Normal,
        RobustAdaptiveMetropolis, RWMH, StretchProposal, sample,
    )
    from advancedmh_tpu.diagnostics.agreement import (
        against_exact, batch_moments, chain_moments,
    )
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    mean, var = _readme_exact(model)
    # every chain / walker starts in a small ball around the posterior mean
    # (MEADS and emcee adapt from the spread of the chains)
    rng = np.random.default_rng(0)
    ball = jnp.asarray(np.abs(mean + 0.1 * rng.normal(size=(C_README, 2))),
                       jnp.float32)
    cases = [
        # name, sampler, accept band, coupled chains
        ("readme_rwmh", RWMH(MvNormal(jnp.zeros(2), scale=0.35)),
         (0.05, 0.95), False),
        ("readme_mala", MALA.langevin(0.02), (0.1, 0.98), False),
        ("readme_ram", RobustAdaptiveMetropolis(), (0.1, 0.5), False),
        ("readme_adaptive_hmc",
         AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05), (0.1, 0.99),
         False),
        ("readme_chees", ChEESHMC(), (0.2, 0.99), False),
        ("readme_meads", MEADS(), (0.5, 1.001), True),
    ]
    ok_all = True
    for name, spl, band, coupled in cases:
        res, t_c, t_r = _twice(lambda k: sample(
            model, spl, N_DRAWS, key=k, num_chains=C_README,
            num_warmup=N_WARM, discard_initial=N_WARM, initial_params=ball,
            initial_params_batched=True,
        ))
        draws = res.transitions.params  # (C, N, 2)
        m = (batch_moments(jnp.swapaxes(draws, 0, 1), mean) if coupled
             else chain_moments(draws, mean))
        good, z = against_exact(m, mean, var)
        acc = _acc(res)
        good = good and band[0] < acc < band[1]
        ok_all &= _line(
            name, good, t_c, t_r, C_README * res.schedule.total_steps,
            f"acc={acc:.4f} band={band} worst_z={z:.2f} (limit 4.0) "
            f"mean={np.round(m['mean'], 5).tolist()} "
            f"exact={np.round(mean, 5).tolist()}",
        )
        del res, draws

    # emcee: 16384 walkers from the same ball
    ens = Ensemble(C_README, StretchProposal([Normal(0.0, 1.0)] * 2))
    n_burn = 2 * N_WARM
    res, t_c, t_r = _twice(lambda k: sample(
        model, ens, N_DRAWS, key=k, discard_initial=n_burn,
        initial_params=ball,
    ))
    m = batch_moments(res.transitions.params, mean)  # (N, W, 2)
    good, z = against_exact(m, mean, var)
    acc = _acc(res)
    good = good and 0.05 < acc < 0.95
    ok_all &= _line(
        "readme_emcee", good, t_c, t_r,
        C_README * (n_burn + N_DRAWS - 1),
        f"acc={acc:.4f} band=(0.05, 0.95) worst_z={z:.2f} (limit 4.0) "
        f"mean={np.round(m['mean'], 5).tolist()}",
    )
    return ok_all


def _logreg_phases():
    from advancedmh_tpu import (
        MALA, MEADS, ChEESHMC, MvNormal, RWMH, sample,
    )
    from advancedmh_tpu.diagnostics.agreement import (
        batch_moments, chain_moments, moments_agree,
    )
    from advancedmh_tpu.models.targets import logistic_regression_model

    model = logistic_regression_model(n_obs=256, dim=32)
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        ref = jax.block_until_ready(sample(
            model, ChEESHMC(), N_DRAWS, key=100, num_chains=C_LOGREG,
            num_warmup=N_WARM, discard_initial=N_WARM,
            initial_params=jnp.zeros(32),
        ))
    ref_m = chain_moments(ref.transitions.params)
    ok_all = _line(
        "logreg_reference_chees_highest", True, 0.0,
        time.perf_counter() - t0, C_LOGREG * ref.schedule.total_steps,
        f"acc={_acc(ref):.4f} precision=highest (compile included)",
    )
    # every run below starts from the reference's final (stationary) states
    init = ref.transitions.params[:, -1]
    del ref
    cases = [
        ("logreg_rwmh", RWMH(MvNormal(jnp.zeros(32), scale=0.3)),
         (0.05, 0.95), False),
        ("logreg_mala", MALA.langevin(0.2), (0.1, 0.98), False),
        ("logreg_chees", ChEESHMC(), (0.2, 0.99), False),
        ("logreg_meads", MEADS(), (0.5, 1.001), True),
    ]
    for name, spl, band, coupled in cases:
        res, t_c, t_r = _twice(lambda k: sample(
            model, spl, N_DRAWS, key=k, num_chains=C_LOGREG,
            num_warmup=N_WARM, discard_initial=N_WARM, initial_params=init,
            initial_params_batched=True,
        ))
        draws = res.transitions.params
        m = (batch_moments(jnp.swapaxes(draws, 0, 1), ref_m["mean"])
             if coupled else chain_moments(draws, ref_m["mean"]))
        good, z = moments_agree(m, ref_m)
        acc = _acc(res)
        good = good and band[0] < acc < band[1]
        ok_all &= _line(
            name, good, t_c, t_r, C_LOGREG * res.schedule.total_steps,
            f"acc={acc:.4f} band={band} worst_z={z:.2f} (limit 4.0; "
            "default matmul precision vs highest reference)",
        )
        del res, draws
    return ok_all


def _fused_phases():
    from advancedmh_tpu import MvNormal, RWMH, sample
    from advancedmh_tpu.diagnostics.agreement import (
        chain_moments, moments_agree,
    )
    from advancedmh_tpu.models.targets import (
        gaussian_mean_scale_model, logistic_regression_model,
    )

    readme = gaussian_mean_scale_model()
    logreg = logistic_regression_model(n_obs=256, dim=32)
    ok_all = True
    for name, model, scale, C, init in (
        ("fused_rwmh_readme", readme, 0.35, C_README,
         jnp.asarray([0.0, 1.0])),
        ("fused_rwmh_logreg", logreg, 0.3, C_LOGREG,
         jnp.asarray(logreg.beta_true)),
    ):
        d = model.dimension
        spl = RWMH(MvNormal(jnp.zeros(d), scale=scale))
        kw = dict(num_chains=C, discard_initial=N_WARM, initial_params=init)
        with jax.default_matmul_precision("highest"):
            ref = sample(model, spl, N_DRAWS, key=7, **kw)
            ref_m = chain_moments(ref.transitions.params)
            acc_x = _acc(ref)
        del ref
        res, t_c, t_r = _twice(lambda k: sample(
            model, spl, N_DRAWS, key=k, engine="fused", **kw,
        ))
        m = chain_moments(res.transitions.params, ref_m["mean"])
        good, z = moments_agree(m, ref_m)
        acc = _acc(res)
        good = good and abs(acc - acc_x) < 0.01
        ok_all &= _line(
            name, good, t_c, t_r, C * res.schedule.total_steps,
            f"acc={acc:.4f} xla_acc={acc_x:.4f} (limit 0.01) "
            f"worst_z={z:.2f} (limit 4.0) precision=kernel IEEE f32, "
            "xla reference highest",
        )
        del res
    return ok_all


def _evidence_phase():
    from advancedmh_tpu import MvNormal, Normal, log_evidence

    y = np.asarray([0.8, 1.3, 0.2, 1.0, 0.6], np.float32)
    y_j = jnp.asarray(y)

    def loglik(theta):
        return jnp.sum(Normal(theta[0], 1.0).log_prob(y_j))

    n = len(y)
    cov = np.eye(n) + np.ones((n, n))
    _, logdet = np.linalg.slogdet(2.0 * np.pi * cov)
    want = float(-0.5 * (logdet + y @ np.linalg.solve(cov, y)))
    prior = MvNormal(jnp.zeros(1), scale=1.0)
    out, t_c, t_r = _twice(lambda k: log_evidence(
        loglik, prior, 3000, key=k, num_chains=256,
    ))
    err = abs(out["log_z_ss"] - want)
    lim = 3.0 * out["se_ss"] + 0.02
    K = len(out["betas"])
    return _line(
        "log_evidence", err < lim, t_c, t_r, K * 256 * 6000,
        f"log_z={out['log_z_ss']:.5f} exact={want:.5f} err={err:.5f} "
        f"limit={lim:.5f} (3·SE+0.02)",
    )


def _chunked_phase():
    from advancedmh_tpu import MvNormal, RWMH, sample, sample_chunked
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
    n = 4096  # 16384 × 4096 × 2 float32 = 512 MiB of draws
    kw = dict(key=3, num_chains=C_README, discard_initial=N_WARM,
              initial_params=jnp.asarray([0.0, 1.0]))
    t0 = time.perf_counter()
    host = sample_chunked(model, spl, n, chunk_size=1024, **kw)
    t_chunked = time.perf_counter() - t0
    dev = jax.block_until_ready(sample(model, spl, n, **kw).transitions.params)

    def checksum(words, xp):
        idx = xp.arange(1, words.size + 1, dtype=xp.uint32)
        return int(xp.sum(words.reshape(-1) * idx, dtype=xp.uint32))

    want = checksum(jax.lax.bitcast_convert_type(dev, jnp.uint32), jnp)
    t0 = time.perf_counter()
    pulled = jax.device_get(dev)
    t_get = time.perf_counter() - t0
    got = checksum(pulled.view(np.uint32), np)
    exact = want == got
    chunks_ok = np.allclose(host.transitions.params, pulled, rtol=3e-7,
                            atol=0.0)
    return _line(
        "sample_chunked_offload", exact and chunks_ok, 0.0, t_chunked,
        C_README * (N_WARM + n - 1),
        f"device_get_bytes={pulled.nbytes} device_get_s={t_get:.3f} "
        f"transfer_exact={exact} chunked_equals_unchunked={chunks_ok}",
    )


def _gp_phases():
    from advancedmh_tpu import (
        EllipticalSlice, PreconditionedCrankNicolson, sample,
    )
    from advancedmh_tpu.diagnostics.agreement import (
        against_exact, chain_moments,
    )
    from advancedmh_tpu.models import gp_latent_model

    model, prior, aux = gp_latent_model(n_points=16, likelihood="gaussian")
    mean = np.asarray(aux["post_mean"])
    cov = np.asarray(aux["post_cov"])
    var = np.diag(cov)
    C = 4096
    # chains start at exact posterior draws: an exact kernel keeps them
    # there, an inexact prior draw moves them off
    init = jnp.asarray(np.random.default_rng(1).multivariate_normal(
        mean, cov, size=C), jnp.float32)
    ok_all = True
    for name, spl, band in (
        ("gp16_pcn", PreconditionedCrankNicolson(prior, beta=0.15),
         (0.05, 0.95)),
        ("gp16_elliptical_slice", EllipticalSlice(prior), (0.99, 1.001)),
    ):
        res, t_c, t_r = _twice(lambda k: sample(
            model, spl, N_DRAWS, key=k, num_chains=C,
            discard_initial=2 * N_WARM, initial_params=init,
            initial_params_batched=True,
        ))
        m = chain_moments(res.transitions.params, mean)
        good, z = against_exact(m, mean, var)
        acc = float(jnp.mean(res.transitions.accepted[:, 1:]))
        good = good and band[0] < acc < band[1]
        ok_all &= _line(
            name, good, t_c, t_r, C * res.schedule.total_steps,
            f"acc={acc:.4f} worst_z={z:.2f} (limit 4.0, closed-form GP "
            "posterior, scale_tril draw at HIGHEST)",
        )
        del res
    return ok_all


# --- four-card phases ---------------------------------------------------------


def _four_phases():
    from advancedmh_tpu import (
        AdaptiveHMC, Ensemble, MCMCDistributed, MvNormal, Normal,
        RobustAdaptiveMetropolis, RWMH, StretchProposal, sample,
    )
    from advancedmh_tpu.diagnostics.agreement import (
        against_exact, batch_moments, chain_moments, moments_agree,
    )
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model
    from advancedmh_tpu.parallel import make_mesh
    from advancedmh_tpu.parallel.emcee import sharded_ensemble_sample

    model = gaussian_mean_scale_model()
    mean, var = _readme_exact(model)
    init = jnp.asarray([0.0, 1.0])
    mesh = make_mesh(n_devices=4, axis="chains")
    dist = MCMCDistributed(mesh=mesh)
    spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
    kw = dict(num_chains=C_README, discard_initial=N_WARM,
              initial_params=init)
    ok_all = True

    # 1. chain-sharded RWMH against the same key on one card
    one = sample(model, spl, N_DRAWS, key=11, **kw)
    one_lp = np.asarray(one.transitions.lp)
    one_x = np.asarray(one.transitions.params)
    del one
    res, t_c, t_r = _twice(lambda k: sample(
        model, spl, N_DRAWS, key=10 + k, chain_method=dist, **kw,
    ))
    shards = {s.device for s in res.transitions.params.addressable_shards}
    try:
        np.testing.assert_array_max_ulp(
            np.asarray(res.transitions.lp), one_lp, maxulp=2)
        np.testing.assert_array_max_ulp(
            np.asarray(res.transitions.params), one_x, maxulp=2)
        same = True
    except AssertionError as e:
        print(e, file=sys.stderr)
        same = False
    ok_all &= _line(
        "four_sharded_rwmh", same and len(shards) == 4, t_c, t_r,
        C_README * res.schedule.total_steps,
        f"devices={len(shards)} max_2ulp_vs_one_card={same}",
    )
    del res

    # 2. pooled RAM: one shared S, replicated and moved by adaptation
    res, t_c, t_r = _twice(lambda k: sample(
        model, RobustAdaptiveMetropolis(pooled=True), N_DRAWS, key=k,
        chain_method=dist, num_warmup=N_WARM, **kw,
    ))
    S = np.asarray(res.final_state.S)
    repl = bool((S == S[0]).all())
    moved = not np.allclose(S[0], np.eye(2))
    ok_all &= _line(
        "four_pooled_ram", repl and moved, t_c, t_r,
        C_README * res.schedule.total_steps,
        f"S_replicated={repl} S_moved={moved} acc={_acc(res):.4f}",
    )
    del res

    # 3. pooled AdaptiveHMC: one shared inverse mass, replicated
    res, t_c, t_r = _twice(lambda k: sample(
        model, AdaptiveHMC(n_leapfrog=8, initial_step_size=0.05, pooled=True),
        N_DRAWS, key=k, chain_method=dist, num_warmup=N_WARM, **kw,
    ))
    im = np.asarray(res.final_state.inverse_mass)
    repl = bool((im == im[0]).all())
    moved = not np.allclose(im[0], 1.0)
    ok_all &= _line(
        "four_pooled_adaptive_hmc", repl and moved, t_c, t_r,
        C_README * res.schedule.total_steps,
        f"inverse_mass_replicated={repl} moved={moved} acc={_acc(res):.4f}",
    )
    del res

    # 4. walker-sharded emcee (all_gather of the other half-ensemble)
    wmesh = make_mesh(n_devices=4, axis="walkers")
    ens = Ensemble(
        C_README, StretchProposal([Normal(0.0, 0.3), Normal(1.0, 0.1)])
    )
    n_burn = 2 * N_WARM
    out, t_c, t_r = _twice(lambda k: sharded_ensemble_sample(
        ens, model, n_burn + N_DRAWS, jax.random.key(k), mesh=wmesh,
    ))
    params, lp, acc = out
    n_dev = len({s.device for s in lp.addressable_shards})
    m = batch_moments(params[n_burn:], mean)  # (N, W, 2)
    good, z = against_exact(m, mean, var)
    acc = float(jnp.mean(acc.astype(jnp.float32)))
    ok_all &= _line(
        "four_sharded_emcee", good and n_dev == 4 and 0.05 < acc < 0.95,
        t_c, t_r, C_README * (n_burn + N_DRAWS),
        f"devices={n_dev} acc={acc:.4f} worst_z={z:.2f} (limit 4.0)",
    )
    del out, params, lp

    # 5. the fused kernel under shard_map, in distribution against one card.
    # Both draw the same counter stream, but a shard's smaller block compiles
    # to other last bits of the density, which can flip a rare accept.
    one = sample(model, spl, N_DRAWS, key=12, engine="fused", **kw)
    one_m = chain_moments(one.transitions.params)
    one_x = np.asarray(one.transitions.params)
    del one
    res, t_c, t_r = _twice(lambda k: sample(
        model, spl, N_DRAWS, key=11 + k, engine="fused", chain_method=dist,
        **kw,
    ))
    m = chain_moments(res.transitions.params, one_m["mean"])
    agree, z = moments_agree(m, one_m)
    same = float(np.mean(np.asarray(res.transitions.params) == one_x))
    n_dev = len({s.device for s in res.transitions.params.addressable_shards})
    ok_all &= _line(
        "four_sharded_fused_rwmh", agree and n_dev == 4, t_c, t_r,
        C_README * res.schedule.total_steps,
        f"devices={n_dev} worst_z={z:.2f} (limit 4.0, vs one card) "
        f"share_of_draws_equal_to_one_card={same:.6f}",
    )
    return ok_all


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded phases only")
    args = ap.parse_args()
    n_cards = 4 if args.four else 1
    _header(n_cards)
    groups = [_four_phases] if args.four else [
        _readme_phases, _logreg_phases, _fused_phases, _evidence_phase,
        _chunked_phase, _gp_phases,
    ]
    t0 = time.perf_counter()
    ok = True
    for group in groups:
        try:
            ok &= bool(group())
        except Exception:  # report, run the other groups, then fail
            traceback.print_exc()
            print(f"phase group {group.__name__}: FAIL (exception)",
                  flush=True)
            ok = False
    print(f"total_s {time.perf_counter() - t0:.1f}")
    if not ok:
        sys.exit("chip_smoke: a phase failed")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
