"""Per-sampler throughput on the local accelerator.

Measures steady-state chain-steps/s (or walker-steps/s for emcee) of each
sampler's hot loop under `lax.scan`, with compile excluded (warmup uses the
same static step count as the timed run).
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from advancedmh_tpu.utils.compile_cache import enable_compile_cache


def _time_scan(step, state, n):
    @partial(jax.jit, static_argnums=1)
    def run(state, n):
        def body(s, j):
            return step(j, s), None

        s, _ = jax.lax.scan(body, state, jnp.arange(n))
        return s

    def go():
        return jax.block_until_ready(run(state, n))

    go()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        go()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_rwmh(C=16384, n=4000):
    from advancedmh_tpu import MvNormal, RWMH, Transition
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = RWMH(MvNormal(jnp.zeros(2), scale=0.1))
    master = jax.random.key(0)
    params = jnp.tile(jnp.asarray([0.0, 1.0], jnp.float32), (C, 1))
    state = Transition(params, jax.vmap(model.logdensity_fn)(params),
                       jnp.zeros((C,), bool))
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_mala(C=16384, n=4000):
    from advancedmh_tpu import MALA, MvNormal
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    s2 = 1e-3
    spl = MALA(lambda g: MvNormal(s2 / 2.0 * g, scale=jnp.sqrt(s2)))
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_ram_warmup(C=16384, n=2000, d=2):
    from advancedmh_tpu import RobustAdaptiveMetropolis
    from advancedmh_tpu.models.targets import correlated_gaussian_model

    cov = np.eye(d, dtype=np.float32)
    cov[0, 1] = cov[1, 0] = 0.5
    model = correlated_gaussian_model(cov)
    spl = RobustAdaptiveMetropolis()
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.zeros(d))
    ))(keys)
    step = lambda j, s: spl.step_warmup_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_adapt_rwmh(C=16384, n=4000):
    """StepSizeAdaptation-wrapped RWMH on the batched warmup kernel: the
    dual-averaging update is ~5 elementwise ops per chain on top of the
    plain RWMH step, so the target is within ~10% of bench_rwmh."""
    from advancedmh_tpu import StepSizeAdaptation
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = StepSizeAdaptation.rwmh(2, initial_step_size=0.1)
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_warmup_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_mtm(C=16384, n=1000, k=4):
    from advancedmh_tpu import (
        MultipleTryMetropolis, MvNormal, RandomWalkProposal, Transition,
    )
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = MultipleTryMetropolis(
        RandomWalkProposal(MvNormal(jnp.zeros(2), scale=0.2)), k=k
    )
    master = jax.random.key(0)
    params = jnp.tile(jnp.asarray([0.0, 1.0], jnp.float32), (C, 1))
    state = Transition(params, jax.vmap(model.logdensity_fn)(params),
                       jnp.zeros((C,), bool))
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_am(C=16384, n=2000):
    from advancedmh_tpu import AdaptiveMetropolis
    from advancedmh_tpu.models.targets import correlated_gaussian_model

    model = correlated_gaussian_model(
        jnp.asarray([[1.5, 0.35], [0.35, 1.0]])
    )
    spl = AdaptiveMetropolis()
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(
        jax.vmap(lambda k: spl.init(k, model, jnp.zeros(2)))
    )(keys)
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_barker(C=16384, n=4000):
    from advancedmh_tpu import Barker
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = Barker(step_size=0.05)
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_emcee(W=16384, n=2000):
    from advancedmh_tpu import Ensemble, InverseGamma, Normal, StretchProposal
    from advancedmh_tpu.models.targets import emcee_demo_model

    model = emcee_demo_model()
    spl = Ensemble(W, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))
    master = jax.random.key(0)
    _, state = jax.jit(lambda k: spl.init(k, model))(master)
    step = lambda j, s: spl.step(jax.random.fold_in(master, j), s, model)[1]
    return W * n / _time_scan(step, state, n)


def bench_dr(C=16384, n=2000):
    from advancedmh_tpu import DelayedRejection, MvNormal, RandomWalkProposal, Transition
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = DelayedRejection(
        RandomWalkProposal(MvNormal(jnp.zeros(2), scale=0.5), symmetric=True),
        RandomWalkProposal(MvNormal(jnp.zeros(2), scale=0.1), symmetric=True),
    )
    master = jax.random.key(0)
    params = jnp.tile(jnp.asarray([0.0, 1.0], jnp.float32), (C, 1))
    state = Transition(params, jax.vmap(model.logdensity_fn)(params),
                       jnp.zeros((C,), bool))
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_dram(C=16384, n=2000):
    from advancedmh_tpu import DRAM
    from advancedmh_tpu.models.targets import correlated_gaussian_model

    model = correlated_gaussian_model(
        jnp.asarray([[1.5, 0.35], [0.35, 1.0]])
    )
    spl = DRAM()
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(
        jax.vmap(lambda k: spl.init(k, model, jnp.zeros(2)))
    )(keys)
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_pcn(C=16384, n=4000):
    from advancedmh_tpu import Normal, PreconditionedCrankNicolson, Transition
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    # likelihood-only target: prior N(0,1) on both params via the sampler
    model = gaussian_mean_scale_model()
    spl = PreconditionedCrankNicolson(
        Normal(0.0, 1.0), beta=0.2
    )
    master = jax.random.key(0)
    params = jnp.tile(jnp.asarray([0.0, 1.0], jnp.float32), (C, 1))
    state = Transition(params, jax.vmap(model.logdensity_fn)(params),
                       jnp.zeros((C,), bool))
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_demc(M=16384, n=2000):
    from advancedmh_tpu import DifferentialEvolution, InverseGamma, Normal
    from advancedmh_tpu.models.targets import emcee_demo_model

    model = emcee_demo_model()
    spl = DifferentialEvolution(
        M, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]
    )
    master = jax.random.key(0)
    _, state = jax.jit(lambda k: spl.init(k, model))(master)
    step = lambda j, s: spl.step(jax.random.fold_in(master, j), s, model)[1]
    return M * n / _time_scan(step, state, n)


def bench_hmc(C=16384, n=1000, L=5):
    """XLA batched HMC: L leapfrog steps (L+0 value_and_grad evals) per
    chain-step — reported in chain-steps/s (multiply by L for grad-evals)."""
    from advancedmh_tpu import HamiltonianMC
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = HamiltonianMC(0.05, L)
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_adaptive_hmc(C=16384, n=1000, L=5):
    """XLA batched AdaptiveHMC warmup step: HMC trajectory + dual-averaging
    + Welford mass update per step (the adaptation overhead should be
    invisible next to L gradient evals)."""
    from advancedmh_tpu import AdaptiveHMC
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = AdaptiveHMC(n_leapfrog=L, initial_step_size=0.05)
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_warmup_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def bench_chees(C=16384, n=500):
    """XLA batched ChEES-HMC warmup: one shared jittered trajectory (traced
    while_loop) + Adam/dual-averaging/pooled-Welford updates per step.
    Reported in chain-steps/s; per-step gradient evals vary with the
    adapted L (the while_loop trip count)."""
    from advancedmh_tpu import ChEESHMC
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model

    model = gaussian_mean_scale_model()
    spl = ChEESHMC(initial_step_size=0.05, initial_trajectory_length=0.25,
                   max_leapfrog=16)
    master = jax.random.key(0)
    keys = jax.random.split(master, C)
    _, state = jax.jit(jax.vmap(
        lambda k: spl.init(k, model, jnp.asarray([0.0, 1.0]))
    ))(keys)
    step = lambda j, s: spl.step_warmup_batched(
        jax.random.fold_in(master, j), s, model, (C,)
    )[1]
    return C * n / _time_scan(step, state, n)


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"benchmarks/samplers.py needs a GPU, found {dev.platform!r}")
    enable_compile_cache()
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}))
    out = {}
    for name, fn in [
        ("rwmh", bench_rwmh),
        ("mala", bench_mala),
        ("ram_warmup", bench_ram_warmup),
        ("adapt_rwmh", bench_adapt_rwmh),
        ("emcee", bench_emcee),
        ("demc", bench_demc),
        ("dr", bench_dr),
        ("dram", bench_dram),
        ("pcn", bench_pcn),
        ("mtm", bench_mtm),
        ("am", bench_am),
        ("barker", bench_barker),
        ("hmc", bench_hmc),
        ("adaptive_hmc", bench_adaptive_hmc),
        ("chees", bench_chees),
    ]:
        out[name] = fn()
        unit = ("walker-steps" if "emcee" in name else
                "member-steps" if "demc" in name else "chain-steps")
        print(f"{name}: {out[name]/1e6:.1f} M {unit}/s", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
