"""Bayesian logistic regression throughput: the matmul-density target.

The flagship 2-param Gaussian density is elementwise; this benchmark
measures the d=32, 256-observation logistic posterior whose likelihood is a
matmul (models/targets.py::logistic_regression_model), on the XLA engine
(``(C, d) @ (d, n)`` per step) and in the fused RWMH kernel (``X (n, d) @
β (d, TC)`` per block), plus a d=128 fused row. Reports chain-steps/s and
density-GFLOP/s (2·n·d flops per density eval). Every timing ends in
``jax.block_until_ready``; the first call of each row compiles and is not
timed.

Run on a GPU: `python benchmarks/logreg.py`.
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time
from functools import partial

import jax
import jax.numpy as jnp

from advancedmh_tpu.utils.compile_cache import enable_compile_cache

N_CHAINS = 8192
N_OBS = 256
DIM = 32
N_STEPS = 2000
SCALE = 0.3


def _best(go, n_trials=3):
    jax.block_until_ready(go())  # compile
    best = float("inf")
    for _ in range(n_trials):
        t0 = time.perf_counter()
        jax.block_until_ready(go())
        best = min(best, time.perf_counter() - t0)
    return best


def _model(dim=DIM):
    from advancedmh_tpu.models.targets import logistic_regression_model

    return logistic_regression_model(n_obs=N_OBS, dim=dim)


def bench_fused_rwmh(model, dim=DIM, scale=SCALE):
    from advancedmh_tpu.ops import fused_rwmh_sample
    from advancedmh_tpu.runtime.fused import launch_shape

    _, launch = launch_shape(N_CHAINS, dim)
    run = fused_rwmh_sample(
        model.tile_density, dim, scale, 1, burn=N_STEPS - 1,
        consts=model.tile_consts, **launch,
    )
    params = jnp.zeros((dim, N_CHAINS), jnp.float32)
    lp0 = model.tile_density(params, *map(jnp.asarray, model.tile_consts))
    ctl = jnp.asarray([0, 1, 0, 0], jnp.uint32)
    best = _best(lambda: run(params, lp0, ctl))
    return N_CHAINS * N_STEPS / best


def bench_fused_rwmh_d128(model_unused):
    """d=128: four times the density FLOPs per step of the d=32 row."""
    return bench_fused_rwmh(_model(128), dim=128, scale=SCALE / 2)


def bench_xla_rwmh(model):
    from advancedmh_tpu import MvNormal, RWMH, Transition

    spl = RWMH(MvNormal(jnp.zeros(DIM), scale=SCALE))
    master = jax.random.key(0)

    @partial(jax.jit, static_argnums=2)
    def run(params, lp, n):
        state = Transition(params, lp, jnp.zeros((N_CHAINS,), bool))

        def body(state, j):
            _, s = spl.step_batched(
                jax.random.fold_in(master, j), state, model, (N_CHAINS,)
            )
            return s, None

        state, _ = jax.lax.scan(body, state, jnp.arange(n))
        return state.params, state.lp

    params = jnp.zeros((N_CHAINS, DIM), jnp.float32)
    lp = model.logdensity_batched_fn(params)
    best = _best(lambda: run(params, lp, N_STEPS))
    return N_CHAINS * N_STEPS / best


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"benchmarks/logreg.py needs a GPU, found {dev.platform!r}")
    enable_compile_cache()
    print(json.dumps({"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}))
    model = _model()
    out = {}
    for name, fn in [
        ("xla_rwmh", bench_xla_rwmh),
        ("fused_rwmh", bench_fused_rwmh),
        ("fused_rwmh_d128", bench_fused_rwmh_d128),
    ]:
        r = fn(model)
        fpe = 2 * N_OBS * (128 if name.endswith("d128") else DIM)
        out[name] = {"chain_steps_per_s": r, "density_gflops": r * fpe / 1e9}
        print(json.dumps({name: out[name]}), flush=True)
    print(json.dumps({
        "metric": "logreg_d32_chain_steps_per_s",
        "chains": N_CHAINS, "dim": DIM, "n_obs": N_OBS,
        **{k: v["chain_steps_per_s"] for k, v in out.items()},
    }))


if __name__ == "__main__":
    main()
