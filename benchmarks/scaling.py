"""Sharding-overhead harness: constant total width across mesh sizes.

≙ SURVEY.md §7.7's scaling check, reshaped for a CPU-only host: virtual
CPU devices share one host's cores, so weak-scaling
"efficiency" ratios are meaningless here (a prior table read 1.5 at 2
devices and 0.79-1.05 at 8 — pure core-contention noise). What a shared-
core mesh CAN measure honestly is the GSPMD/sharding-annotation overhead
at CONSTANT total work: fix the total chain count and step count, run the
identical program as plain vmap and as a 1/2/4/8-device sharded mesh, and
report each width's throughput deficit vs vmap. On real cards the chains
axis is embarrassingly parallel (zero hot-loop collectives), so this
overhead is the only program-side cost of sharding.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/scaling.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import time

import jax
import jax.numpy as jnp


def measure(num_devices: int, total_chains: int = 16384, n_steps: int = 2000):
    """Steady-state chain-steps/s at a FIXED total chain count.
    ``num_devices=0`` measures the plain vmap path (no mesh, no sharding
    constraints); ``num_devices=n`` shards the same batch over an n-wide
    chains mesh — the deficit vs vmap is the pure GSPMD/sharding overhead.

    The jitted program is built ONCE and the timed calls replay the compiled
    executable — calling the ``sample()`` front-end per trial would re-trace
    every time and the measurement would be compile-dominated. Every timed
    call ends in ``jax.block_until_ready``."""
    from advancedmh_tpu import MvNormal, RWMH
    from advancedmh_tpu.models.targets import gaussian_mean_scale_model
    from advancedmh_tpu.parallel import chain_sharding, make_mesh
    from advancedmh_tpu.runtime.sample import build_chain_fn
    from advancedmh_tpu.runtime.schedule import Schedule

    model = gaussian_mean_scale_model()
    spl = RWMH(MvNormal(jnp.zeros(2), scale=0.1))
    n_dev = max(num_devices, 1)
    mesh = make_mesh(n_devices=n_dev, axis="chains")
    C = total_chains
    assert C % n_dev == 0

    schedule = Schedule(
        n_samples=1, num_warmup=0, discard_initial=n_steps, thinning=1
    )
    chain_fn = build_chain_fn(
        spl, model, schedule, batch_shape=(C,),
        state_sharding=(
            chain_sharding(mesh, "chains") if num_devices > 0 else None
        ),
    )
    fn = jax.jit(lambda k: chain_fn(k, jnp.asarray([0.0, 1.0])))
    key = jax.random.key(0)

    def run():
        return jax.block_until_ready(fn(key))

    run()  # compile once; subsequent calls replay the executable
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return C * n_steps / best


def main():
    n_total = len(jax.devices())
    C = 2048 * n_total
    vmap_base = measure(0, C)
    results = {
        "total_chains": C,
        "vmap(no-mesh)": {"chain_steps_per_s": vmap_base},
    }
    n = 1
    while n <= n_total:
        r = measure(n, C)
        results[str(n)] = {
            "chain_steps_per_s": r,
            "overhead_vs_vmap": 1.0 - r / vmap_base,
        }
        n *= 2
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
