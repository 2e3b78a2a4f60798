"""Fused RWMH kernel against the XLA engine, whole ``sample()`` calls.

    python benchmarks/fused_vs_xla.py            # timing + posterior check
    python benchmarks/fused_vs_xla.py --sweep    # compile, memory, block sweep

Default mode: on the README model (16384 chains, 500 burn + 4000 draws,
scale 0.35) and on d=32 logistic regression (8192 chains), run the engines
in the order XLA, fused, fused, XLA in one process. Each call is a whole
``sample()`` ending in ``jax.block_until_ready``; the first call of each
engine compiles and is reported apart. The posteriors must agree: means and
second moments within 4·MCSE (chain-independent MCSE), acceptance within
0.01. The XLA engine runs at ``highest`` matmul precision as the reference.

``--sweep`` compiles the kernel at real widths for each block size and warp
count in ``SWEEP`` (one process per variant, one at a time), prints its
memory analysis, and times it at a fixed workload.

Needs a GPU; exits non-zero on any other platform.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from advancedmh_tpu import MvNormal, RWMH, sample  # noqa: E402
from advancedmh_tpu.diagnostics.agreement import (  # noqa: E402
    chain_moments,
    moments_agree,
)
from advancedmh_tpu.models.targets import (  # noqa: E402
    gaussian_mean_scale_model,
    logistic_regression_model,
)
from advancedmh_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

N_WARM, N_DRAWS = 500, 4000


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def _cases():
    readme = gaussian_mean_scale_model()
    logreg = logistic_regression_model(n_obs=256, dim=32)
    return {
        "readme": dict(
            model=readme, spl=RWMH(MvNormal(jnp.zeros(2), scale=0.35)),
            C=16384, init=jnp.asarray([0.0, 1.0]),
        ),
        "logreg32": dict(
            model=logreg, spl=RWMH(MvNormal(jnp.zeros(32), scale=0.3)),
            C=8192, init=jnp.asarray(logreg.beta_true),
        ),
    }


def _run(case, engine, key):
    t0 = time.perf_counter()
    res = sample(
        case["model"], case["spl"], N_DRAWS, key=key, num_chains=case["C"],
        engine=engine, discard_initial=N_WARM, initial_params=case["init"],
    )
    jax.block_until_ready(res.transitions)
    return time.perf_counter() - t0, res


def compare():
    report = {}
    for name, case in _cases().items():
        t = {"xla": [], "fused": []}
        results = {}
        for i, engine in enumerate(("xla", "fused", "fused", "xla",
                                    "xla", "fused")):
            if engine == "xla":
                with jax.default_matmul_precision("highest"):
                    dt, res = _run(case, engine, key=i)
            else:
                dt, res = _run(case, engine, key=i)
            t[engine].append(dt)
            results.setdefault(engine, res)
        steps = case["C"] * (N_WARM + N_DRAWS - 1)
        row = {}
        for engine in ("xla", "fused"):
            compile_s = t[engine][0] - min(t[engine][1:])
            run_s = float(np.median(t[engine][1:]))
            row[engine] = dict(
                first_call_s=t[engine][0], steady_calls_s=t[engine][1:],
                compile_s_est=compile_s, chain_steps_per_s=steps / run_s,
            )
        xm = chain_moments(np.asarray(results["xla"].transitions.params))
        fm = chain_moments(
            np.asarray(results["fused"].transitions.params), xm["mean"]
        )
        ok, worst = moments_agree(fm, xm, n_sigma=4.0)
        acc_x = float(np.asarray(results["xla"].transitions.accepted).mean())
        acc_f = float(np.asarray(results["fused"].transitions.accepted).mean())
        row.update(
            speedup=row["fused"]["chain_steps_per_s"]
            / row["xla"]["chain_steps_per_s"],
            posterior_ok=bool(ok), worst_z=worst,
            acceptance=dict(xla=acc_x, fused=acc_f),
            acceptance_ok=abs(acc_x - acc_f) < 0.01,
            precision="xla: highest; fused: IEEE float32 (exact f32 dot)",
        )
        report[name] = row
        print(name, json.dumps(row), flush=True)
        assert ok and row["acceptance_ok"], (name, worst, acc_x, acc_f)
    return report


SWEEP = {
    "readme": [(32, 4), (64, 2), (64, 4), (128, 4), (256, 4)],
    "logreg32": [(16, 4), (16, 8)],
}


def sweep_one(name, block, warps):
    """Compile one (block, warps) variant at real width, print its memory
    analysis and its best-of-3 run time at a fixed workload."""
    from advancedmh_tpu.ops import pallas_mh

    case = _cases()[name]
    model, C = case["model"], case["C"]
    d = model.dimension
    scale = case["spl"].proposal.payload.scale
    x = jnp.broadcast_to(jnp.asarray(case["init"], jnp.float32)[:, None],
                         (d, C))
    lp = model.tile_density(x, *map(jnp.asarray, model.tile_consts))
    ctl = jnp.asarray([1, 2, 0, 0], jnp.uint32)
    run = pallas_mh.fused_rwmh_sample(
        model.tile_density, d, scale, N_DRAWS, burn=N_WARM,
        consts=model.tile_consts, block_chains=block, num_warps=warps,
    )
    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(x, lp, ctl).compile()
    t_c = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(x, lp, ctl))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(x, lp, ctl))
        ts.append(time.perf_counter() - t0)
    print(json.dumps({
        "case": name, "block": block, "warps": warps, "compile_s": t_c,
        "run_s": min(ts), "acc": float(out[2].mean()),
        "chain_steps_per_s": C * (N_WARM + N_DRAWS) / min(ts),
        "memory": str(compiled.memory_analysis()),
    }), flush=True)


def sweep(timeout_s=90):
    """Each variant in its own process, one at a time (a JAX process
    reserves most of the card, so this parent never touches it); a variant
    whose compile outlasts ``timeout_s`` is reported and skipped."""
    for name, variants in SWEEP.items():
        for block, warps in variants:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", name,
                   str(block), str(warps)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout_s)
                print(r.stdout.strip() or r.stderr.strip()[-600:], flush=True)
            except subprocess.TimeoutExpired:
                print(json.dumps({"case": name, "block": block,
                                  "warps": warps, "timeout_s": timeout_s}),
                      flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--one", nargs=3, metavar=("CASE", "BLOCK", "WARPS"))
    args = ap.parse_args()
    if args.sweep:
        print("card", _card())
        return sweep()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"needs a GPU, found platform {dev.platform!r}")
    enable_compile_cache()
    if args.one:
        name, block, warps = args.one
        return sweep_one(name, int(block), int(warps))
    print("card", _card())
    print("device", dev.platform, dev.device_kind, len(jax.devices()))
    print(json.dumps(compare()))


if __name__ == "__main__":
    main()
