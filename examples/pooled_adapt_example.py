"""Pooled cross-chain adaptation (beyond-parity; SURVEY §2 "adaptation
statistics over collectives").

With `pooled=True`, every chain feeds ONE shared covariance estimate each
step — C observations per step instead of 1 — so RAM's shape factor S (and
AM/DRAM's Welford Σ) converge ~C× faster in wall-clock steps. The
chain-axis reductions compile to a psum across devices when the chain batch is
sharded over a mesh (`chain_method=MCMCDistributed()`).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from advancedmh_tpu import RobustAdaptiveMetropolis, sample
from advancedmh_tpu.models.targets import correlated_gaussian_model

N_SAMPLES = int(os.environ.get("N_SAMPLES", 20))
NUM_CHAINS = int(os.environ.get("NUM_CHAINS", 128))
NUM_WARMUP = int(os.environ.get("NUM_WARMUP", 250))


def main():
    d = 4
    C = 0.5 * np.ones((d, d), np.float32) + 0.5 * np.eye(d, dtype=np.float32)
    model = correlated_gaussian_model(jnp.asarray(C))
    kw = dict(
        key=0, num_chains=NUM_CHAINS, num_warmup=NUM_WARMUP,
        discard_initial=NUM_WARMUP, initial_params=jnp.zeros(d),
        vectorized=True,
    )

    def shape_err(S):
        M = S @ np.swapaxes(S, -1, -2)
        M = M / np.trace(M, axis1=-2, axis2=-1)[..., None, None]
        return np.abs(M - C / np.trace(C)).max(axis=(-2, -1))

    pooled = sample(model, RobustAdaptiveMetropolis(pooled=True), N_SAMPLES, **kw)
    per = sample(model, RobustAdaptiveMetropolis(), N_SAMPLES, **kw)
    e_pooled = float(shape_err(np.asarray(pooled.final_state.S)[0]))
    e_per = float(shape_err(np.asarray(per.final_state.S)).mean())
    print(f"after {NUM_WARMUP} warmup steps x {NUM_CHAINS} chains:")
    print(f"  pooled shared-S shape error:     {e_pooled:.4f}")
    print(f"  per-chain mean S shape error:    {e_per:.4f}")
    print(f"  pooled advantage: {e_per / max(e_pooled, 1e-9):.1f}x")
    assert e_pooled < e_per


if __name__ == "__main__":
    main()
