"""The r5 no-knobs / particle wing on one target, three ways.

A correlated 2-D Gaussian posterior solved by the three r5 additions:

- **MEADS** (samplers/meads.py): warmup-free generalized HMC — step size,
  damping, and preconditioner re-derived EVERY step from a complementary
  chain fold; every draw usable, nothing to tune or freeze.
- **SMC** (runtime/smc.py): adaptive-tempering particle flow prior →
  posterior; returns the posterior cloud AND the marginal likelihood from
  the same run.
- **SVGD** (runtime/svgd.py): deterministic Stein flow — a small
  fixed-cost particle cloud transported by kernel matmuls.

All three recover the same moments; SMC also certifies the evidence
against the analytic value of this conjugate-style target.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from advancedmh_tpu import MEADS, MvNormal, Normal, sample, smc_sample, svgd_sample

N_SAMPLES = int(os.environ.get("N_SAMPLES", 1000))
NUM_CHAINS = int(os.environ.get("NUM_CHAINS", 256))


def main():
    # Bayesian mean of a Gaussian: y ~ N(theta, I), theta ~ N(0, I), d=2.
    y = jnp.asarray(
        np.random.default_rng(0).normal(0.4, 1.0, size=(8, 2)), jnp.float32
    )
    n = y.shape[0]

    def loglik(theta):
        return jnp.sum(Normal(theta, 1.0).log_prob(y))

    prior = MvNormal(jnp.zeros(2), scale=1.0)
    post_mean = np.asarray(y.sum(0)) / (n + 1)
    post_var = 1.0 / (n + 1)

    def logpost(theta):
        return loglik(theta) + jnp.sum(Normal(0.0, 1.0).log_prob(theta))

    from advancedmh_tpu import DensityModel

    model = DensityModel(logpost, dimension=2)

    # 1. MEADS: warmup-free MCMC — discard a short burn, keep the rest.
    res = sample(
        model, MEADS(), N_SAMPLES, key=0, num_chains=NUM_CHAINS,
        discard_initial=200, initial_params=jnp.zeros(2), vectorized=True,
    )
    d_meads = np.asarray(res.transitions.params).reshape(-1, 2)

    # 2. SMC: posterior particles + evidence, adaptive schedule.
    out = smc_sample(loglik, prior, key=1, num_particles=4096)
    d_smc = np.asarray(out["particles"])

    # 3. SVGD: deterministic cloud.
    sv = svgd_sample(model, key=2, num_particles=512, num_steps=400,
                     init_scale=2.0)
    d_svgd = np.asarray(sv["particles"])

    for name, d in [("MEADS", d_meads), ("SMC", d_smc), ("SVGD", d_svgd)]:
        np.testing.assert_allclose(d.mean(0), post_mean, atol=0.08)
        np.testing.assert_allclose(
            d.var(0), np.full(2, post_var), rtol=0.35
        )
        print(f"{name:5s}: mean {d.mean(0).round(3)} var {d.var(0).round(4)}"
              f" (want {post_mean.round(3)}, {post_var:.4f})")

    # SMC's evidence against the closed form log N(y; 0, I_n ⊗ (1+1) ...):
    # each coordinate independently: y_j ~ N(0, I + 11^T).
    lz = 0.0
    for j in range(2):
        yj = np.asarray(y[:, j])
        cov = np.eye(n) + np.ones((n, n))
        _, logdet = np.linalg.slogdet(2.0 * np.pi * cov)
        lz += float(-0.5 * (logdet + yj @ np.linalg.solve(cov, yj)))
    assert abs(out["log_z"] - lz) < 0.1, (out["log_z"], lz)
    print(f"SMC  : log Z = {out['log_z']:.4f} (analytic {lz:.4f}), "
          f"schedule {[round(b, 3) for b in out['betas']]}")


if __name__ == "__main__":
    main()
