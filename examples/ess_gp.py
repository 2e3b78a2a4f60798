"""Elliptical slice sampling of a GP latent field (beyond-parity; the
reference only *hints* at elliptical slice moves in commented-out code,
src/emcee.jl:104-214).

GP binary classification on a 1-D grid: latent f ~ N(0, K) (RBF kernel),
observations y ∈ {−1, +1} with logistic likelihood σ(y·f) — non-conjugate,
the standard ESS application (Murray, Adams & MacKay 2010 §4). ESS needs no
step size and never rejects; the per-step prior draw ν = L·ε is a batched
triangular matvec under the chain batch, at HIGHEST precision."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from advancedmh_tpu import EllipticalSlice, sample
from advancedmh_tpu.models import gp_latent_model

N_SAMPLES = int(os.environ.get("N_SAMPLES", 1500))
NUM_CHAINS = int(os.environ.get("NUM_CHAINS", 128))
N_POINTS = int(os.environ.get("N_POINTS", 64))


def main():
    model, prior, aux = gp_latent_model(
        n_points=N_POINTS, likelihood="logistic", lengthscale=0.2, seed=5
    )
    res = sample(
        model, EllipticalSlice(prior), N_SAMPLES, key=0,
        num_chains=NUM_CHAINS, discard_initial=N_SAMPLES // 5,
    )
    draws = np.asarray(res.transitions.params).reshape(-1, N_POINTS)
    post_mean = draws.mean(0)
    acc = (np.sign(post_mean) == aux["y"]).mean()
    # labels are noisy draws from the latent, so judge sign recovery only
    # where the true latent is confidently nonzero (near f≈0 the label noise
    # dominates and any sampler's posterior mean may legitimately flip sign)
    confident = np.abs(aux["f_true"]) > 0.5
    sign_agree = (
        np.sign(post_mean[confident]) == np.sign(aux["f_true"][confident])
    ).mean()
    corr = np.corrcoef(post_mean, aux["f_true"])[0, 1]
    accepted = np.asarray(res.transitions.accepted)[:, 1:]
    print(f"{draws.shape[0]} draws of a {N_POINTS}-point latent field")
    print(f"train accuracy of posterior-mean classifier: {acc:.3f} "
          f"(sign agreement on |f_true|>0.5: {sign_agree:.3f})")
    print(f"corr(posterior mean, true latent): {corr:.3f}")
    print(f"slice acceptance (rejection-free by construction): "
          f"{accepted.mean():.4f}")
    assert sign_agree > 0.95, "posterior mean should match confident signs"
    assert corr > 0.9, "posterior mean should track the true latent"
    assert accepted.all()


if __name__ == "__main__":
    main()
