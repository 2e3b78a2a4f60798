"""≙ the reference emcee test model (test/emcee.jl): 1000-walker ensemble
with stretch moves recovers the analytic posterior means s̄ = 49/24,
m̄ = 7/6."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from advancedmh_tpu import Ensemble, InverseGamma, Normal, StretchProposal, sample
from advancedmh_tpu.models import emcee_demo_model

N_WALKERS = int(os.environ.get("N_WALKERS", 1000))
N_SAMPLES = int(os.environ.get("N_SAMPLES", 1000))


def main():
    model = emcee_demo_model()
    sampler = Ensemble(
        N_WALKERS, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
    )
    chain = sample(model, sampler, N_SAMPLES, key=100,
                   chain_type="chains", param_names=["s", "m"])
    s_mean = float(chain["s"].mean())
    m_mean = float(chain["m"].mean())
    print(f"s̄ = {s_mean:.4f} (analytic 49/24 = {49/24:.4f})")
    print(f"m̄ = {m_mean:.4f} (analytic  7/6 = {7/6:.4f})")
    assert abs(s_mean - 49 / 24) < 0.1 and abs(m_mean - 7 / 6) < 0.1
    print("analytic posterior means recovered ✓")
    return chain


if __name__ == "__main__":
    main()
