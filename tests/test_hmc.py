"""HamiltonianMC tests (samplers/hmc.py, beyond-parity).

HMC is exact-in-distribution for any step size / trajectory length thanks to
the MH energy-error accept, so the same posterior-moment contracts as the
reference's gradient sampler (test/runtests.jl:287-365) apply — plus the
HMC-specific physics: energy conservation at small ε, momentum-precondition
equivalence, and detailed-balance sanity at coarse ε.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    HamiltonianMC,
    MvNormal,
    StepSizeAdaptation,
    sample,
)
from advancedmh_tpu.models.targets import correlated_gaussian_model
from tests.test_mh import MODEL

COV = np.asarray([[1.5, 0.35], [0.35, 1.0]], np.float32)


class TestBasic:
    def test_requires_initial_params(self):
        with pytest.raises(ValueError, match="initial parameters"):
            sample(MODEL, HamiltonianMC(0.1, 5), 100, key=0)

    def test_validation(self):
        with pytest.raises(ValueError, match="step_size"):
            HamiltonianMC(-0.1, 5)
        with pytest.raises(ValueError, match="n_leapfrog"):
            HamiltonianMC(0.1, 0)

    def test_posterior_moments_gaussian_model(self):
        """README (μ, σ) model moments (≙ test/runtests.jl tolerance)."""
        chains = sample(
            MODEL, HamiltonianMC(0.05, 8), 1500, key=1, num_chains=16,
            initial_params=jnp.ones(2), discard_initial=500,
            chain_type="chains", param_names=["μ", "σ"],
        )
        assert abs(float(chains["μ"].mean())) < 0.1
        assert abs(float(chains["σ"].mean()) - 1.0) < 0.1

    def test_covariance_recovery_quadratic(self):
        """Σ recovery on the correlated quadratic (≙ MALA's issue-#95 test)
        — and HMC's decorrelated trajectories should do it with ease."""
        model = correlated_gaussian_model(COV)
        chains = sample(
            model, HamiltonianMC(0.4, 10), 2000, key=2, num_chains=32,
            initial_params=jnp.zeros(2), discard_initial=500,
            chain_type="chains",
        )
        draws = np.asarray(chains.values)  # (S, P, C)
        flat = draws.transpose(0, 2, 1).reshape(-1, 2)
        assert np.abs(np.cov(flat.T) - COV).max() < 0.2


class TestPhysics:
    def test_energy_conservation_small_eps(self):
        """At tiny ε the leapfrog energy error is O(ε²) ⇒ acceptance ≈ 1."""
        model = correlated_gaussian_model(COV)
        res = sample(
            model, HamiltonianMC(0.01, 5), 400, key=3, num_chains=8,
            initial_params=jnp.zeros(2),
        )
        acc = float(np.asarray(res.transitions.accepted).mean())
        assert acc > 0.995

    def test_coarse_eps_still_unbiased(self):
        """A coarse ε rejects plenty yet the MH correction keeps the mean
        unbiased — the defining HMC property."""
        model = correlated_gaussian_model(COV)
        res = sample(
            model, HamiltonianMC(1.7, 10), 3000, key=4, num_chains=32,
            initial_params=jnp.zeros(2), discard_initial=500,
        )
        acc = float(np.asarray(res.transitions.accepted).mean())
        assert 0.2 < acc < 0.8  # genuinely coarse (near the stability limit)
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert np.abs(draws.mean(axis=0)).max() < 0.1

    def test_inverse_mass_preconditioning(self):
        """Diagonal M⁻¹ = diag(Σ) rescales the dynamics per dimension: on a
        σ=20-vs-1 anisotropic target the wide dimension's trajectory angle
        is 20× larger, so its ESS at equal (ε, L) budget is vastly higher
        (Neal 2011 §4.1 — mass preconditioning ≡ coordinate rescale)."""
        from advancedmh_tpu.diagnostics import ess

        cov = np.diag([400.0, 1.0]).astype(np.float32)
        model = correlated_gaussian_model(cov)
        common = dict(key=5, num_chains=16, initial_params=jnp.zeros(2),
                      discard_initial=200)
        es = []
        for minv in (None, jnp.asarray([400.0, 1.0])):
            res = sample(
                model, HamiltonianMC(0.5, 6, inverse_mass=minv), 600, **common
            )
            x0 = np.asarray(res.transitions.params)[:, :, 0].T  # (S, C)
            es.append(float(ess(jnp.asarray(x0))))
        assert es[1] > 5.0 * es[0]

    def test_pytree_params(self):
        """Params/momenta as a dict pytree with coupled leaves."""

        def logdensity(p):
            return -0.5 * (
                jnp.sum(p["a"] ** 2) + jnp.sum((p["b"] - 1.0) ** 2) / 0.25
            )

        model = DensityModel(logdensity)
        res = sample(
            model, HamiltonianMC(0.2, 8), 2000, key=6, num_chains=16,
            initial_params={"a": jnp.zeros(2), "b": jnp.zeros(())},
            discard_initial=300,
        )
        a = np.asarray(res.transitions.params["a"])
        b = np.asarray(res.transitions.params["b"])
        assert np.abs(a.mean(axis=(0, 1))).max() < 0.1
        assert abs(b.mean() - 1.0) < 0.1
        assert abs(b.std() - 0.5) < 0.1


class TestBatchedEquivalence:
    def test_batched_matches_single_chain_distribution(self):
        """step_batched is the hot path (has_batched_kernel True); its
        per-chain marginals must match vmapped single-chain stepping."""
        spl = HamiltonianMC(0.3, 6)
        assert spl.has_batched_kernel
        model = correlated_gaussian_model(COV)
        res_b = sample(
            model, spl, 1500, key=7, num_chains=32,
            initial_params=jnp.zeros(2), discard_initial=300,
        )
        draws = np.asarray(res_b.transitions.params).reshape(-1, 2)
        assert np.abs(np.cov(draws.T) - COV).max() < 0.25


class TestAdapted:
    def test_step_size_adaptation_hits_target(self):
        """StepSizeAdaptation.hmc dual-averages ε to the 0.65 optimum."""
        model = correlated_gaussian_model(COV)
        spl = StepSizeAdaptation.hmc(n_leapfrog=5, initial_step_size=0.02)
        res = sample(
            model, spl, 600, key=8, num_chains=16, num_warmup=600,
            initial_params=jnp.zeros(2), discard_initial=600,
        )
        acc = float(np.asarray(res.transitions.accepted).mean())
        assert abs(acc - 0.65) < 0.12
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert np.abs(draws.mean(axis=0)).max() < 0.15


class TestAdaptiveHMC:
    """AdaptiveHMC (samplers/hmc_adapt.py): joint ε + diag-mass warmup."""

    def _aniso_model(self):
        var = jnp.array([25.0, 0.25])
        return DensityModel(lambda x: -0.5 * jnp.sum(x * x / var)), var

    def test_validation(self):
        from advancedmh_tpu import AdaptiveHMC

        with pytest.raises(ValueError, match="n_leapfrog"):
            AdaptiveHMC(n_leapfrog=0)
        with pytest.raises(ValueError, match="target_accept"):
            AdaptiveHMC(target_accept=1.5)
        with pytest.raises(ValueError, match="gamma"):
            AdaptiveHMC(gamma=0.0)
        with pytest.raises(ValueError, match="mass_regularization"):
            AdaptiveHMC(mass_regularization=-1.0)

    def test_mass_matrix_recovers_scales(self):
        """Adapted diag(M⁻¹) ≈ the posterior variances (100:1 anisotropy)."""
        from advancedmh_tpu import AdaptiveHMC

        model, var = self._aniso_model()
        res = sample(
            model, AdaptiveHMC(n_leapfrog=10), 400, key=10, num_chains=64,
            num_warmup=400, initial_params=jnp.zeros(2),
        )
        inv_mass = np.asarray(res.final_state.inverse_mass).mean(axis=0)
        assert np.allclose(inv_mass, np.asarray(var), rtol=0.35)
        x = np.asarray(res.transitions.params)
        assert np.allclose(x.var(axis=(0, 1)), np.asarray(var), rtol=0.3)
        assert np.abs(x.mean(axis=(0, 1)) / np.sqrt(np.asarray(var))).max() < 0.1

    def test_pooled_mass_shared_and_faster(self):
        """pooled=True: one shared estimate (identical across chains), and
        with C chains of information per step it locks on in a warmup far
        too short for per-chain estimation."""
        from advancedmh_tpu import AdaptiveHMC

        model, var = self._aniso_model()
        short = 60  # >> mass_warm_start but ~2 per-chain effective samples
        res = sample(
            model, AdaptiveHMC(n_leapfrog=10, pooled=True), 100, key=11,
            num_chains=128, num_warmup=short, initial_params=jnp.zeros(2),
        )
        im = np.asarray(res.final_state.inverse_mass)
        assert np.allclose(im, im[:1], atol=0.0)  # replicated across chains
        assert np.allclose(im[0], np.asarray(var), rtol=0.5)

        res_pc = sample(
            model, AdaptiveHMC(n_leapfrog=10, pooled=False), 100, key=11,
            num_chains=128, num_warmup=short, initial_params=jnp.zeros(2),
        )
        im_pc = np.asarray(res_pc.final_state.inverse_mass).mean(axis=0)
        err = lambda est: np.abs(np.log(est) - np.log(np.asarray(var))).max()
        assert err(im[0]) < err(im_pc)

    def test_frozen_after_warmup(self):
        """Post-warmup: ε and M⁻¹ frozen (≙ RAM frozen-S main phase)."""
        from advancedmh_tpu import AdaptiveHMC

        model, _ = self._aniso_model()
        spl = AdaptiveHMC(n_leapfrog=5)
        res = sample(
            model, spl, 50, key=12, num_chains=8, num_warmup=100,
            initial_params=jnp.zeros(2), collect_states=True,
        )
        im = np.asarray(res.states.inverse_mass)  # (C, S, d)
        assert np.all(im[:, 1:] == im[:, :1])
        eps = np.asarray(res.states.log_eps_bar)
        assert np.all(eps[:, 1:] == eps[:, :1])

    def test_acceptance_near_target(self):
        from advancedmh_tpu import AdaptiveHMC

        model = correlated_gaussian_model(COV)
        res = sample(
            model, AdaptiveHMC(n_leapfrog=5, initial_step_size=0.02),
            600, key=13, num_chains=32, num_warmup=600,
            initial_params=jnp.zeros(2),
        )
        acc = float(np.asarray(res.transitions.accepted).mean())
        assert abs(acc - 0.65) < 0.17
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert np.abs(np.cov(draws.T) - COV).max() < 0.25

    def test_pytree_params_mass(self):
        """Mass adaptation over dict-pytree params: each leaf gets its own
        per-dimension scale."""
        from advancedmh_tpu import AdaptiveHMC

        def logdensity(p):
            return -0.5 * (
                jnp.sum(p["a"] ** 2 / 9.0) + jnp.sum((p["b"] - 1.0) ** 2) / 0.25
            )

        model = DensityModel(logdensity)
        res = sample(
            model, AdaptiveHMC(n_leapfrog=8), 300, key=14, num_chains=32,
            num_warmup=300,
            initial_params={"a": jnp.zeros(2), "b": jnp.zeros(())},
        )
        im_a = np.asarray(res.final_state.inverse_mass["a"]).mean(axis=0)
        im_b = np.asarray(res.final_state.inverse_mass["b"]).mean()
        assert np.allclose(im_a, 9.0, rtol=0.4)
        assert abs(im_b - 0.25) < 0.12


class TestMultinomialTrajectory:
    """trajectory_sampling="multinomial": uniform-offset multinomial over
    the whole orbit (Neal windowed / Betancourt within-trajectory sampling).
    Exact for any ε/L; moves when the endpoint accept would reject
    (robustness — on a well-tuned target the endpoint kernel's antithetic
    trajectories still win raw ESS; see CLAUDE.md perf notes)."""

    def _model(self):
        var = jnp.array([4.0, 0.25])
        return DensityModel(lambda x: -0.5 * jnp.sum(x * x / var)), var

    def test_validation(self):
        with pytest.raises(ValueError, match="trajectory_sampling"):
            HamiltonianMC(0.1, 5, trajectory_sampling="nuts")

    def test_exact_at_coarse_eps(self):
        """ε near the stability limit: large energy errors — any bias in
        the windowed construction would surface here."""
        model, var = self._model()
        spl = HamiltonianMC(0.8, 6, trajectory_sampling="multinomial")
        res = sample(model, spl, 1500, key=40, num_chains=1024,
                     initial_params=jnp.zeros(2), discard_initial=400)
        x = np.asarray(res.transitions.params)
        assert np.allclose(x.var(axis=(0, 1)), np.asarray(var), rtol=0.05)
        assert np.abs(x.mean(axis=(0, 1)) / np.sqrt(np.asarray(var))).max() < 0.05

    def test_moves_more_than_endpoint(self):
        """Rejection-free trajectory sampling moves at least as often as
        the endpoint MH accept at the same (ε, L) budget."""
        model, _ = self._model()
        kw = dict(key=41, num_chains=512, initial_params=jnp.zeros(2),
                  discard_initial=300)
        acc_end = float(np.asarray(sample(
            model, HamiltonianMC(0.8, 6), 800, **kw
        ).transitions.accepted).mean())
        moved = float(np.asarray(sample(
            model, HamiltonianMC(0.8, 6, trajectory_sampling="multinomial"),
            800, **kw
        ).transitions.accepted).mean())
        assert moved > acc_end - 0.05

    def test_single_chain_and_pytree(self):
        def logdensity(p):
            return -0.5 * (jnp.sum(p["a"] ** 2) + (p["b"] - 1.0) ** 2 / 0.25)

        model = DensityModel(logdensity)
        spl = HamiltonianMC(0.3, 6, trajectory_sampling="multinomial")
        res = sample(model, spl, 3000, key=42,
                     initial_params={"a": jnp.zeros(2), "b": jnp.zeros(())},
                     discard_initial=500)
        b = np.asarray(res.transitions.params["b"])
        assert abs(b.mean() - 1.0) < 0.1
        assert abs(b.std() - 0.5) < 0.1

    def test_fused_engine_rejects_multinomial(self):
        model, _ = self._model()
        spl = HamiltonianMC(0.3, 6, trajectory_sampling="multinomial")
        with pytest.raises(ValueError, match="no kernel for HamiltonianMC"):
            sample(model, spl, 10, key=0, num_chains=1024, engine="fused",
                   initial_params=jnp.zeros(2))
