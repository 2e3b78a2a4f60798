"""Non-Gaussian geometry validation: Neal's funnel + Haario banana.

Beyond-parity validation of the beyond-parity adaptation machinery: the
reference's entire test geometry is Gaussian (test/runtests.jl:22-31), but
adaptive samplers earn their keep exactly where Gaussian tests cannot look
— varying curvature (funnel) and curved ridges (banana). Ground truths are
exact (funnel: v ~ N(0, 9) marginally; banana: a volume-preserving twist of
N(0, diag(100, 1)) → Var = [100, 1 + 2b²σ₁⁴] = [100, 19]).

Calibrated expectations (documented in docs/design.md §6c):

- SliceSampler's per-step adaptive bracket recovers the funnel neck almost
  exactly — the canonical fixed-metric failure case solved by a
  step-size-free method.
- ChEES stays *finite* on the funnel (regression: divergences used to nan
  the pooled statistics → T̄/ε̄) and reaches deeper into the neck than
  fixed-coarse-ε HMC, but no fixed-metric HMC recovers the deep neck
  (Neal 2003 / the Stan reparameterization lesson).
- On the banana, ChEES's long jittered trajectories track the curved ridge
  (variances within 15%), where AdaptiveHMC's single diagonal metric
  under-disperses the ridge direction at any budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    AdaptiveHMC,
    ChEESHMC,
    DRAM,
    HamiltonianMC,
    SliceSampler,
    sample,
)
from advancedmh_tpu.models.targets import (
    banana_model, emcee_demo_model, neal_funnel_model,
)

# Exact funnel neck masses: P(v < -c) = Phi(-c/3) for v ~ N(0, 9).
_P_NECK2 = 0.25249  # Phi(-2/3)
_P_NECK4 = 0.09121  # Phi(-4/3)


class TestTargetDefinitions:
    """The closed-form gradients and Pallas tile forms must agree with the
    autodiff/logdensity ground truth."""

    @pytest.mark.parametrize(
        "model", [neal_funnel_model(6), banana_model()], ids=["funnel", "banana"]
    )
    def test_gradients_match_autodiff(self, model):
        xs = np.random.default_rng(0).normal(
            size=(16, model.dimension)
        ).astype(np.float32)
        for x in xs:
            x = jnp.asarray(x)
            lp, g = model.logdensity_and_gradient_fn(x)
            lp_ad, g_ad = jax.value_and_grad(model.logdensity_fn)(x)
            np.testing.assert_allclose(lp, lp_ad, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, g_ad, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize(
        "model", [emcee_demo_model(transformed=True), banana_model()],
        ids=["emcee_log_s", "banana"],
    )
    def test_tile_density_matches_logdensity(self, model):
        xs = np.random.default_rng(1).normal(
            size=(32, model.dimension)
        ).astype(np.float32)
        tiled = model.tile_density(jnp.asarray(xs.T))[0]
        ref = jax.vmap(model.logdensity_fn)(jnp.asarray(xs))
        np.testing.assert_allclose(tiled, ref, rtol=1e-5, atol=1e-5)


class TestNealFunnel:
    C, W, N = 512, 800, 1500

    def _run(self, spl, **kw):
        model = neal_funnel_model(10)
        res = sample(
            model, spl, self.N, key=0, num_chains=self.C,
            initial_params=jnp.zeros(10), chain_type="raw", **kw,
        )
        return res, np.asarray(res.transitions.params)[:, :, 0]  # v draws

    def test_slice_recovers_neck_mass(self):
        """Per-step adaptive brackets solve the funnel: v-marginal quantile
        masses within Monte-Carlo tolerance of the exact N(0, 9)."""
        _, v = self._run(SliceSampler(width=2.0), discard_initial=self.W)
        assert abs((v < -2).mean() - _P_NECK2) < 0.03
        assert abs((v < -4).mean() - _P_NECK4) < 0.04
        assert abs(v.mean()) < 0.35
        assert 2.3 < v.std() < 3.3

    def test_chees_finite_and_deeper_than_fixed_hmc(self):
        """Regression for the funnel nan cascade (divergences poisoning the
        pooled statistics): adapted ε̄/T̄ stay finite, T̄ respects the
        clip band, and ChEES reaches the v < −4 neck where fixed-coarse-ε
        HMC records literally zero visits. Full neck recovery is NOT
        asserted — no fixed-metric HMC does it (Neal 2003)."""
        spl = ChEESHMC(
            initial_step_size=0.2, initial_trajectory_length=1.0,
            max_leapfrog=32,
        )
        res, v = self._run(
            spl, num_warmup=self.W, discard_initial=self.W
        )
        st = res.final_state
        eps = float(np.exp(np.asarray(st.log_eps_bar).reshape(-1)[0]))
        t_traj = float(np.exp(np.asarray(st.log_traj_bar).reshape(-1)[0]))
        assert np.isfinite(eps) and np.isfinite(t_traj)
        assert 0.0 < eps < 2.0
        assert eps <= t_traj <= spl.max_leapfrog * eps + 1e-5
        assert np.isfinite(np.asarray(res.transitions.lp)).all()

        _, v_fixed = self._run(HamiltonianMC(0.4, 8), discard_initial=self.W)
        # coarse fixed ε (essentially) never enters the neck — a near-zero
        # bound, not exact zero: one stray excursion over 512×1500 draws
        # under a different key/codegen must not fail the suite
        assert (v_fixed < -4).mean() < 1e-4
        assert (v < -4).mean() > 0.0  # adapted ε at least reaches it
        assert (v < -4).mean() > (v_fixed < -4).mean()
        assert (v < -2).mean() > (v_fixed < -2).mean()


class TestMEADSGeometry:
    """MEADS (r5): the warmup-free cross-fold GHMC on the two hard
    geometries. The per-step fold statistics re-tune (σ, ε, γ) as the
    ensemble spreads — no warmup phase exists to get wrong."""

    def test_funnel_neck(self):
        """v-marginal within the fixed-metric-HMC band: MEADS's σ tracks
        the ensemble spread but a diagonal preconditioner still cannot
        fully enter the deep neck (the Neal 2003 lesson — same calibrated
        expectation as ChEES, docs/design.md §6c)."""
        from advancedmh_tpu import MEADS

        model = neal_funnel_model(10)
        res = sample(
            model, MEADS(), 2500, key=0, num_chains=512,
            discard_initial=1500, initial_params=jnp.zeros(10),
            chain_type="raw",
        )
        v = np.asarray(res.transitions.params)[:, :, 0]
        assert np.isfinite(np.asarray(res.transitions.lp)).all()
        assert abs(v.mean()) < 0.4
        assert 2.3 < v.std() < 3.3
        assert abs((v < -2).mean() - _P_NECK2) < 0.07
        assert (v < -4).mean() > 0.0  # reaches the deep neck

    def test_banana_ridge(self):
        """The curved ridge: per-step re-estimated fold statistics keep ε
        matched to the local curvature as chains traverse the ridge —
        variances within the ChEES band."""
        from advancedmh_tpu import MEADS

        model = banana_model()
        res = sample(
            model, MEADS(), 3000, key=0, num_chains=512,
            discard_initial=1500, initial_params=jnp.zeros(2),
            chain_type="raw",
        )
        x = np.asarray(res.transitions.params).reshape(-1, 2)
        np.testing.assert_allclose(x.var(0), [100.0, 19.0], rtol=0.15)
        assert abs(x.mean(0)[0]) < 1.5 and abs(x.mean(0)[1]) < 0.4


class TestHaarioBanana:
    C, W = 512, 800

    def _run(self, spl, n, **kw):
        model = banana_model()
        res = sample(
            model, spl, n, key=0, num_chains=self.C,
            initial_params=jnp.zeros(2), chain_type="raw",
            num_warmup=self.W, discard_initial=self.W, **kw,
        )
        return np.asarray(res.transitions.params).reshape(-1, 2)

    def test_chees_recovers_curved_ridge(self):
        x = self._run(
            ChEESHMC(
                initial_step_size=0.5, initial_trajectory_length=2.0,
                max_leapfrog=64,
            ),
            2000,
        )
        np.testing.assert_allclose(x.var(0), [100.0, 19.0], rtol=0.15)
        assert abs(x.mean(0)[0]) < 1.5 and abs(x.mean(0)[1]) < 0.4

    def test_dram_recovers_curved_ridge_loosely(self):
        """Two-stage delayed rejection walks the ridge — slower tail
        mixing than ChEES at equal budget, hence the loose band."""
        x = self._run(DRAM(), 4000)
        assert 80.0 < x.var(0)[0] < 115.0
        assert 12.0 < x.var(0)[1] < 26.0
        assert abs(x.mean(0)[1]) < 0.6

    def test_chees_beats_single_metric_on_ridge(self):
        """A single diagonal mass matrix cannot follow the curved ridge:
        AdaptiveHMC under-disperses the ridge direction where ChEES's long
        jittered trajectories recover it — the documented motivation for
        trajectory-length adaptation (docs/design.md §6c)."""
        x_chees = self._run(
            ChEESHMC(
                initial_step_size=0.5, initial_trajectory_length=2.0,
                max_leapfrog=64,
            ),
            2000,
        )
        x_ahmc = self._run(
            AdaptiveHMC(n_leapfrog=16, initial_step_size=0.5, pooled=True),
            2000,
        )
        err_chees = abs(x_chees.var(0)[1] - 19.0)
        err_ahmc = abs(x_ahmc.var(0)[1] - 19.0)
        assert err_chees < err_ahmc
