"""emcee ensemble sampler tests ≙ reference test/emcee.jl.

The conjugate-ish model: s ~ InverseGamma(2,3), m ~ N(0, √s), obs 1.5 and 2.0
from N(m, √s). Analytic posterior means s̄ = 49/24, m̄ = 7/6. Tested in
untransformed and log-transformed (Jacobian-corrected) space, with the
red-black parallel stretch move standing in for the reference's sequential
scheme (statistically equivalent — SURVEY.md §3.5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    Ensemble,
    InverseGamma,
    MvNormal,
    Normal,
    StretchProposal,
    sample,
)

S_TRUE = 49.0 / 24.0
M_TRUE = 7.0 / 6.0


def _logprob_untransformed(theta):
    s, m = theta[0], theta[1]
    safe_s = jnp.maximum(s, 1e-6)
    lp = (
        InverseGamma(2.0, 3.0).log_prob(safe_s)
        + Normal(0.0, jnp.sqrt(safe_s)).log_prob(m)
        + Normal(m, jnp.sqrt(safe_s)).log_prob(1.5)
        + Normal(m, jnp.sqrt(safe_s)).log_prob(2.0)
    )
    return jnp.where(s > 0, lp, -jnp.inf)


def _logprob_transformed(theta):
    logs, m = theta[0], theta[1]
    s = jnp.exp(logs)
    sqrts = jnp.sqrt(s)
    return (
        InverseGamma(2.0, 3.0).log_prob(s)
        + Normal(0.0, sqrts).log_prob(m)
        + Normal(m, sqrts).log_prob(1.5)
        + Normal(m, sqrts).log_prob(2.0)
        + logs  # Jacobian of the log transform
    )


class TestUntransformed:
    def test_posterior_means(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(
            1000, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        chains = sample(
            model, spl, 1000, key=100, chain_type="chains",
            param_names=["s", "m"],
        )
        assert chains.n_chains == 1000  # walkers as chains (3-D path)
        assert chains.range == range(1, 1001)
        assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
        assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1

    def test_discard_thinning(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(
            1000, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        chains = sample(
            model, spl, 500, key=101, chain_type="chains",
            param_names=["s", "m"], discard_initial=25, thinning=4,
        )
        assert chains.range == range(26, 26 + 4 * 500, 4)
        assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
        assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1


class TestTransformed:
    def test_posterior_means_with_jacobian(self):
        model = DensityModel(_logprob_transformed)
        spl = Ensemble(1000, StretchProposal(MvNormal.standard(2)))
        chains = sample(
            model, spl, 1000, key=102, chain_type="chains",
            param_names=["logs", "m"],
        )
        s_draws = np.exp(np.asarray(chains["logs"]))
        assert abs(s_draws.mean() - S_TRUE) < 0.1
        assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1


class TestWalkMove:
    def test_posterior_means(self):
        """GW10 walk move (emcee's WalkMove companion) recovers the same
        analytic posterior as the stretch move."""
        from advancedmh_tpu import WalkProposal

        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(
            500, WalkProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        # walk mixes slower than stretch on the heavy-tailed s marginal
        # (acc ≈ 0.33 at scale=1) — burn generously before the moment check
        res = sample(model, spl, 3000, key=100, discard_initial=1500)
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert abs(draws[:, 0].mean() - S_TRUE) < 0.12
        assert abs(draws[:, 1].mean() - M_TRUE) < 0.12
        acc = np.asarray(res.transitions.accepted).mean()
        assert 0.1 < acc < 0.95

    def test_pytree_walk_couples_leaves(self):
        """The per-contributing-walker z_j is shared across all leaves —
        the walk direction is a single draw from the joint frozen-half
        covariance, so a correlated 2-leaf Gaussian is recovered."""
        from advancedmh_tpu import WalkProposal

        rho = 0.8
        def lp(th):
            a, b = th["a"], th["b"]
            q = (a * a - 2 * rho * a * b + b * b) / (1 - rho * rho)
            return -0.5 * q

        model = DensityModel(lp)
        spl = Ensemble(
            256, WalkProposal({"a": Normal(0.0, 1.0), "b": Normal(0.0, 1.0)})
        )
        res = sample(model, spl, 2000, key=5, discard_initial=500)
        a = np.asarray(res.transitions.params["a"]).ravel()
        b = np.asarray(res.transitions.params["b"]).ravel()
        assert abs(np.corrcoef(a, b)[0, 1] - rho) < 0.1

    def test_fused_engine_rejects_walk(self):
        from advancedmh_tpu import WalkProposal

        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(
            512, WalkProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        with pytest.raises(ValueError, match="no kernel for Ensemble"):
            sample(model, spl, 10, key=0, engine="fused")


class TestMechanics:
    def test_walker_shapes(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(8, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))
        res = sample(model, spl, 5, key=0)
        assert np.asarray(res.transitions.params).shape == (5, 8, 2)
        assert np.asarray(res.transitions.lp).shape == (5, 8)

    def test_initial_params_override(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(4, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))
        init = jnp.tile(jnp.asarray([2.0, 1.0]), (4, 1))
        res = sample(model, spl, 3, key=0, initial_params=init, discard_initial=0)
        np.testing.assert_allclose(np.asarray(res.transitions.params)[0], init)

    def test_initial_params_walker_count_mismatch_raises(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(8, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))
        bad = jnp.tile(jnp.asarray([2.0, 1.0]), (6, 1))  # 6 walkers ≠ 8
        with pytest.raises(ValueError, match="n_walkers"):
            sample(model, spl, 3, key=0, initial_params=bad)

    def test_acceptance_happens(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(64, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]))
        res = sample(model, spl, 100, key=1)
        acc_rate = np.asarray(res.transitions.accepted)[1:].mean()
        assert 0.05 < acc_rate < 0.95


class TestFusedEngineErrors:
    """The fused engine has a kernel for random-walk MH only: an ensemble
    asking for it raises before anything is traced."""

    def test_walker_count_must_align(self):
        model = DensityModel(_logprob_untransformed)
        spl = Ensemble(
            1000, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        with pytest.raises(ValueError, match="no kernel for Ensemble"):
            sample(model, spl, 10, key=0, engine="fused")

    def test_needs_tile_density(self):
        model = DensityModel(lambda th: -0.5 * jnp.sum(th**2), dimension=2)
        spl = Ensemble(
            1024, StretchProposal([Normal(0.0, 1.0), Normal(0.0, 1.0)])
        )
        with pytest.raises(ValueError, match="no kernel for Ensemble"):
            sample(model, spl, 10, key=0, engine="fused")
