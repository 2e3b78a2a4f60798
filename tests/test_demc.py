"""Differential-evolution MCMC (DE-MC, ter Braak 2006) tests.

Beyond-parity sampler; correctness is checked against the same analytic
posteriors the reference uses for its ensemble method (test/emcee.jl:
s̄ = 49/24, m̄ = 7/6 conjugate-ish model) plus covariance self-tuning on a
correlated Gaussian (the property DE-MC is *for*).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    DifferentialEvolution,
    InverseGamma,
    MvNormal,
    Normal,
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


class TestPosterior:
    def test_conjugate_means(self):
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(
            1000, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]
        )
        chains = sample(
            model, spl, 1000, key=100, chain_type="chains",
            param_names=["s", "m"], discard_initial=200,
        )
        assert chains.n_chains == 1000  # members as chains (3-D path)
        assert abs(float(chains["s"].mean()) - S_TRUE) < 0.1
        assert abs(float(chains["m"].mean()) - M_TRUE) < 0.1

    def test_correlated_gaussian_covariance(self):
        """DE-MC's difference-vector proposal self-tunes to the target
        covariance — the population recovers a correlated Σ."""
        cov = np.array([[1.5, 0.9], [0.9, 1.0]], np.float32)
        prec = jnp.asarray(np.linalg.inv(cov))
        model = DensityModel(lambda th: -0.5 * th @ prec @ th, dimension=2)
        spl = DifferentialEvolution(512, MvNormal.standard(2))
        res = sample(model, spl, 2000, key=7, discard_initial=500)
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.2)


class TestSnooker:
    def test_conjugate_means_with_snooker(self):
        """Mixing 30% snooker updates preserves the analytic posterior —
        a wrong ‖y−z‖^{d−1}/‖x−z‖^{d−1} Hastings factor shows up here as
        moment bias."""
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(
            1000, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)],
            snooker_probability=0.3,
        )
        res = sample(model, spl, 1000, key=100, discard_initial=200)
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert abs(draws[:, 0].mean() - S_TRUE) < 0.1
        assert abs(draws[:, 1].mean() - M_TRUE) < 0.1

    def test_snooker_heavy_covariance(self):
        """Snooker-dominated mixing (70%) still recovers a correlated Σ in
        d=3 — exercises the d−1 norm exponent (d>2 matters)."""
        rng = np.random.default_rng(0)
        a = rng.normal(size=(3, 3)).astype(np.float32)
        cov = a @ a.T + 0.5 * np.eye(3, dtype=np.float32)
        prec = jnp.asarray(np.linalg.inv(cov))
        model = DensityModel(lambda th: -0.5 * th @ prec @ th, dimension=3)
        spl = DifferentialEvolution(
            512, MvNormal.standard(3), snooker_probability=0.7
        )
        res = sample(model, spl, 3000, key=9, discard_initial=1000)
        draws = np.asarray(res.transitions.params).reshape(-1, 3)
        np.testing.assert_allclose(
            np.cov(draws.T), cov, atol=0.35 * float(np.abs(cov).max())
        )

    def test_snooker_pytree_params(self):
        """The line projection dots/norms reduce over ALL leaves jointly."""
        model = DensityModel(
            lambda th: Normal(0.0, 1.0).log_prob(th["a"])
            + jnp.sum(Normal(0.0, 1.0).log_prob(th["b"]))
        )
        spl = DifferentialEvolution(
            64, {"a": Normal(0.0, 1.0), "b": MvNormal.standard(3)},
            snooker_probability=0.4,
        )
        res = sample(model, spl, 400, key=3, discard_initial=150)
        a = np.asarray(res.transitions.params["a"])
        b = np.asarray(res.transitions.params["b"])
        assert abs(a.mean()) < 0.15
        assert abs(float(a.var()) - 1.0) < 0.3
        assert abs(b.mean()) < 0.15

    def test_bad_probability_raises(self):
        with pytest.raises(ValueError, match="snooker_probability"):
            DifferentialEvolution(8, Normal(0.0, 1.0), snooker_probability=1.5)


class TestMechanics:
    def test_member_shapes(self):
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(8, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        res = sample(model, spl, 5, key=0)
        assert np.asarray(res.transitions.params).shape == (5, 8, 2)
        assert np.asarray(res.transitions.lp).shape == (5, 8)

    def test_initial_params_override(self):
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(6, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        init = jnp.tile(jnp.asarray([2.0, 1.0]), (6, 1))
        res = sample(model, spl, 3, key=0, initial_params=init, discard_initial=0)
        np.testing.assert_allclose(np.asarray(res.transitions.params)[0], init)

    def test_member_count_mismatch_raises(self):
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(8, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        bad = jnp.tile(jnp.asarray([2.0, 1.0]), (6, 1))
        with pytest.raises(ValueError, match="n_members"):
            sample(model, spl, 3, key=0, initial_params=bad)

    def test_odd_or_tiny_population_raises(self):
        with pytest.raises(ValueError, match="even"):
            DifferentialEvolution(7, Normal(0.0, 1.0))
        with pytest.raises(ValueError, match="even"):
            DifferentialEvolution(4, Normal(0.0, 1.0))

    def test_acceptance_happens(self):
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(64, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        res = sample(model, spl, 100, key=1)
        acc_rate = np.asarray(res.transitions.accepted)[1:].mean()
        assert 0.05 < acc_rate < 0.95

    def test_pytree_params(self):
        """DE moves apply leaf-wise over pytree params."""
        model = DensityModel(
            lambda th: Normal(0.0, 1.0).log_prob(th["a"])
            + jnp.sum(Normal(0.0, 1.0).log_prob(th["b"]))
        )
        spl = DifferentialEvolution(
            64, {"a": Normal(0.0, 1.0), "b": MvNormal.standard(3)}
        )
        res = sample(model, spl, 300, key=3, discard_initial=100)
        a = np.asarray(res.transitions.params["a"])
        b = np.asarray(res.transitions.params["b"])
        assert a.shape == (300, 64)
        assert b.shape == (300, 64, 3)
        assert abs(a.mean()) < 0.15
        assert abs(b.mean()) < 0.15

    def test_fused_member_count_must_align(self):
        """engine='fused' has no DE-MC kernel: it raises before anything is
        traced."""
        model = DensityModel(_logprob_untransformed)
        spl = DifferentialEvolution(
            1000, [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]
        )
        with pytest.raises(ValueError, match="no kernel for Differential"):
            sample(model, spl, 10, key=0, engine="fused")

    def test_mode_jump_hops_bimodal(self):
        """When the population spans two well-separated modes, γ=1 jump
        moves ride cross-mode difference vectors — individual members hop
        between modes (the ter Braak 2006 mode-jumping property; a plain
        random-walk with comparable step scale would leave every member
        stuck in its starting mode)."""
        def bimodal(th):
            return jnp.logaddexp(
                MvNormal(jnp.asarray([-4.0, 0.0]), scale=0.5).log_prob(th),
                MvNormal(jnp.asarray([4.0, 0.0]), scale=0.5).log_prob(th),
            )

        model = DensityModel(bimodal, dimension=2)
        # Interleave modes so BOTH red-black halves span both modes (the
        # frozen half supplies the cross-mode difference vectors).
        base = np.tile([[-4.0, 0.0], [4.0, 0.0]], (64, 1)).astype(np.float32)
        spl = DifferentialEvolution(
            128, MvNormal.standard(2), jump_probability=0.2
        )
        res = sample(model, spl, 1000, key=11,
                     initial_params=jnp.asarray(base), discard_initial=100)
        x0 = np.asarray(res.transitions.params)[..., 0]  # (S, members)
        right_frac = (x0[-1] > 0).mean()
        assert 0.25 < right_frac < 0.75  # occupancy stays balanced
        # members actually switch modes (not just stay where they started)
        switched = ((x0[0] > 0) != (x0[-1] > 0)).mean()
        assert switched > 0.1
