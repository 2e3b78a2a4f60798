"""StaticMH / RWMH posterior-moment and interface tests.

≙ reference test/runtests.jl "StaticMH"/"RandomWalk"/"parallel sampling"
testsets (:56-110): the 2-parameter Gaussian (μ, σ) model with 300 obs from
N(0,1) and a σ ≥ 0 support guard must recover mean μ ≈ 0 ± 0.1 and
mean σ ≈ 1 ± 0.1. The reference uses 100k sequential draws; here the same
draw budget is a (chains × samples) batch — the batched-device shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    MCMCDistributed,
    MCMCSerial,
    MetropolisHastings,
    MvNormal,
    Normal,
    RWMH,
    StaticMH,
    guarded_logdensity,
    sample,
)

# Shared fixture model (≙ test/runtests.jl:22-31)
DATA = jnp.asarray(np.random.default_rng(1234).normal(size=300), jnp.float32)


def _density(theta):
    mu, sigma = theta[0], theta[1]
    return jnp.sum(Normal(mu, sigma).log_prob(DATA))


LOGDENSITY = guarded_logdensity(
    support_fn=lambda t: t[1] >= 0,
    logdensity_fn=_density,
    safe_params_fn=lambda t: jnp.stack([t[0], jnp.maximum(t[1], 0.1)]),
)
MODEL = DensityModel(LOGDENSITY, dimension=2)


def _check_moments(chains, atol=0.1):
    assert abs(float(chains["μ"].mean()) - 0.0) < atol
    assert abs(float(chains["σ"].mean()) - 1.0) < atol


class TestStaticMH:
    @pytest.mark.parametrize(
        "spl",
        [
            StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)]),
            StaticMH(MvNormal.standard(2)),
            StaticMH(2),
        ],
        ids=["list", "mvnormal", "int"],
    )
    def test_posterior_moments(self, spl):
        chains = sample(
            MODEL, spl, 4000, key=1, num_chains=32,
            discard_initial=500, chain_type="chains", param_names=["μ", "σ"],
        )
        _check_moments(chains)


class TestRWMH:
    @pytest.mark.parametrize(
        "spl",
        [
            RWMH([Normal(0.0, 0.1), Normal(0.0, 0.1)]),
            RWMH(MvNormal(jnp.zeros(2), scale=0.1)),
        ],
        ids=["list", "mvnormal"],
    )
    def test_posterior_moments(self, spl):
        chains = sample(
            MODEL, spl, 4000, key=2, num_chains=32,
            discard_initial=1000, chain_type="chains", param_names=["μ", "σ"],
            initial_params=jnp.asarray([0.0, 1.0]),
        )
        _check_moments(chains)

    def test_rwmh_int_ctor(self):
        # RWMH(2) uses a unit-scale standard normal increment — wide for this
        # posterior but still correct (reference runs 200k draws @ atol 0.15).
        chains = sample(
            MODEL, RWMH(2), 4000, key=3, num_chains=64,
            discard_initial=1000, chain_type="chains", param_names=["μ", "σ"],
            initial_params=jnp.asarray([0.0, 1.0]),
        )
        _check_moments(chains, atol=0.15)


class TestParallel:
    """≙ reference "parallel sampling" (4 chains × 10k, Distributed+Threads).

    Here MCMCDistributed = shard_map over the 8-device virtual CPU mesh.
    """

    def test_shard_map_chains(self):
        spl = StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)])
        chains = sample(
            MODEL, spl, 3000, key=4, num_chains=16,
            chain_method=MCMCDistributed(), discard_initial=500,
            chain_type="chains", param_names=["μ", "σ"],
        )
        assert chains.n_chains == 16
        _check_moments(chains)

    def test_serial_matches_vmap(self):
        spl = StaticMH([Normal(0.0, 1.0), Normal(0.0, 1.0)])
        kw = dict(key=5, num_chains=2, discard_initial=0)
        # vectorized=False: the per-chain-kernel path is bit-compatible with
        # MCMCSerial (the vectorized path uses batched RNG, equal only in
        # distribution).
        r_vmap = sample(MODEL, spl, 50, vectorized=False, **kw)
        r_seq = sample(MODEL, spl, 50, chain_method=MCMCSerial(), **kw)
        np.testing.assert_allclose(
            np.asarray(r_vmap.transitions.lp),
            np.asarray(r_seq.transitions.lp),
            rtol=1e-6,
        )


class TestSymmetricSampling:
    def test_symmetric_rwmh_normal_target(self):
        """≙ reference symmetric-proposal sampling test (:246-256): RWMH with
        a symmetric proposal lacking log_prob samples Normal(5, 0.7)."""
        from advancedmh_tpu import SymmetricRandomWalkProposal
        from tests.test_proposals import CustomNormal

        m = DensityModel(lambda x: Normal(5.0, 0.7).log_prob(x))
        spl = MetropolisHastings(SymmetricRandomWalkProposal(CustomNormal()))
        chains = sample(
            m, spl, 4000, key=6, num_chains=32, discard_initial=500,
            chain_type="chains", param_names=["x"],
        )
        assert abs(float(chains["x"].mean()) - 5.0) < 0.05
        assert abs(float(chains["x"].std()) - 0.7) < 0.05

    def test_asymmetric_without_logpdf_raises(self):
        from tests.test_proposals import CustomNormal

        m = DensityModel(lambda x: Normal(5.0, 0.7).log_prob(x))
        spl = MetropolisHastings(RWMH(CustomNormal()).proposal)
        with pytest.raises(NotImplementedError):
            sample(m, spl, 10, key=7)

    def test_rwmh_flags_zero_mean_gaussians_symmetric(self):
        """Zero-mean Gaussian increments are provably symmetric: RWMH sets
        the static flag so the q-ratio is a trace-time 0 instead of two
        cancelling logpdf evaluations per step."""
        assert RWMH(2).proposal.symmetric
        assert RWMH(MvNormal(jnp.zeros(3), scale=0.1)).proposal.symmetric
        assert RWMH(Normal(0.0, 1.0)).proposal.symmetric
        # nonzero mean or non-Gaussian payloads stay unflagged
        assert not RWMH(MvNormal(jnp.ones(2), scale=0.1)).proposal.symmetric
        from advancedmh_tpu import Laplace

        assert not RWMH(Laplace(0.0, 1.0)).proposal.symmetric


class TestFullCovarianceProposal:
    def test_scale_tril_batched_xla_path(self):
        """Full-covariance RWMH on the default chain-batched XLA path
        (regression: triangular_solve does not broadcast batch dims)."""
        cov = np.array([[1.0, 0.6], [0.6, 1.0]], dtype=np.float32)
        L = np.linalg.cholesky(0.5 * cov).astype(np.float32)
        # nonzero-mean tril proposal keeps symmetric=False → q-ratio path
        spl = RWMH(MvNormal(jnp.asarray([1e-7, 0.0]), scale_tril=jnp.asarray(L)))
        assert not spl.proposal.symmetric
        mv = MvNormal.from_cov(jnp.zeros(2), jnp.asarray(cov))
        m = DensityModel(mv.log_prob, dimension=2)
        res = sample(
            m, spl, 3000, key=11, num_chains=32, discard_initial=1000,
            initial_params=jnp.zeros(2),
        )
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        np.testing.assert_allclose(draws.mean(0), np.zeros(2), atol=0.1)
        np.testing.assert_allclose(np.cov(draws.T), cov, rtol=0.2, atol=0.1)
