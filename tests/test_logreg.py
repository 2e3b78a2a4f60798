"""Logistic-regression target model: consistency across the three density
forms (scalar / chain-batched / kernel tile) and posterior recovery.

This is the high-dimensional matmul showcase target (models/targets.py); the
reference has no analog model, but it exercises the same black-box
DensityModel capability (reference src/AdvancedMH.jl:52-54) at d ≫ 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import MALA, MvNormal, RWMH, sample
from advancedmh_tpu.models.targets import logistic_regression_model


@pytest.fixture(scope="module")
def model():
    return logistic_regression_model(n_obs=128, dim=8, seed=3)


class TestDensityForms:
    def test_gradient_matches_autodiff(self, model):
        beta = jnp.asarray(
            np.random.default_rng(0).normal(size=8), jnp.float32
        )
        lp, g = model.logdensity_and_gradient_fn(beta)
        lp_ad, g_ad = jax.value_and_grad(model.logdensity_fn)(beta)
        np.testing.assert_allclose(float(lp), float(lp_ad), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(g_ad), rtol=1e-4, atol=1e-4
        )

    def test_batched_matches_vmap(self, model):
        betas = jnp.asarray(
            np.random.default_rng(1).normal(size=(16, 8)), jnp.float32
        )
        np.testing.assert_allclose(
            np.asarray(model.logdensity_batched_fn(betas)),
            np.asarray(jax.vmap(model.logdensity_fn)(betas)),
            rtol=1e-5, atol=1e-4,
        )

    def test_tile_matches_batched(self, model):
        betas = jnp.asarray(
            np.random.default_rng(2).normal(size=(16, 8)), jnp.float32
        )
        consts = tuple(jnp.asarray(c) for c in model.tile_consts)
        tile = model.tile_density(betas.T, *consts)  # (1, 16)
        np.testing.assert_allclose(
            np.asarray(tile[0]),
            np.asarray(model.logdensity_batched_fn(betas)),
            rtol=1e-5, atol=1e-4,
        )

    def test_softplus_stable_at_extreme_logits(self, model):
        big = jnp.full((8,), 50.0, jnp.float32)
        lp, g = model.logdensity_and_gradient_fn(big)
        assert np.isfinite(float(lp)) and np.all(np.isfinite(np.asarray(g)))


class TestPosterior:
    def test_mala_recovers_map(self, model):
        # The log-posterior is strictly concave → unique MAP; the posterior
        # mean of a near-Gaussian posterior should sit close to it.
        beta = jnp.zeros(8, jnp.float32)
        for _ in range(500):
            _, g = model.logdensity_and_gradient_fn(beta)
            beta = beta + 0.05 * g
        beta_map = np.asarray(beta)

        res = sample(
            model, MALA.langevin(0.08), 1500, key=0, num_chains=64,
            discard_initial=500, initial_params=jnp.asarray(beta),
        )
        post_mean = np.asarray(res.transitions.params).mean(axis=(0, 1))
        # the logistic posterior is skewed: its mean sits near but not at the
        # MAP, further out for large |β| — allow a relative margin
        np.testing.assert_allclose(post_mean, beta_map, atol=0.25, rtol=0.15)
        acc = np.asarray(res.transitions.accepted).mean()
        assert 0.2 < acc < 0.99

    def test_rwmh_agrees_with_mala(self, model):
        spl = RWMH(MvNormal(jnp.zeros(8), scale=0.15))
        res = sample(
            model, spl, 3000, key=1, num_chains=64, discard_initial=1000,
            initial_params=jnp.zeros(8),
        )
        rw_mean = np.asarray(res.transitions.params).mean(axis=(0, 1))
        res2 = sample(
            model, MALA.langevin(0.08), 1500, key=2, num_chains=64,
            discard_initial=500, initial_params=jnp.zeros(8),
        )
        mala_mean = np.asarray(res2.transitions.params).mean(axis=(0, 1))
        np.testing.assert_allclose(rw_mean, mala_mean, atol=0.4)
