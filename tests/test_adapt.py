"""Step-size adaptation tests (beyond-parity; samplers/adapt.py).

The dual-averaging contract (Hoffman & Gelman 2014 §3.2): warmup tunes the
acceptance rate of a step-size-indexed family toward the target; after warmup
the averaged step size is frozen (the analog of RAM's frozen-S main phase,
≙ reference src/RobustAdaptiveMetropolis.jl:216-237).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    MvNormal,
    RWMH,
    StepSizeAdaptation,
    sample,
)
from tests.test_mh import MODEL


def _quadratic_model():
    SIG = np.array([[1.5, 0.35], [0.35, 1.0]], dtype=np.float32)
    P = np.linalg.inv(SIG).astype(np.float32)

    def ld(x):
        return -0.5 * x @ jnp.asarray(P) @ x

    return DensityModel(ld, dimension=2), SIG


class TestValidation:
    def test_target_accept_range(self):
        with pytest.raises(ValueError, match="target_accept"):
            StepSizeAdaptation.rwmh(2, target_accept=1.5)

    def test_positive_step_size(self):
        with pytest.raises(ValueError, match="initial_step_size"):
            StepSizeAdaptation.rwmh(2, initial_step_size=0.0)


class TestRWMHFamily:
    def test_acceptance_hits_target(self):
        """Start 100x too large: warmup must pull the post-warmup acceptance
        rate to the dimension-aware GRG optimum (0.352 at d=2; a fixed
        ε=10 run accepts ≈ nothing)."""
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0)
        res = sample(
            model, spl, 3000, key=0, num_chains=64, num_warmup=1500,
            initial_params=jnp.zeros(2), chain_type="raw",
        )
        acc = float(jnp.mean(res.transitions.accepted.astype(jnp.float32)))
        assert abs(acc - spl.target_accept) < 0.08

        fixed = sample(
            model, RWMH(MvNormal(jnp.zeros(2), scale=10.0)), 3000, key=0,
            num_chains=64, num_warmup=1500, initial_params=jnp.zeros(2),
            chain_type="raw",
        )
        acc_fixed = float(jnp.mean(fixed.transitions.accepted.astype(jnp.float32)))
        # The problem adaptation solves: the mistuned baseline accepts almost
        # nothing and sits far below the adapted rate.
        assert acc_fixed < 0.05
        assert acc_fixed < acc - 0.08

    def test_posterior_moments(self):
        """README 2-param Gaussian (≙ reference test/runtests.jl:56-94
        tolerances) sampled through the adapted family."""
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=2.0)
        chains = sample(
            MODEL, spl, 4000, key=1, num_chains=32, num_warmup=2000,
            initial_params=jnp.asarray([0.0, 1.0]), chain_type="chains",
            param_names=["μ", "σ"],
        )
        assert abs(float(chains["μ"].mean())) < 0.1
        assert abs(float(chains["σ"].mean()) - 1.0) < 0.1

    def test_step_size_frozen_after_warmup(self):
        """log_eps_bar must not move in the main phase, and the main phase
        must use exp(log_eps_bar) (state surgery via direct kernel calls)."""
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2)
        key = jax.random.key(0)
        _, state = spl.init(key, model, jnp.zeros(2))
        for j in range(50):
            _, state = spl.step_warmup(jax.random.fold_in(key, j), state, model)
        bar = float(state.log_eps_bar)
        t_warm = int(state.t)
        for j in range(50, 60):
            _, state = spl.step(jax.random.fold_in(key, j), state, model)
        assert float(state.log_eps_bar) == bar
        assert int(state.t) == t_warm  # counter only advances in warmup


class TestMALAFamily:
    def test_acceptance_hits_mala_target(self):
        model, SIG = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=3.0)
        res = sample(
            model, spl, 3000, key=2, num_chains=64, num_warmup=1500,
            initial_params=jnp.zeros(2), chain_type="raw",
        )
        acc = float(jnp.mean(res.transitions.accepted.astype(jnp.float32)))
        assert abs(acc - 0.574) < 0.08

    def test_covariance_recovery(self):
        """≙ the reference MALA covariance test (test/runtests.jl:334-365)
        but with the step size found by adaptation instead of hand-tuning."""
        model, SIG = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=0.1)
        res = sample(
            model, spl, 4000, key=3, num_chains=64, num_warmup=2000,
            initial_params=jnp.zeros(2), chain_type="raw",
        )
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert np.abs(np.cov(draws.T) - SIG).max() < 0.2


class TestBarkerFamily:
    def test_acceptance_hits_barker_target(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.barker(initial_step_size=5.0)
        res = sample(
            model, spl, 2000, key=4, num_chains=64, num_warmup=1200,
            initial_params=jnp.zeros(2), chain_type="raw",
        )
        acc = float(jnp.mean(res.transitions.accepted.astype(jnp.float32)))
        assert abs(acc - 0.57) < 0.1


class TestPerChainAdaptation:
    def test_vmapped_chains_adapt_independently(self):
        """Under vmap each chain carries its own (log_eps, h_bar): two chains
        started at wildly different ε converge to similar adapted scales."""
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=1.0)
        key = jax.random.key(5)

        def run(chain_key):
            _, state = spl.init(chain_key, model, jnp.zeros(2))

            def body(s, k):
                _, s = spl.step_warmup(k, s, model)
                return s, None

            state, _ = jax.lax.scan(body, state, jax.random.split(chain_key, 800))
            return state.log_eps_bar

        bars = jax.vmap(run)(jax.random.split(key, 8))
        eps = np.exp(np.asarray(bars))
        # All chains find a scale in the sane RWMH band for this target
        # (≈ 2.38/√d · σ ≈ 1.5-2.5), none stuck at pathological values.
        assert eps.min() > 0.3 and eps.max() < 6.0
        assert eps.std() / eps.mean() < 0.5


class TestBatchedKernel:
    """step_batched/step_warmup_batched (the batched hot path): per-chain
    adaptation semantics match the vmap-of-single-chain kernels."""

    def test_batched_matches_single_chain_semantics(self):
        model, _ = _quadratic_model()
        spl = StepSizeAdaptation.rwmh(2, initial_step_size=10.0)
        kw = dict(key=0, num_chains=64, num_warmup=1500,
                  initial_params=jnp.zeros(2), chain_type="raw")
        assert spl.has_batched_kernel
        vec = sample(model, spl, 3000, vectorized=True, **kw)
        ref = sample(model, spl, 3000, vectorized=False, **kw)
        for r in (vec, ref):
            acc = float(jnp.mean(r.transitions.accepted.astype(jnp.float32)))
            assert abs(acc - spl.target_accept) < 0.08
        eps_v = np.exp(np.asarray(vec.final_state.log_eps_bar))
        eps_r = np.exp(np.asarray(ref.final_state.log_eps_bar))
        # Each chain adapts its own eps in both paths; the adapted
        # populations must agree in distribution (not bitwise: the batched
        # path hashes one key per step, the single path one per chain-step).
        assert eps_v.shape == eps_r.shape == (64,)
        assert 0.7 < np.median(eps_v) / np.median(eps_r) < 1.4
        assert eps_v.std() / eps_v.mean() < 0.5

    def test_mala_family_batched_hits_target(self):
        model, SIG = _quadratic_model()
        spl = StepSizeAdaptation.mala(initial_step_size=3.0)
        res = sample(
            model, spl, 3000, key=2, num_chains=64, num_warmup=1500,
            initial_params=jnp.zeros(2), chain_type="raw", vectorized=True,
        )
        acc = float(jnp.mean(res.transitions.accepted.astype(jnp.float32)))
        assert abs(acc - 0.574) < 0.08
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert np.abs(np.cov(draws.T) - SIG).max() < 0.2

    def test_wrapped_ram_batched_keeps_inner_adaptation(self):
        """Batched warmup delegates to the inner step_warmup_batched: a
        wrapped RAM adapts its S (off-diagonal moves away from 0)."""
        model, _ = _quadratic_model()
        from advancedmh_tpu import RobustAdaptiveMetropolis

        # Matrix-valued families add the matrix axes themselves (eps arrives
        # as a scalar in the single-chain path and as (C, 1) batched).
        spl = StepSizeAdaptation(
            lambda eps: RobustAdaptiveMetropolis(
                S=jnp.reshape(eps, jnp.shape(eps) + (1,))
                * jnp.eye(2, dtype=jnp.float32)
            ),
            initial_step_size=0.5,
        )
        res = sample(
            model, spl, 500, key=3, num_chains=8, num_warmup=500,
            initial_params=jnp.zeros(2), chain_type="raw", vectorized=True,
        )
        S = np.asarray(res.final_state.inner.S)
        assert S.shape == (8, 2, 2)
        assert np.abs(S[:, 1, 0]).max() > 1e-3
