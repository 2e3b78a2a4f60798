"""Multi-device (virtual 8-CPU mesh) tests: sharded emcee, graft entry."""
import jax
import numpy as np
import pytest

from advancedmh_tpu import (
    DensityModel,
    Ensemble,
    InverseGamma,
    Normal,
    StretchProposal,
)
from advancedmh_tpu.parallel import make_mesh
from advancedmh_tpu.parallel.emcee import (
    build_sharded_ensemble_step,
    init_sharded_ensemble,
    sharded_ensemble_sample,
)
from tests.test_emcee import M_TRUE, S_TRUE, _logprob_untransformed


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return make_mesh(axis="walkers")


class TestShardedEmcee:
    def test_step_shapes(self, mesh):
        spl = Ensemble(
            64, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        model = DensityModel(_logprob_untransformed)
        halves = init_sharded_ensemble(spl, model, jax.random.key(0), mesh)
        step = build_sharded_ensemble_step(spl, model, mesh)
        pA, lpA, pB, lpB, acc = step(jax.random.key(1), halves)
        assert pA.shape == (32, 2) and lpA.shape == (32,)
        assert acc.shape == (64,)

    def test_walker_count_divisibility(self, mesh):
        spl = Ensemble(10, StretchProposal([Normal(0.0, 1.0)]))
        with pytest.raises(ValueError, match="divide evenly"):
            build_sharded_ensemble_step(
                spl, DensityModel(lambda x: Normal(0.0, 1.0).log_prob(x[0])), mesh
            )

    def test_walk_move_sharded(self, mesh):
        """WalkProposal under walker sharding: the all_gather hands each
        device the FULL frozen half, so the walk covariance matches the
        unsharded sampler and the analytic means are recovered."""
        from advancedmh_tpu import WalkProposal

        spl = Ensemble(
            256, WalkProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        model = DensityModel(_logprob_untransformed)
        params, lp, acc = sharded_ensemble_sample(
            spl, model, 2200, jax.random.key(4), mesh
        )
        draws = np.asarray(params[1200:]).reshape(-1, 2)
        assert abs(draws[:, 0].mean() - S_TRUE) < 0.12
        assert abs(draws[:, 1].mean() - M_TRUE) < 0.12

    def test_posterior_means_sharded(self, mesh):
        """The sharded red-black sampler recovers the emcee test posterior
        (≙ reference test/emcee.jl analytic means)."""
        spl = Ensemble(
            512, StretchProposal([InverseGamma(2.0, 3.0), Normal(0.0, 1.0)])
        )
        model = DensityModel(_logprob_untransformed)
        params, lp, acc = sharded_ensemble_sample(
            spl, model, 600, jax.random.key(2), mesh
        )
        draws = np.asarray(params[100:]).reshape(-1, 2)  # burn 100
        assert abs(draws[:, 0].mean() - S_TRUE) < 0.1
        assert abs(draws[:, 1].mean() - M_TRUE) < 0.1


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert out[0].shape == (8192, 2)

    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestMultihostHelpers:
    """Single-process semantics of the multi-host orchestration layer
    (parallel/multihost.py): these are what a pod launch script calls on
    every host; on one host they must be exact no-ops with sane values."""

    def test_initialize_single_process_noop(self):
        from advancedmh_tpu.parallel import multihost

        multihost.initialize()  # no coordinator env → must not distribute
        assert multihost.is_coordinator()
        assert multihost.process_local_chains(1024) == 1024

    def test_global_chain_mesh_spans_all_devices(self):
        from advancedmh_tpu.parallel import multihost

        m = multihost.global_chain_mesh()
        assert m.shape["chains"] == len(jax.devices())

    def test_multi_host_env_detection(self, monkeypatch):
        from advancedmh_tpu.parallel import multihost

        monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert not multihost._multi_host_env()  # nothing set = single host
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
        assert multihost._multi_host_env()
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
        monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
        assert multihost._multi_host_env()
