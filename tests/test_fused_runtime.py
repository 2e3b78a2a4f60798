"""CPU-side units of the fused-engine runtime (runtime/fused.py).

The kernel itself is exercised in tests/test_pallas.py (interpret mode on
the CPU, compiled on the card); these tests cover the engine-independent
plumbing: block selection, chain padding, the shard wrapper, proposal-scale
extraction and the guards that keep every other sampler off the engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import MvNormal, Normal, RWMH, StaticMH
from advancedmh_tpu.parallel.mesh import make_mesh
from advancedmh_tpu.runtime.fused import (
    MAX_BLOCK,
    MIN_BLOCK,
    SM_COUNT,
    STATE_BUDGET,
    _extract_rw_scale,
    _fused_tiling,
    _pad_chains,
    _shard_fused,
    launch_shape,
)


class TestFusedTiling:
    def test_power_of_two_keeps_max_tile(self):
        # enough programs for every SM at the largest block: it stays
        c = SM_COUNT * MAX_BLOCK
        assert _fused_tiling(c, 2) == (c, MAX_BLOCK)
        assert _fused_tiling(16384, 2, max_block=64) == (16384, 64)
        # 8192 / 64 = 128 programs < SM_COUNT: the block halves
        assert _fused_tiling(8192, 2, max_block=64) == (8192, 32)

    def test_ragged_pads_to_lane_unit(self):
        # padded up to a multiple of the chosen block, never below the ask
        assert _fused_tiling(1000, 2) == (1008, MIN_BLOCK)
        assert _fused_tiling(16385, 2, max_block=64) == (16448, 64)
        assert _fused_tiling(1, 2) == (MIN_BLOCK, MIN_BLOCK)

    def test_prime_lane_groups_fall_back_to_min_tile(self):
        # too few programs to cover the SMs: the block halves down to the
        # minimum (4096 chains → 32-chain blocks = 128 programs < 132)
        assert _fused_tiling(4096, 2) == (4096, MIN_BLOCK)
        assert -(-4096 // MIN_BLOCK) >= SM_COUNT

    def test_mesh_unit_scales_with_devices(self):
        mesh = make_mesh(axis="chains")  # 8 virtual CPU devices (conftest)
        n = mesh.shape["chains"]
        c_pad, block = _fused_tiling(1000, 2, n)
        assert c_pad % (block * n) == 0 and c_pad >= 1000
        assert (c_pad // n) % block == 0

    def test_tile_never_exceeds_max(self):
        for c in (7, 129, 999, 4096, 5000, 1 << 20):
            c_pad, block = _fused_tiling(c, 2, max_block=32)
            assert MIN_BLOCK <= block <= 32 and c_pad % block == 0
            assert c_pad >= c and block & (block - 1) == 0

    def test_vmem_cap_scales_with_dimension(self):
        # the (d, block) register state is capped: d=32 → 32-chain blocks,
        # and never below the pl.dot minimum width
        big = 1 << 20
        assert _fused_tiling(big, 2)[1] == min(MAX_BLOCK, STATE_BUDGET // 2)
        assert _fused_tiling(big, 32)[1] == min(MAX_BLOCK, STATE_BUDGET // 32)
        assert _fused_tiling(big, 4096)[1] == MIN_BLOCK

    def test_sub_lane_tile_rejected(self):
        for bad in (8, 48):
            with pytest.raises(ValueError, match="power of two"):
                _fused_tiling(8192, 2, max_block=bad)

    @pytest.mark.parametrize("chains,d,block,warps", [
        (16384, 2, 64, 2),  # README model: the sweep's best (64, 2)
        (8192, 32, 16, 4),  # logreg d=32: the sweep's best (16, 4)
        (4096, 2, 16, 2),
        (8192, 128, 16, 4),
    ])
    def test_launch_shape(self, chains, d, block, warps):
        c_pad, launch = launch_shape(chains, d)
        assert c_pad == chains
        assert launch == dict(block_chains=block, num_warps=warps)


class TestPadChains:
    def test_roundtrip_and_edge_padding(self):
        seen = {}

        def run(a, b, seed):
            seen["shapes"] = (a.shape, b.shape)
            seen["last_col"] = np.asarray(a[:, -1])
            return a * 2.0, b + 1.0

        w = _pad_chains(run, 5, 128)
        a = jnp.arange(10.0, dtype=jnp.float32).reshape(2, 5)
        b = jnp.ones((1, 5), jnp.float32)
        o1, o2 = w(a, b, jnp.int32(3))
        assert seen["shapes"] == ((2, 128), (1, 128))
        # edge mode: padded columns replicate the last real chain
        np.testing.assert_array_equal(seen["last_col"], np.asarray(a[:, -1]))
        assert o1.shape == (2, 5) and o2.shape == (1, 5)
        np.testing.assert_array_equal(np.asarray(o1), 2 * np.asarray(a))

    def test_noop_when_aligned(self):
        def run(a, seed):
            return a

        assert _pad_chains(run, 256, 256) is run


class TestShardFused:
    """Mechanics of the fused-engine shard_map wrapper on the 8-device
    virtual CPU mesh. ``run`` is stubbed with a pure-jnp function of the
    engine's calling convention ``run(params_t, lp, ctl) -> (samples, lps,
    accs)`` with chains on every last axis."""

    @staticmethod
    def _stub(x, lp, ctl):
        w = x.shape[1]
        first = jnp.full((1, 1, w), ctl[2].astype(jnp.float32))
        return x[None] * 2.0, lp[None] + 1.0, first

    def test_seed_stride_and_output_specs(self):
        """Each shard sees its first global chain index in ctl[2], so the
        shards draw from disjoint counter ranges."""
        mesh = make_mesh(axis="chains")
        n = mesh.shape["chains"]
        C = 16 * n
        x = jnp.asarray(
            np.random.default_rng(0).normal(size=(2, C)), jnp.float32
        )
        lp = jnp.ones((1, C), jnp.float32)
        ctl = jnp.asarray([7, 9, 0, 0], jnp.uint32)
        s, l, first = _shard_fused(self._stub, mesh, "chains")(x, lp, ctl)
        starts = np.asarray(first)[0, 0].reshape(n, C // n)
        np.testing.assert_array_equal(
            starts, np.repeat(np.arange(n)[:, None] * (C // n), C // n, 1)
        )
        assert s.shape == (1, 2, C) and l.shape == (1, 1, C)

    def test_matches_unsharded_stub(self):
        mesh = make_mesh(axis="chains")
        C = 16 * mesh.shape["chains"]
        x = jnp.asarray(
            np.random.default_rng(1).normal(size=(2, C)), jnp.float32
        )
        lp = jnp.zeros((1, C), jnp.float32)
        ctl = jnp.zeros((4,), jnp.uint32)
        sharded = _shard_fused(self._stub, mesh, "chains")(x, lp, ctl)
        unsharded = self._stub(x, lp, ctl)
        np.testing.assert_allclose(sharded[0], unsharded[0])
        np.testing.assert_allclose(sharded[1], unsharded[1])


class TestExtractScale:
    def test_mvnormal_diag(self):
        spl = RWMH(MvNormal(jnp.zeros(3), scale=0.2))
        np.testing.assert_allclose(_extract_rw_scale(spl, 3), 0.2 * np.ones(3))

    def test_scale_tril_passthrough(self):
        L = np.array([[1.0, 0.0], [0.5, 2.0]], np.float32)
        spl = RWMH(MvNormal(jnp.zeros(2), scale_tril=jnp.asarray(L)))
        np.testing.assert_allclose(_extract_rw_scale(spl, 2), L)

    def test_static_proposal_rejected(self):
        with pytest.raises(ValueError):
            _extract_rw_scale(StaticMH(Normal(0.0, 1.0)), 1)



def _removed_engine_samplers():
    """Every sampler that had a fused engine of its own before; they all
    run on the XLA engine now."""
    from advancedmh_tpu import (
        DRAM, MALA, MEADS, AdaptiveHMC, AdaptiveMetropolis, Barker, ChEESHMC,
        DelayedRejection, DifferentialEvolution, EllipticalSlice, Ensemble,
        HamiltonianMC, InverseGamma, MultipleTryMetropolis,
        PreconditionedCrankNicolson, RandomWalkProposal, ReplicaExchange,
        RobustAdaptiveMetropolis, SliceSampler, StepSizeAdaptation,
        StretchProposal,
    )

    prior = MvNormal(jnp.zeros(2))
    rw = RandomWalkProposal(MvNormal(jnp.zeros(2), scale=0.5), symmetric=True)
    two = [InverseGamma(2.0, 3.0), Normal(0.0, 1.0)]
    return {
        "AdaptiveMetropolis": AdaptiveMetropolis(),
        "DRAM": DRAM(),
        "Barker": Barker(step_size=0.9),
        "DifferentialEvolution": DifferentialEvolution(256, two),
        "Ensemble": Ensemble(256, StretchProposal(two)),
        "EllipticalSlice": EllipticalSlice(prior),
        "pCN": PreconditionedCrankNicolson(prior),
        "HamiltonianMC": HamiltonianMC(0.3, 5),
        "AdaptiveHMC": AdaptiveHMC(n_leapfrog=3),
        "ChEESHMC": ChEESHMC(),
        "MALA": MALA.langevin(0.5),
        "MEADS": MEADS(),
        "SliceSampler": SliceSampler(),
        "StepSizeAdaptation": StepSizeAdaptation.rwmh(2),
        "RAM": RobustAdaptiveMetropolis(),
        "ReplicaExchange": ReplicaExchange(
            RWMH(MvNormal(jnp.zeros(2), scale=0.1)), betas=(1.0, 0.5)
        ),
        "DelayedRejection": DelayedRejection(rw, rw),
        "MultipleTryMetropolis": MultipleTryMetropolis(rw),
    }


class TestFusedDispatchGuards:
    """engine='fused' has a kernel for Gaussian random-walk MH only; every
    other sampler raises before anything is traced."""

    def _model(self):
        from advancedmh_tpu.models.targets import correlated_gaussian_model

        return correlated_gaussian_model(np.eye(2, dtype=np.float32))

    @pytest.mark.parametrize("name", sorted(_removed_engine_samplers()))
    def test_removed_engine_rejected(self, name):
        from advancedmh_tpu import sample

        spl = _removed_engine_samplers()[name]
        with pytest.raises(ValueError, match="no kernel for .*RWMH"):
            sample(self._model(), spl, 10, key=0, num_chains=256,
                   engine="fused", initial_params=jnp.zeros(2))

    def test_needs_tile_density(self):
        from advancedmh_tpu import DensityModel, sample

        model = DensityModel(lambda th: -0.5 * jnp.sum(th**2), dimension=2)
        with pytest.raises(ValueError, match="kernel-traceable density"):
            sample(model, RWMH(MvNormal(jnp.zeros(2), scale=0.5)), 10,
                   key=0, num_chains=256, engine="fused",
                   initial_params=jnp.zeros(2))

    def test_collect_states_rejected(self):
        from advancedmh_tpu import sample

        with pytest.raises(ValueError, match="collect_states"):
            sample(self._model(), RWMH(MvNormal(jnp.zeros(2), scale=0.5)),
                   10, key=0, num_chains=256, engine="fused",
                   collect_states=True, initial_params=jnp.zeros(2))

    def test_non_power_of_two_dimension_rejected(self):
        from advancedmh_tpu import sample
        from advancedmh_tpu.models.targets import correlated_gaussian_model

        spl = RWMH(MvNormal(jnp.zeros(3), scale=0.5))
        model = correlated_gaussian_model(np.eye(3, dtype=np.float32))
        with pytest.raises(ValueError, match="powers of two"):
            sample(model, spl, 10, key=0, num_chains=256, engine="fused",
                   initial_params=jnp.zeros(3))
