"""Fused RWMH kernel tests (ops/pallas_mh.py, runtime/fused.py).

On the CPU the kernel runs in the Pallas interpreter at reduced size: the
``interpret`` fixture rebinds the kernel factory with ``interpret=True``
(``sample()`` never switches to interpret mode by itself). The
``gpu``-marked cases compile the kernel for the card at real widths and
skip elsewhere; run them with the command the README names.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu import MCMCDistributed, MvNormal, RWMH, sample
from advancedmh_tpu.diagnostics.agreement import chain_moments, moments_agree
from advancedmh_tpu.models.targets import (
    correlated_gaussian_model,
    gaussian_mean_scale_model,
    logistic_regression_model,
)
from advancedmh_tpu.ops import pallas_mh
from advancedmh_tpu.runtime.chunked import sample_chunked


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(
        pallas_mh, "fused_rwmh_sample",
        functools.partial(pallas_mh.fused_rwmh_sample, interpret=True),
    )


def _data_mean(model):
    obs, mask = (np.asarray(c)[:, 0] for c in model.tile_consts)
    return obs[mask > 0].mean()


def _agree(fused, ref, n_sigma=4.0):
    ref_m = chain_moments(np.asarray(ref.transitions.params))
    fused_m = chain_moments(np.asarray(fused.transitions.params),
                            ref_m["mean"])
    ok, worst = moments_agree(fused_m, ref_m, n_sigma)
    assert ok, worst
    acc_f = np.asarray(fused.transitions.accepted).mean()
    acc_x = np.asarray(ref.transitions.accepted).mean()
    return acc_f, acc_x


READMEKW = dict(initial_params=jnp.asarray([0.0, 1.0]))


@pytest.mark.usefixtures("interpret")
class TestFusedRWMH:
    def test_posterior_matches_xla_path(self):
        """The kernel factory, driven directly, gives the XLA engine's
        posterior and acceptance rate."""
        model = gaussian_mean_scale_model()
        C, n, burn = 512, 400, 200
        run = pallas_mh.fused_rwmh_sample(
            model.tile_density, 2, 0.35, n, burn=burn,
            consts=model.tile_consts, block_chains=64, interpret=True,
        )
        x = jnp.tile(jnp.asarray([[0.0], [1.0]], jnp.float32), (1, C))
        lp0 = model.tile_density(x, *map(jnp.asarray, model.tile_consts))
        ctl = jnp.asarray([7, 0, 0, 0], jnp.uint32)
        samples, lps, accs = run(x, lp0, ctl)
        assert samples.shape == (n, 2, C) and lps.shape == (n, 1, C)
        ref = sample(
            model, RWMH(MvNormal(jnp.zeros(2), scale=0.35)), n, key=7,
            num_chains=C, discard_initial=burn + 1, **READMEKW,
        )
        fm = chain_moments(np.transpose(np.asarray(samples), (2, 0, 1)))
        xm = chain_moments(np.asarray(ref.transitions.params))
        ok, worst = moments_agree(fm, xm)
        assert ok, worst
        xla_acc = np.asarray(ref.transitions.accepted).mean()
        assert abs(float(accs.mean()) - xla_acc) < 0.03

    def test_sample_engine_fused(self):
        """sample(engine='fused') bundles like the XLA path and matches its
        posterior."""
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        kw = dict(key=3, num_chains=512, discard_initial=200, **READMEKW)
        c = sample(model, spl, 300, engine="fused", chain_type="chains",
                   param_names=["μ", "σ"], **kw)
        assert c.n_chains == 512 and c.n_samples == 300
        fused = sample(model, spl, 300, engine="fused", **kw)
        ref = sample(model, spl, 300, **kw)
        _agree(fused, ref)

    def test_fused_sharded_chain_method(self):
        """engine='fused' + MCMCDistributed on the 8-device virtual mesh:
        each shard runs the kernel on its chains from its own counter range,
        so the sharded run draws the unsharded run's bits (in the
        interpreter the arithmetic matches too, so the draws are equal)."""
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        kw = dict(key=13, num_chains=1024, engine="fused",
                  discard_initial=50, **READMEKW)
        res = sample(model, spl, 100, chain_method=MCMCDistributed(), **kw)
        assert res.transitions.params.shape == (1024, 100, 2)
        one = sample(model, spl, 100, **kw)
        np.testing.assert_array_equal(
            np.asarray(res.transitions.params),
            np.asarray(one.transitions.params),
        )
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert abs(draws[:, 0].mean() - _data_mean(model)) < 0.05

    def test_fused_rwmh_scale_tril(self):
        """Full-covariance proposal (scale_tril) via the in-kernel exact
        float32 matvec: recovers the correlated-Gaussian target."""
        SIG = np.array([[1.0, 0.6], [0.6, 1.0]], dtype=np.float32)
        model = correlated_gaussian_model(SIG)
        L = np.linalg.cholesky(0.5 * SIG).astype(np.float32)
        spl = RWMH(MvNormal(jnp.zeros(2), scale_tril=jnp.asarray(L)))
        res = sample(
            model, spl, 600, key=21, num_chains=512, engine="fused",
            discard_initial=200, initial_params=jnp.zeros(2),
        )
        m = chain_moments(np.asarray(res.transitions.params), np.zeros(2))
        assert np.all(np.abs(m["mean"]) < 4 * m["mean_se"])
        assert np.all(np.abs(m["var"] - 1.0) < 4 * m["var_se"])
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert abs(np.corrcoef(draws.T)[0, 1] - 0.6) < 0.05

    def test_chunked_fused_rwmh(self):
        """sample_chunked(engine='fused'): the step counter continues across
        chunks, so the chunked run equals the unchunked one."""
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        kw = dict(key=11, num_chains=256, engine="fused",
                  discard_initial=100, **READMEKW)
        res = sample_chunked(model, spl, 300, chunk_size=100, **kw)
        assert res.transitions.params.shape == (256, 300, 2)
        whole = sample(model, spl, 300, **kw)
        np.testing.assert_allclose(
            np.asarray(res.transitions.params),
            np.asarray(whole.transitions.params), rtol=1e-6,
        )
        c0 = np.asarray(res.transitions.params)[:, :100]
        c1 = np.asarray(res.transitions.params)[:, 100:200]
        assert not np.allclose(c0, c1)

    def test_fused_ragged_num_chains(self):
        """num_chains need not divide the block: the runtime pads the batch
        and trims outputs (runtime/fused.py::_pad_chains)."""
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        res = sample(
            model, spl, 200, key=17, num_chains=1000, engine="fused",
            discard_initial=100, **READMEKW,
        )
        assert res.transitions.params.shape == (1000, 200, 2)
        assert res.final_state.params.shape == (1000, 2)
        draws = np.asarray(res.transitions.params).reshape(-1, 2)
        assert abs(draws[:, 0].mean() - _data_mean(model)) < 0.05

    def test_fused_logreg_matmul_density(self):
        """Logistic regression: the in-kernel matmul density (IEEE float32
        ``pl.dot``) gives the XLA engine's posterior."""
        model = logistic_regression_model(n_obs=128, dim=16, seed=3)
        spl = RWMH(MvNormal(jnp.zeros(16), scale=0.1))
        kw = dict(key=23, num_chains=256, discard_initial=100,
                  initial_params=jnp.asarray(model.beta_true))
        fused = sample(model, spl, 200, engine="fused", **kw)
        with jax.default_matmul_precision("highest"):
            ref = sample(model, spl, 200, **kw)
        acc_f, acc_x = _agree(fused, ref)
        assert abs(acc_f - acc_x) < 0.03

    @pytest.mark.parametrize("n", [1, 25])
    def test_fused_odd_n_samples(self, n):
        """Any sample count, odd or one, emits exactly n finite draws."""
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        res = sample(
            model, spl, n, key=29, num_chains=64, engine="fused",
            discard_initial=10, **READMEKW,
        )
        assert res.transitions.params.shape == (64, n, 2)
        assert np.isfinite(np.asarray(res.transitions.lp)).all()

    def test_deterministic_given_seed(self):
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        kw = dict(num_chains=128, engine="fused", discard_initial=20,
                  thinning=3, **READMEKW)
        a = sample(model, spl, 30, key=3, **kw)
        b = sample(model, spl, 30, key=3, **kw)
        c = sample(model, spl, 30, key=4, **kw)
        np.testing.assert_array_equal(
            np.asarray(a.transitions.params), np.asarray(b.transitions.params)
        )
        assert not np.allclose(
            np.asarray(a.transitions.params), np.asarray(c.transitions.params)
        )


@pytest.mark.gpu
@pytest.mark.usefixtures("gpu")
class TestFusedRWMHOnCard:
    """The kernel compiled for the card at the widths users run."""

    def test_readme_16384_chains_matches_xla(self):
        model = gaussian_mean_scale_model()
        spl = RWMH(MvNormal(jnp.zeros(2), scale=0.35))
        kw = dict(key=5, num_chains=16384, discard_initial=500, **READMEKW)
        fused = sample(model, spl, 4000, engine="fused", **kw)
        ref = sample(model, spl, 4000, **kw)
        acc_f, acc_x = _agree(fused, ref)
        assert abs(acc_f - acc_x) < 0.01

    def test_logreg32_8192_chains_matches_xla(self):
        model = logistic_regression_model(n_obs=256, dim=32)
        spl = RWMH(MvNormal(jnp.zeros(32), scale=0.3))
        kw = dict(key=6, num_chains=8192, discard_initial=500,
                  initial_params=jnp.asarray(model.beta_true))
        fused = sample(model, spl, 4000, engine="fused", **kw)
        with jax.default_matmul_precision("highest"):
            ref = sample(model, spl, 4000, **kw)
        acc_f, acc_x = _agree(fused, ref)
        assert abs(acc_f - acc_x) < 0.01
