"""utils/transfer.py: the hardened device→host transfer guard.

The corruption the guard exists for (large pulls on an earlier accelerator
setup) is not reproducible on CPU; these tests pin its *mechanics*: bounded
slicing reproduces the full transfer bit-exactly, verification catches a
doctored buffer, and host-side inputs pass through.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from advancedmh_tpu.utils.transfer import (
    TransferVerificationError,
    _verify,
    safe_device_get,
)


class TestSafeDeviceGet:
    def test_chunked_pull_bitexact(self):
        x = jnp.arange(40000, dtype=jnp.float32).reshape(100, 400) * 1.5
        # 160 kB array, 4 kB chunks → 40+ slices
        out = safe_device_get(x, max_chunk_bytes=4096)
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, np.asarray(x))

    def test_small_and_scalar_single_shot(self):
        tree = {"a": jnp.ones((3, 2)), "b": jnp.float32(2.5)}
        out = safe_device_get(tree)
        np.testing.assert_array_equal(out["a"], np.ones((3, 2)))
        assert out["b"] == np.float32(2.5)

    def test_host_inputs_pass_through(self):
        tree = {"np": np.arange(5), "s": 3, "none": None}
        out = safe_device_get(tree)
        np.testing.assert_array_equal(out["np"], np.arange(5))
        assert out["s"] == 3

    def test_nan_elements_verify_clean(self):
        x = jnp.asarray([np.nan, 1.0, np.nan], jnp.float32)
        out = safe_device_get(x)
        assert np.isnan(out[0]) and np.isnan(out[2])

    def test_verification_catches_doctored_buffer(self):
        x = jnp.arange(64, dtype=jnp.float32)
        host = np.asarray(x).copy()
        host[-1] += 1.0  # simulate the corrupted-pull regime
        with pytest.raises(TransferVerificationError, match="mismatch"):
            _verify(x, host)

    def test_single_row_still_bounded(self):
        """shape[0] == 1 must not bypass the slicing: the flat view is
        sliced, so every transfer stays under the bound."""
        x = jnp.arange(30000, dtype=jnp.float32).reshape(1, 30000)
        out = safe_device_get(x, max_chunk_bytes=4096)
        np.testing.assert_array_equal(out, np.asarray(x))

    def test_verification_catches_interior_corruption(self):
        """The probe set is pseudo-random, not just the edges — a doctored
        interior element (the observed sparse-corruption mode) trips it."""
        x = jnp.arange(10000, dtype=jnp.float32)
        host = np.asarray(x).copy()
        from advancedmh_tpu.utils import transfer
        from advancedmh_tpu.utils.transfer import _probe_indices

        # The probe set varies per call (ADVICE r3: retries must sample
        # fresh indices); pin the call counter so the set we doctor is the
        # set _verify probes.
        transfer._probe_calls = 41
        interior = [i for i in _probe_indices(10000) if 0 < i < 9999]
        host[interior[len(interior) // 2]] += 0.5
        transfer._probe_calls = 41
        with pytest.raises(TransferVerificationError, match="mismatch"):
            _verify(x, host)

    def test_probe_sets_vary_across_calls(self):
        """Repeated pulls of a same-sized buffer must not re-check the
        identical index set (ADVICE r3)."""
        from advancedmh_tpu.utils.transfer import _probe_indices

        a = _probe_indices(100000)
        b = _probe_indices(100000)
        assert not np.array_equal(a, b)

    def test_chunked_odd_shapes(self):
        # leading axis not divisible by the slice rows; 1-row arrays
        for shape in [(7, 33), (1, 9), (5,)]:
            x = jnp.asarray(
                np.random.default_rng(0).normal(size=shape), jnp.float32
            )
            out = safe_device_get(x, max_chunk_bytes=64)
            np.testing.assert_array_equal(out, np.asarray(x))
