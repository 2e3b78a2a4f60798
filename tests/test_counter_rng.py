"""The fused kernel's counter-based generator (ops/counter_rng.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import prng

from advancedmh_tpu.ops.counter_rng import (
    normal_from_bits,
    threefry2x32,
    uniform_open,
)

N = 1 << 16


def _bits(k0, k1, x0, x1):
    u32 = lambda v: jnp.asarray(v, jnp.uint32)
    return threefry2x32(u32(k0), u32(k1), u32(x0), u32(x1))


@pytest.mark.parametrize("key", [(0, 0), (123, 456), (0xFFFFFFFF, 7)])
def test_matches_jax_threefry(key):
    """Bit-identical to the Threefry-2x32 behind jax.random."""
    count = np.arange(2 * 1000, dtype=np.uint32)
    ref = np.asarray(prng.threefry_2x32(jnp.asarray(key, jnp.uint32),
                                        jnp.asarray(count)))
    a, b = _bits(key[0], key[1], count[:1000], count[1000:])
    np.testing.assert_array_equal(np.concatenate([a, b]), ref)


@pytest.mark.parametrize("seed", [1, 2])
def test_uniform_moments(seed):
    b0, _ = _bits(seed, 0, np.arange(N), np.zeros(N))
    u = np.asarray(uniform_open(b0), np.float64)
    assert u.min() > 0.0 and u.max() < 1.0
    se = np.sqrt(1.0 / 12.0 / N)
    assert abs(u.mean() - 0.5) < 4 * se
    assert abs(u.var() - 1.0 / 12.0) < 4 * np.sqrt(1.0 / 180.0 / N)


@pytest.mark.parametrize("seed", [3, 4])
def test_normal_moments(seed):
    b0, b1 = _bits(seed, 9, np.arange(N), np.full(N, 5))
    z = np.asarray(normal_from_bits(b0, b1), np.float64)
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 4 / np.sqrt(N)
    assert abs(z.var() - 1.0) < 4 * np.sqrt(2.0 / N)
    assert abs(np.mean(z**4) - 3.0) < 4 * np.sqrt(96.0 / N)


@pytest.mark.parametrize(
    "other",
    [dict(k0=2), dict(x0=1), dict(x1=1)],
    ids=["seed", "chain", "step"],
)
def test_distinct_streams(other):
    """Changing the seed, the chain or the step counter gives a stream
    with no coincident words."""
    base = dict(k0=1, k1=0, x0=0, x1=0)
    grid = np.arange(N, dtype=np.uint32)

    def stream(k0, k1, x0, x1):
        # walk the counter word the test does not vary
        if "x0" in other:
            return _bits(k0, k1, x0 + 2 * grid, x1)[0]
        return _bits(k0, k1, x0, x1 + 2 * grid)[0]

    a = np.asarray(stream(**base))
    b = np.asarray(stream(**{**base, **other}))
    assert np.mean(a == b) < 1e-3
    assert abs(np.corrcoef(a.astype(np.float64), b.astype(np.float64))[0, 1]) < 0.02
