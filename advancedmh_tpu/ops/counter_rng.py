"""Counter-based random numbers built from uint32 ``jnp`` ops only.

Threefry-2x32 with 20 rounds (Salmon et al. 2011, the generator behind
``jax.random``), written in plain add/rotate/xor so that it traces inside a
Pallas kernel on the Triton route as well as in ordinary XLA code. A draw is
a pure function of ``(key, counter)``: no state is carried between calls, so
any block of chains can produce any step's bits in any order.

The fused RWMH kernel (ops/pallas_mh.py) keys the counter by (global chain
index, absolute step, row): runs are deterministic given the seed, and the
random bits do not depend on block size, chain padding or sharding.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
_TWO_PI = 6.283185307179586


def _rotl(x: jax.Array, r: int) -> jax.Array:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[jax.Array, jax.Array]:
    """Threefry-2x32-20 of the counter pair ``(x0, x1)`` under key
    ``(k0, k1)``; all uint32, broadcast together. Bit-identical to
    ``jax._src.prng.threefry_2x32``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_open(bits: jax.Array) -> jax.Array:
    """uint32 → float32 uniform on the open interval (0, 1): the top 24 bits
    plus half an ulp, so ``log(u)`` is always finite."""
    top = (bits >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32)
    return (top + 0.5) * jnp.float32(2.0**-24)


def normal_from_bits(b0: jax.Array, b1: jax.Array) -> jax.Array:
    """One standard normal per bit pair (Box-Muller, cosine branch)."""
    r = jnp.sqrt(-2.0 * jnp.log(uniform_open(b0)))
    return r * jnp.cos(_TWO_PI * uniform_open(b1))
