"""RNG key plumbing.

The reference threads a stateful ``Random.AbstractRNG`` through every call
(e.g. reference src/mh-core.jl:92-117). Here we use JAX's counter-based,
splittable keys instead: every step/chain/leaf derives its own key by
``fold_in``/``split``, which is cheap, parallel-safe, and partitionable across
a device mesh (``jax_threefry_partitionable``). Sampling therefore matches the
reference *in distribution*, not bitstream — an intentional, owned divergence
(see SURVEY.md §7).
"""
from __future__ import annotations

from typing import Iterator

import jax
import jax.numpy as jnp

KeyArray = jax.Array


def as_key(seed_or_key: "int | KeyArray") -> KeyArray:
    """Coerce an int seed (Python or numpy integer) or an existing key to a
    typed PRNG key."""
    import numpy as np

    if isinstance(seed_or_key, (int, np.integer)):
        return jax.random.key(int(seed_or_key))
    k = jnp.asarray(seed_or_key)
    if jnp.issubdtype(k.dtype, jax.dtypes.prng_key):
        return k
    # raw uint32 key array from jax.random.PRNGKey
    return jax.random.wrap_key_data(k.astype(jnp.uint32))


def split_like(key: KeyArray, n: int) -> KeyArray:
    return jax.random.split(key, n)


def key_iter(key: KeyArray) -> Iterator[KeyArray]:
    """Infinite iterator of fresh keys (host-side convenience, not for jit)."""
    i = 0
    while True:
        yield jax.random.fold_in(key, i)
        i += 1
