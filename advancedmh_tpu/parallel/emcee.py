"""Walker-sharded emcee: the red-black stretch move over a device mesh.

≙ SURVEY.md §2 'Ensemble/walker parallelism': walkers shard across devices;
each half-move needs the *complementary* half-ensemble, exchanged with a
single ``jax.lax.all_gather`` — the only collective in any hot loop
of this framework. Within a half-move every device updates its local walker
shard independently against the gathered frozen half.

Layout: the ensemble state is carried as two half-ensembles with leaves of
shape (n_half, ...) sharded on the walker axis; a full step is
    A ← move(A | gather(B));  B ← move(B | gather(A))
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.density import as_model
from ..samplers.emcee import Ensemble
from ..utils import KeyArray
from .mesh import make_mesh


def build_sharded_ensemble_step(
    sampler: Ensemble,
    model,
    mesh: Optional[Mesh] = None,
    axis: str = "walkers",
) -> Callable:
    """Build a jitted walker-sharded full ensemble step.

    Returns ``step(key, (pA, lpA, pB, lpB)) -> (pA, lpA, pB, lpB, accepted)``
    where the params/lp leaves carry the *global* half-ensemble with their
    leading axis sharded over ``mesh[axis]``.
    """
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    model = as_model(model)
    n_dev = mesh.shape[axis]
    if (sampler.n_walkers // 2) % n_dev != 0:
        raise ValueError(
            f"n_walkers/2 = {sampler.n_walkers // 2} must divide evenly over "
            f"{n_dev} devices."
        )

    def local_half_move(key, active_params, active_lp, other_params, other_lp):
        # Per-device distinct RNG stream.
        key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        # The complementary half is gathered once per half-move.
        other_params = jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, axis, tiled=True), other_params
        )
        other_lp = jax.lax.all_gather(other_lp, axis, tiled=True)
        return sampler._half_move(
            key, active_params, active_lp, other_params, other_lp, model
        )

    def step(key, halves):
        pA, lpA, pB, lpB = halves
        key_a, key_b = jax.random.split(key)
        pA, lpA, accA = local_half_move(key_a, pA, lpA, pB, lpB)
        pB, lpB, accB = local_half_move(key_b, pB, lpB, pA, lpA)
        return pA, lpA, pB, lpB, jnp.concatenate([accA, accB])

    spec = P(axis)
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), (spec, spec, spec, spec)),
        out_specs=(spec, spec, spec, spec, spec),
        check_vma=False,
    )
    return jax.jit(sharded)


def init_sharded_ensemble(
    sampler: Ensemble, model, key: KeyArray, mesh: Optional[Mesh] = None,
    axis: str = "walkers",
):
    """Initialize and device_put the half-ensemble state, sharded on walkers."""
    from jax.sharding import NamedSharding

    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    model = as_model(model)
    t, _ = sampler.init(key, model)
    h = sampler.n_walkers // 2
    take = lambda tree, sl: jax.tree_util.tree_map(lambda x: x[sl], tree)
    halves = (
        take(t.params, slice(0, h)),
        t.lp[:h],
        take(t.params, slice(h, 2 * h)),
        t.lp[h : 2 * h],
    )
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), halves)


def sharded_ensemble_sample(
    sampler: Ensemble,
    model,
    n_samples: int,
    key: KeyArray,
    mesh: Optional[Mesh] = None,
    axis: str = "walkers",
):
    """Scan the sharded step; returns stacked (params, lp) with walker axis
    rejoined, leaves (n_samples, n_walkers_rounded, ...)."""
    mesh = mesh if mesh is not None else make_mesh(axis=axis)
    step = build_sharded_ensemble_step(sampler, model, mesh, axis)
    halves = init_sharded_ensemble(sampler, model, key, mesh, axis)

    @jax.jit
    def run(halves, keys):
        def body(h, k):
            pA, lpA, pB, lpB, acc = step(k, h)
            params = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b]), pA, pB
            )
            lp = jnp.concatenate([lpA, lpB])
            return (pA, lpA, pB, lpB), (params, lp, acc)

        return jax.lax.scan(body, halves, keys)

    keys = jax.random.split(jax.random.fold_in(key, 1), n_samples)
    _, (params, lp, acc) = run(halves, keys)
    return params, lp, acc
