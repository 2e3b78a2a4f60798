"""Fused-engine dispatch: run `sample()` on the fused RWMH kernel.

Applicable when the sampler is a symmetric Gaussian random-walk
``MetropolisHastings`` (the reference's flagship ``RWMH(MvNormal(...))``
family) and the model carries a tile density (``model.tile_density`` +
``model.tile_consts``, see models/targets.py, or a ``logdensity_batched_fn``
adapted via ``tile_fn_from_batched``). Every other sampler runs on the XLA
engine.

Contract note: the fused engine's sample k is the state after
``burn + (k+1)*thinning`` steps with ``burn = max(discard_initial -
thinning, 0)`` — identical to the standard schedule when ``discard_initial
>= thinning`` (the init draw itself is never emitted). Random bits come from
a counter-based Threefry stream keyed by the user key and indexed by
(global chain, absolute step): equal to the XLA path in distribution, not
bitstream. The random bits do not depend on block size, padding, sharding
or chunking; a chunked run equals the unchunked one, while a different
block size (a sharded run's) may compile other last bits of the density and
so flip rare accept decisions.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..distributions import MvNormal, Normal
from ..ops import pallas_mh
from ..proposals import RandomWalkProposal, is_proposal
from ..samplers.base import Transition
from ..samplers.mh import MetropolisHastings
from ..utils import KeyArray

FUSED_SAMPLERS = (
    "RWMH / MetropolisHastings with one zero-mean Gaussian RandomWalkProposal"
)

# Streaming multiprocessors of an H100/H200: a launch should have at least
# this many programs so that every SM gets a block of chains.
SM_COUNT = 132
# pl.dot needs operands at least 16 wide, so a block never has fewer chains.
MIN_BLOCK = 16
MAX_BLOCK = 64
# Upper bound on the (d, block) float32 state one program holds in registers.
STATE_BUDGET = 512
# Warps per program: about this many floats of chain state per warp, 2 to 4
# warps (the block/warp sweep on the H200, PERF.md).
STATE_PER_WARP = 64


def check_fused_sampler(sampler) -> None:
    """Raise ``ValueError`` unless ``sampler`` has a fused kernel."""
    if type(sampler) is not MetropolisHastings:
        raise ValueError(
            f"engine='fused' has no kernel for {type(sampler).__name__}; "
            f"it supports {FUSED_SAMPLERS}. Use engine='xla'."
        )


def _extract_rw_scale(sampler, d: int) -> np.ndarray:
    """Return the proposal scale — per-dimension std-dev ``(d,)`` or a full
    lower-Cholesky factor ``(d, d)`` — or raise if the sampler is not a
    symmetric Gaussian random walk."""
    check_fused_sampler(sampler)
    return _rw_leaf_scale(sampler.proposal, d)


def _rw_leaf_scale(p, d: int) -> np.ndarray:
    """Scale of a single zero-mean Gaussian RandomWalkProposal leaf."""
    if not is_proposal(p) or not isinstance(p, RandomWalkProposal):
        raise ValueError(
            "engine='fused' requires a single RandomWalkProposal leaf"
        )
    payload = p.payload
    if isinstance(payload, MvNormal):
        if not np.allclose(np.asarray(payload.loc), 0.0):
            raise ValueError("fused RW proposal must be zero-mean")
        if payload.scale_tril is not None:
            return np.tril(np.asarray(payload.scale_tril, np.float32))
        if payload.scale_diag is not None:
            return np.broadcast_to(np.asarray(payload.scale_diag), (d,))
        return np.broadcast_to(np.asarray(payload.scale), (d,))
    if isinstance(payload, Normal):
        if not np.allclose(np.asarray(payload.loc), 0.0):
            raise ValueError("fused RW proposal must be zero-mean")
        return np.broadcast_to(np.asarray(payload.scale), (d,))
    raise ValueError(
        f"engine='fused' does not support payload {type(payload).__name__}"
    )


def _shard_fused(run, mesh, axis: str):
    """Wrap the fused engine ``run(params_t, lp, ctl)`` in ``shard_map`` over
    the chains mesh axis (≙ MCMCDistributed: zero hot-loop collectives —
    each device runs the whole kernel on its chain shard).

    Arrays carry chains on their last axis; ``ctl`` is replicated and each
    shard adds its first global chain index to ``ctl[2]``, so shards draw
    from disjoint counter ranges: the same random bits as the unsharded
    one."""
    from jax.sharding import PartitionSpec

    def wrapped(params_t, lp, ctl):
        chains = PartitionSpec(None, axis)
        out_specs = (PartitionSpec(None, None, axis),) * 3

        def body(x, l, c):
            idx = jax.lax.axis_index(axis).astype(jnp.uint32)
            first = idx * np.uint32(x.shape[-1])
            return run(x, l, c.at[2].add(first))

        return jax.shard_map(
            body, mesh=mesh, in_specs=(chains, chains, PartitionSpec()),
            out_specs=out_specs, check_vma=False,
        )(params_t, lp, ctl)

    return wrapped


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _fused_tiling(
    num_chains: int, d: int, n_devices: int = 1, max_block: int = MAX_BLOCK,
) -> Tuple[int, int]:
    """Pick (padded chain count, chains per block) for a fused launch.

    Blocks are powers of two between ``MIN_BLOCK`` and ``max_block``, capped
    so that one block's ``(d, block)`` state fits ``STATE_BUDGET`` floats.
    The block then halves until each device has at least ``SM_COUNT``
    programs (or the block reaches ``MIN_BLOCK``). The per-device chain
    count is padded up to a multiple of the block.
    """
    if not pallas_mh.is_pow2(max_block) or max_block < MIN_BLOCK:
        raise ValueError(
            f"max_block must be a power of two ≥ {MIN_BLOCK}, got {max_block}"
        )
    block = max(MIN_BLOCK, min(max_block, _pow2_floor(STATE_BUDGET // d)))
    per_dev = -(-num_chains // n_devices)
    while block > MIN_BLOCK and -(-per_dev // block) < SM_COUNT:
        block //= 2
    per_dev_pad = -(-per_dev // block) * block
    return per_dev_pad * n_devices, block


def _num_warps(d: int, block: int) -> int:
    """Warps for a program holding a ``(d, block)`` state."""
    return max(2, min(4, d * block // STATE_PER_WARP))


def launch_shape(num_chains: int, d: int, n_devices: int = 1):
    """(padded chain count, ``fused_rwmh_sample`` launch keywords)."""
    c_pad, block = _fused_tiling(num_chains, d, n_devices)
    return c_pad, dict(block_chains=block, num_warps=_num_warps(d, block))


def _pad_chains(run, c: int, c_pad: int):
    """Wrap a fused engine so callers may pass any chain count: array inputs
    are edge-padded on the chain (last) axis to ``c_pad`` before the kernel
    and every output is trimmed back to ``c`` chains."""
    if c_pad == c:
        return run

    def wrapped(*args):
        *arrs, ctl = args
        padded = [
            jnp.pad(
                jnp.asarray(a),
                [(0, 0)] * (jnp.ndim(a) - 1) + [(0, c_pad - c)],
                mode="edge",
            )
            for a in arrs
        ]
        out = run(*padded, ctl)
        return jax.tree_util.tree_map(lambda x: x[..., :c], out)

    return wrapped


def _tile_density_of(model):
    tile = getattr(model, "tile_density", None)
    consts = getattr(model, "tile_consts", ())
    if tile is not None:
        return tile, tuple(consts)
    if model.logdensity_batched_fn is not None:
        return pallas_mh.tile_fn_from_batched(model.logdensity_batched_fn), ()
    raise ValueError(
        "engine='fused' needs a kernel-traceable density: attach "
        "model.tile_density (+ tile_consts) or provide "
        "logdensity_batched_fn built from jnp ops."
    )


def sample_fused(
    model,
    sampler,
    n_samples: int,
    *,
    key: KeyArray,
    num_chains: int,
    initial_params,
    discard_initial: int,
    thinning: int,
    iteration_offset: int = 0,
    mesh=None,
    mesh_axis: str = "chains",
):
    """Run the fused RWMH sampling engine; returns the raw pieces in the
    standard (chains, samples, ...) layout. ``iteration_offset`` is the
    absolute index of the first step, so a chunked run continues the
    counter stream of the run it resumes."""
    if initial_params is None:
        raise ValueError("engine='fused' requires initial_params")
    d = model.dimension
    if d is None:
        d = int(np.asarray(initial_params).shape[-1])
    scale = _extract_rw_scale(sampler, d)
    tile_fn, consts = _tile_density_of(model)
    burn = max(discard_initial - thinning, 0)
    n_dev = mesh.shape[mesh_axis] if mesh is not None else 1
    c_pad, launch = launch_shape(num_chains, d, n_dev)

    run = pallas_mh.fused_rwmh_sample(
        tile_fn, d, scale, n_samples, burn=burn, thin=thinning,
        consts=consts, **launch,
    )
    if mesh is not None:
        run = _shard_fused(run, mesh, mesh_axis)
    run = _pad_chains(run, num_chains, c_pad)

    init = jnp.asarray(initial_params, jnp.float32)
    if init.ndim == 1:
        params_t = jnp.broadcast_to(init[:, None], (d, num_chains))
    else:  # batched (C, d)
        params_t = init.T
    lp0 = tile_fn(params_t, *(jnp.asarray(c) for c in consts))

    ctl = jnp.concatenate([
        jax.random.bits(key, (2,), jnp.uint32),
        jnp.asarray([0, iteration_offset], jnp.uint32),
    ])
    samples, lps, accs = run(params_t, lp0, ctl)

    # (N, d, C) → (C, N, d); (N, 1, C) → (C, N)
    params = jnp.transpose(samples, (2, 0, 1))
    lp = jnp.transpose(lps[:, 0, :], (1, 0))
    accepted = jnp.transpose(accs[:, 0, :], (1, 0)) > 0.5
    transitions = Transition(params, lp, accepted)
    final_state = Transition(params[:, -1, :], lp[:, -1], accepted[:, -1])
    return transitions, final_state
