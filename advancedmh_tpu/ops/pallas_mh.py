"""Fused multi-step random-walk Metropolis kernel (Pallas, Triton route).

The XLA path (samplers/mh.py ``step_batched`` under ``lax.scan``) runs each
MH step as a few small fusions, and the chain state makes a round trip
through device memory between them. This kernel runs the whole
propose → log-density → accept loop for a block of chains in one program:
the state stays in registers for every burn, thinning and kept step, and
only the kept draws are written out.

Layout: one program per block of ``block_chains`` chains, chains across
threads. Parameters are stored transposed as ``(d, C)``; the kept draws go
to an ``(N, d, C)`` output, one row per kept sample.

Random bits come from Threefry-2x32 (ops/counter_rng.py) keyed by the
user's seed, with the counter ``(global chain, absolute step · (d+1) +
row)``: rows ``0..d-1`` feed the Gaussian proposal, row ``d`` the accept
uniform. The stream differs from the XLA engine's ``fold_in`` keys, so the
two engines agree in distribution, not bit for bit.

Scope: symmetric Gaussian random-walk proposals (isotropic, per-dimension
or ``scale_tril``) against a model that provides a *tile* log-density
``f((d, TC), *consts) -> (1, TC)``. On the Triton route every value a
kernel holds has power-of-two dimensions, and values cannot be sliced, so
``d`` and every constant's dimensions must be powers of two and the density
reads rows with :func:`tile_rows` (or reductions) rather than ``x[i:i+1]``.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .counter_rng import normal_from_bits, threefry2x32, uniform_open


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def tile_rows(x: jax.Array):
    """Split a ``(d, TC)`` tile into its ``d`` rows of shape ``(1, TC)``.
    Each row is a masked sum over the row axis: on the Triton route static
    slices of a value have no lowering, and ``jnp.split`` (reshape +
    transpose + split) compiles pathologically slowly there."""
    row = jax.lax.broadcasted_iota(jnp.int32, x.shape, 0)
    return [
        jnp.sum(jnp.where(row == i, x, 0.0), axis=0, keepdims=True)
        for i in range(x.shape[0])
    ]


def _matvec(m: jax.Array, z: jax.Array) -> jax.Array:
    """``m (d, d) @ z (d, TC)`` as broadcast-multiply-reduce: exact float32
    arithmetic on the CUDA cores, no TF32 rounding."""
    return jnp.sum(m[:, :, None] * z[None, :, :], axis=1)


def _rwmh_sampling_kernel(
    ctl_ref,  # (4,) uint32: key words k0, k1; first global chain; first step
    scale_ref,  # (d, 1) per-dim std-dev, or (d, d) lower Cholesky
    *rest,
    logdensity_tile_fn: Callable,
    n_consts: int,
    n_samples: int,
    burn: int,
    thin: int,
    tril: bool,
):
    const_refs = rest[:n_consts]
    x_ref, lp_ref, out_x_ref, out_lp_ref, out_acc_ref = rest[n_consts:]
    d, tc = x_ref.shape
    k0, k1, chain0, step0 = ctl_ref[0], ctl_ref[1], ctl_ref[2], ctl_ref[3]
    block0 = chain0 + pl.program_id(0).astype(jnp.uint32) * np.uint32(tc)
    chain = block0 + jax.lax.broadcasted_iota(jnp.uint32, (1, tc), 1)
    row = jax.lax.broadcasted_iota(jnp.uint32, (d, 1), 0)
    scale = scale_ref[...]
    consts = tuple(r[...] for r in const_refs)
    stride = np.uint32(d + 1)

    def perturb(z):
        return _matvec(scale, z) if tril else scale * z

    def step(t, carry):
        x, lp, _ = carry
        base = (step0 + t.astype(jnp.uint32)) * stride
        b0, b1 = threefry2x32(k0, k1, chain, base + row)  # (d, TC)
        cand = x + perturb(normal_from_bits(b0, b1))
        lp_cand = logdensity_tile_fn(cand, *consts)  # (1, TC)
        a0, _ = threefry2x32(k0, k1, chain, base + np.uint32(d))  # (1, TC)
        # accept iff log U < logα (symmetric proposal)
        accept = jnp.log(uniform_open(a0)) < lp_cand - lp
        return (
            jnp.where(accept, cand, x),
            jnp.where(accept, lp_cand, lp),
            accept.astype(jnp.float32),
        )

    carry = (x_ref[...], lp_ref[...], jnp.zeros((1, tc), jnp.float32))
    carry = jax.lax.fori_loop(0, burn, step, carry)

    def emit(e, carry):
        t0 = burn + e * thin
        carry = jax.lax.fori_loop(t0, t0 + thin, step, carry)
        out_x_ref[e] = carry[0]
        out_lp_ref[e] = carry[1]
        out_acc_ref[e] = carry[2]
        return carry

    jax.lax.fori_loop(0, n_samples, emit, carry)


def _scale_block(scale, d: int) -> Tuple[jax.Array, bool]:
    """Normalize a user scale to the kernel's block: (d, 1) per-dim std-dev
    column, or (d, d) lower Cholesky (tril=True)."""
    arr = jnp.asarray(scale, jnp.float32)
    if arr.ndim == 2:
        if arr.shape != (d, d):
            raise ValueError(f"matrix scale must be ({d}, {d}), got {arr.shape}")
        return jnp.tril(arr), True
    return jnp.broadcast_to(arr.reshape(-1, 1), (d, 1)), False


def _as_block_const(c) -> jax.Array:
    c = jnp.asarray(c, jnp.float32)
    if c.ndim < 2:
        c = c.reshape(-1, 1)
    if not all(is_pow2(n) for n in c.shape):
        raise ValueError(
            f"tile constant of shape {c.shape}: the Triton route needs "
            "power-of-two dimensions (pad the constant and mask the padding "
            "in the tile density)"
        )
    return c


@functools.partial(
    jax.jit,
    static_argnames=(
        "logdensity_tile_fn", "n_samples", "burn", "thin", "tril",
        "block_chains", "num_warps", "interpret",
    ),
)
def _run(
    params_t, lp, ctl, scale_arr, consts, *, logdensity_tile_fn, n_samples,
    burn, thin, tril, block_chains, num_warps, interpret,
):
    d, c = params_t.shape
    if c % block_chains != 0:
        raise ValueError(
            f"chains={c} must be a multiple of block_chains={block_chains}"
        )
    kernel = functools.partial(
        _rwmh_sampling_kernel,
        logdensity_tile_fn=logdensity_tile_fn,
        n_consts=len(consts),
        n_samples=n_samples,
        burn=burn,
        thin=thin,
        tril=tril,
    )
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    tiled = lambda rows: pl.BlockSpec((rows, block_chains), lambda i: (0, i))
    emitted = lambda rows: pl.BlockSpec(
        (n_samples, rows, block_chains), lambda i: (0, 0, i)
    )
    return pl.pallas_call(
        kernel,
        grid=(c // block_chains,),
        in_specs=[
            whole(ctl),
            whole(scale_arr),
            *[whole(k) for k in consts],
            tiled(d),
            tiled(1),
        ],
        out_specs=[emitted(d), emitted(1), emitted(1)],
        out_shape=[
            jax.ShapeDtypeStruct((n_samples, d, c), jnp.float32),
            jax.ShapeDtypeStruct((n_samples, 1, c), jnp.float32),
            jax.ShapeDtypeStruct((n_samples, 1, c), jnp.float32),
        ],
        compiler_params=pl_triton.CompilerParams(
            num_warps=num_warps, num_stages=1
        ),
        interpret=interpret,
        name="fused_rwmh",
    )(ctl, scale_arr, *consts, params_t, lp)


def fused_rwmh_sample(
    logdensity_tile_fn: Callable,
    d: int,
    scale,
    n_samples: int,
    *,
    burn: int = 0,
    thin: int = 1,
    consts: Tuple = (),
    block_chains: int = 64,
    num_warps: int = 4,
    interpret: bool = False,
):
    """Build the fused sampling engine.

    Returns ``fn(params_T (d, C), lp (1, C), ctl) -> (samples (n_samples, d,
    C), lps (n_samples, 1, C), accepted (n_samples, 1, C))`` where sample
    ``k`` is the state after ``burn + (k+1)*thin`` MH steps and ``accepted``
    flags whether that last step moved. ``ctl`` is a ``(4,)`` uint32 vector
    ``(k0, k1, chain0, step0)``: the Threefry key, the global index of
    chain 0 (a shard's offset) and the absolute index of the first step.

    ``scale`` is a scalar or length-d per-dimension std-dev, or a ``(d, d)``
    lower Cholesky factor for a full-covariance proposal. ``consts`` are the
    density's constant arrays (observed data), passed to
    ``logdensity_tile_fn`` after the candidate. ``C`` must be a multiple of
    ``block_chains`` (a power of two). ``interpret=True`` runs the kernel in
    the Pallas interpreter (CPU tests).
    """
    if not is_pow2(d) or not is_pow2(block_chains):
        raise ValueError(
            f"d={d} and block_chains={block_chains} must be powers of two on "
            "the Triton route"
        )
    scale_arr, tril = _scale_block(scale, d)
    consts = tuple(_as_block_const(c) for c in consts)
    return functools.partial(
        _run, scale_arr=scale_arr, consts=consts,
        logdensity_tile_fn=logdensity_tile_fn, n_samples=int(n_samples),
        burn=int(burn), thin=int(thin), tril=tril,
        block_chains=int(block_chains), num_warps=int(num_warps),
        interpret=bool(interpret),
    )


def tile_fn_from_batched(logdensity_batched_fn: Callable) -> Callable:
    """Adapt a chain-batched density ``(C, d) -> (C,)`` to the kernel's
    transposed tile layout ``(d, TC) -> (1, TC)``. The function must consist
    of ops that lower on the Triton route."""

    def tile_fn(params_t):
        return logdensity_batched_fn(params_t.T)[None, :]

    return tile_fn
