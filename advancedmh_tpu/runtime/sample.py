"""The sampling runtime: scan over steps, vmap over chains, shard over mesh.

≙ the AbstractMCMC driver the reference delegates to (re-exported ``sample``,
``MCMCSerial/MCMCThreads/MCMCDistributed`` at reference src/AdvancedMH.jl:30;
semantics exercised throughout reference test/runtests.jl). The architecture
is the accelerator-native inversion of the reference's one-step-per-call design
(SURVEY.md §7):

    sampler kernel (pure)            ──  samplers/*
    └─ lax.scan over steps           ──  this file (static warmup/thinning
       │                                 segmentation: zero per-step branching)
    └─ vmap over chains              ──  this file
    └─ shard_map over 'chains' mesh  ──  parallel/sharded.py

Chain parallelism (≙ MCMCThreads/MCMCDistributed, one chain per thread/worker
in the reference) becomes a batched device axis: thousands of chains per chip,
zero collectives in the hot loop.

RNG: chain c derives key ``fold_in(master, c)``; step j uses
``fold_in(chain_key, j)`` (init is j=0). Fully deterministic, resumable, and
independent of chunking/sharding layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

from ..models.density import as_model
from ..samplers.base import Sampler
from ..utils import KeyArray, as_key
from .schedule import Schedule


# --- chain-parallel execution strategies (≙ AbstractMCMC ensembles) ---------


@dataclasses.dataclass(frozen=True)
class MCMCSerial:
    """≙ AbstractMCMC.MCMCSerial: chains run one after another (debug aid)."""


@dataclasses.dataclass(frozen=True)
class MCMCThreads:
    """≙ AbstractMCMC.MCMCThreads. On an accelerator, 'one chain per thread'
    becomes a vmapped chain batch on the local device."""


@dataclasses.dataclass(frozen=True)
class MCMCDistributed:
    """≙ AbstractMCMC.MCMCDistributed. Here 'one chain per worker process'
    becomes chains sharded over the device mesh via shard_map."""

    mesh: Optional[Any] = None
    axis: str = "chains"


ChainMethod = Union[str, MCMCSerial, MCMCThreads, MCMCDistributed, None]


def _resolve_chain_method(method: ChainMethod) -> Tuple[str, Optional[Any], str]:
    if method is None or method == "vmap" or isinstance(method, MCMCThreads):
        return "vmap", None, "chains"
    if method == "sequential" or isinstance(method, MCMCSerial):
        return "sequential", None, "chains"
    if isinstance(method, MCMCDistributed):
        return "shard_map", method.mesh, method.axis
    if method == "shard_map":
        return "shard_map", None, "chains"
    raise ValueError(f"Unknown chain method: {method!r}")


# --- single-chain driver ----------------------------------------------------


def build_chain_fn(
    sampler: Sampler,
    model,
    schedule: Schedule,
    collect_states: bool = False,
    from_state: bool = False,
    iteration_offset: int = 0,
    batch_shape: Optional[Tuple[int, ...]] = None,
    init_batched: bool = False,
    state_sharding: Optional[Any] = None,
) -> Callable:
    """Build ``chain_fn(chain_key[, initial_params]) -> (samples, final_state)``.

    The warmup/discard/thinning structure is segmented *statically* (all
    schedule fields are Python ints), so the compiled program contains plain
    ``lax.scan`` loops with no per-step branching — warmup-free samplers
    compile a single step body, RAM compiles one warmup scan and one main
    scan.

    ``from_state=True`` makes the returned function take a previously
    obtained sampler *state* instead of initial params (checkpoint resume);
    ``iteration_offset`` shifts the per-step RNG indices so a resumed run is
    bit-identical to an uninterrupted one (pass the absolute iteration count
    already consumed, i.e. ``prev_schedule.total_steps`` accumulated).

    ``batch_shape`` selects the *vectorized* kernel path: the state carries a
    chain batch, each step uses ``sampler.step_batched`` with one key per
    step (not per chain), and the emitted samples are transposed to the
    ``(chains, n_samples, ...)`` layout of the vmapped path.
    ``state_sharding`` (a NamedSharding) is constrained onto the state after
    init so XLA partitions the whole program over the chain axis.
    """
    model = as_model(model)
    OFF = iteration_offset
    W, D, th, N = (
        schedule.num_warmup,
        schedule.discard_initial,
        schedule.thinning,
        schedule.n_samples,
    )
    has_warmup = sampler.has_warmup_phase
    vector = batch_shape is not None

    def step_fn(warmup: bool):
        if vector:
            if warmup and has_warmup:
                return lambda k, s, m: sampler.step_warmup_batched(
                    k, s, m, batch_shape
                )
            return lambda k, s, m: sampler.step_batched(k, s, m, batch_shape)
        return sampler.step_warmup if (warmup and has_warmup) else sampler.step

    def run_span(state, chain_key, j0: int, n: int, warmup: bool):
        """Steps j0..j0+n-1, discarding outputs."""
        if n <= 0:
            return state
        fn = step_fn(warmup)

        def body(st, j):
            _, s = fn(jax.random.fold_in(chain_key, j), st, model)
            return s, None

        state, _ = lax.scan(body, state, jnp.arange(j0, j0 + n))
        return state

    def emit(state):
        t = sampler.transition_of(state)
        return (t, state) if collect_states else t

    def collect_span(state, chain_key, j0: int, n_groups: int, warmup: bool):
        """``n_groups`` groups of ``th`` steps; emits after each group."""
        if n_groups <= 0:
            return state, None
        fn = step_fn(warmup)

        def body(st, start):
            if th == 1:
                _, s = fn(jax.random.fold_in(chain_key, start), st, model)
            else:

                def inner(st2, j):
                    _, s2 = fn(jax.random.fold_in(chain_key, j), st2, model)
                    return s2, None

                s, _ = lax.scan(inner, st, start + jnp.arange(th))
            return s, emit(s)

        starts = j0 + jnp.arange(n_groups) * th
        return lax.scan(body, state, starts)

    def chain_fn(chain_key, arg=None):
        if from_state:
            state = arg
        elif vector:
            init_keys = jax.random.split(
                jax.random.fold_in(chain_key, 0), batch_shape[0]
            )
            if arg is None:
                _, state = jax.vmap(lambda k: sampler.init(k, model, None))(
                    init_keys
                )
            elif init_batched:
                _, state = jax.vmap(lambda k, p: sampler.init(k, model, p))(
                    init_keys, arg
                )
            else:
                _, state = jax.vmap(lambda k: sampler.init(k, model, arg))(
                    init_keys
                )
        else:
            _, state = sampler.init(
                jax.random.fold_in(chain_key, 0), model, arg
            )
        if state_sharding is not None:
            state = jax.lax.with_sharding_constraint(state, state_sharding)

        # Sample 1: the state after `discard_initial` steps (init if D == 0).
        bw = min(W, D)
        state = run_span(state, chain_key, OFF + 1, bw, True)
        state = run_span(state, chain_key, OFF + 1 + bw, D - bw, False)
        parts = [jax.tree_util.tree_map(lambda x: x[None], emit(state))]

        # Samples 2..N in groups of `th` steps. Steps j <= W are warmup;
        # segment statically into [full-warmup groups | straddle | main].
        n_groups = N - 1
        wrem = max(0, W - D)
        n_wfull = min(wrem // th, n_groups)
        straddle = 1 if (wrem - n_wfull * th > 0 and n_wfull < n_groups) else 0
        n_main = n_groups - n_wfull - straddle
        j = OFF + D + 1

        state, out_w = collect_span(state, chain_key, j, n_wfull, True)
        j += n_wfull * th
        if out_w is not None:
            parts.append(out_w)

        if straddle:
            kw = wrem - n_wfull * th
            state = run_span(state, chain_key, j, kw, True)
            state = run_span(state, chain_key, j + kw, th - kw, False)
            parts.append(jax.tree_util.tree_map(lambda x: x[None], emit(state)))
            j += th

        state, out_m = collect_span(state, chain_key, j, n_main, False)
        if out_m is not None:
            parts.append(out_m)

        samples = (
            parts[0]
            if len(parts) == 1
            else jax.tree_util.tree_map(
                lambda *xs: jnp.concatenate(xs, axis=0), *parts
            )
        )
        if vector:
            # (n_samples, chains, ...) → (chains, n_samples, ...): match the
            # vmapped-path layout downstream bundling expects.
            samples = jax.tree_util.tree_map(
                lambda x: jnp.swapaxes(x, 0, 1), samples
            )
        return samples, state

    return chain_fn


# --- result container -------------------------------------------------------


@dataclasses.dataclass
class SamplingResult:
    """Raw device-side sampling output.

    ``transitions`` is a Transition/GradientTransition pytree with leaves of
    shape ``(n_samples, ...)`` (single chain) or ``(num_chains, n_samples,
    ...)``. Use :meth:`to_chains` / :meth:`to_structarray` /
    :meth:`to_namedtuples` (output/) for the reference's bundle formats.
    """

    transitions: Any
    final_state: Any
    schedule: Schedule
    num_chains: Optional[int]
    states: Any = None  # populated when collect_states=True
    sampler: Any = None

    def to_chains(self, param_names=None):
        from ..output.bundle import bundle_chains

        return bundle_chains(self, param_names=param_names)

    def to_structarray(self, param_names=None):
        from ..output.bundle import bundle_structarray

        return bundle_structarray(self, param_names=param_names)

    def to_namedtuples(self, param_names=None):
        from ..output.bundle import bundle_namedtuples

        return bundle_namedtuples(self, param_names=param_names)


# --- public front-end -------------------------------------------------------


def sample(
    model,
    sampler: Sampler,
    n_samples,
    *args,
    key: Union[int, KeyArray] = 0,
    num_chains: Optional[int] = None,
    chain_method: ChainMethod = None,
    initial_params: Any = None,
    initial_params_batched: bool = False,
    initial_state: Any = None,
    iteration_offset: int = 0,
    num_warmup: int = 0,
    discard_initial: Optional[int] = None,
    thinning: int = 1,
    collect_states: bool = False,
    chain_type: Optional[str] = None,
    param_names=None,
    vectorized: Optional[bool] = None,
    engine: str = "xla",
    callback: Optional[Callable[[Any, int], None]] = None,
    chunk_size: Optional[int] = None,
    progress: bool = False,
):
    """Draw ``n_samples`` per chain (≙ AbstractMCMC ``sample``; see
    runtime/schedule.py for the exact iteration contract).

    ``num_chains=None`` runs a single chain with no chain axis. Otherwise
    chains are an explicit batch axis executed by ``chain_method``:
    ``MCMCThreads()``/"vmap" (default; one chain per vector lane),
    ``MCMCDistributed()``/"shard_map" (chains sharded over the device mesh),
    ``MCMCSerial()``/"sequential" (debug).

    ``chain_type`` ∈ {None, "chains", "structarray", "namedtuples"} selects
    the output bundle (≙ the reference's chain_type= kwarg and ext/ output
    adapters); None returns the raw :class:`SamplingResult`.

    ``callback`` (≙ the AbstractMCMC per-iteration ``callback`` kwarg,
    exercised at reference test/RobustAdaptiveMetropolis.jl:46-56) is invoked
    on the host as ``callback(chunk_result, info)`` at scan-chunk cadence —
    the device-friendly hook granularity (per-step host calls would serialize
    the device). ``info`` is a :class:`~.chunked.ChunkInfo`: the integer
    chunk index enriched with ``iteration_range`` (absolute iteration
    labels) and ``final_state`` — the reference callback's ``(state,
    iteration)`` arguments. ``chunk_size`` sets the cadence (default
    ≈ n_samples/20, capped at 1000; ``chunk_size=1`` gives exact
    per-iteration cadence at host-roundtrip cost). ``progress=True`` prints
    one host-side progress line per chunk. Either kwarg routes the run
    through :func:`sample_chunked`; XLA-engine results remain bit-identical
    to the unchunked run (absolute-iteration RNG indexing).
    """
    # Positional ensemble form ≙ the reference's
    # ``sample(model, spl, MCMCThreads(), N, nchains)``
    # (reference test/runtests.jl:99-105).
    if isinstance(n_samples, (MCMCSerial, MCMCThreads, MCMCDistributed)):
        chain_method = n_samples
        if not args:
            raise TypeError(
                "sample(model, sampler, MCMC*(), N[, nchains]) needs N"
            )
        n_samples = args[0]
        if len(args) > 1:
            num_chains = args[1]
        args = ()
    if args:
        raise TypeError(f"unexpected positional arguments: {args!r}")

    if callback is not None or progress:
        from .chunked import sample_chunked

        cs = (
            chunk_size
            if chunk_size is not None
            else max(1, min(1000, -(-int(n_samples) // 20)))
        )
        result = sample_chunked(
            model, sampler, n_samples, chunk_size=cs, key=key,
            num_chains=num_chains, initial_params=initial_params,
            initial_params_batched=initial_params_batched,
            initial_state=initial_state, iteration_offset=iteration_offset,
            num_warmup=num_warmup, discard_initial=discard_initial,
            thinning=thinning, collect_states=collect_states,
            callback=callback, progress=progress, to_host=False,
            chain_method=chain_method, vectorized=vectorized, engine=engine,
        )
        return _convert(result, chain_type, param_names)

    model = as_model(model)
    schedule = Schedule(
        n_samples=n_samples,
        num_warmup=num_warmup,
        discard_initial=discard_initial,
        thinning=thinning,
    )
    master = as_key(key)

    if engine == "fused":
        from .fused import check_fused_sampler, sample_fused

        check_fused_sampler(sampler)
        if collect_states:
            raise ValueError(
                "engine='fused' does not collect per-step states; use the "
                "XLA engine for collect_states=True."
            )
        if num_chains is None:
            raise ValueError("engine='fused' requires num_chains")
        # Multi-device: MCMCDistributed/"shard_map" wraps the fused engine in
        # shard_map over the chains mesh axis (zero hot-loop collectives —
        # each device runs the whole kernel on its shard, from its own
        # range of the counter stream).
        f_method, f_mesh, f_axis = _resolve_chain_method(chain_method)
        if f_method == "shard_map":
            from ..parallel.mesh import make_mesh

            if f_mesh is None:
                f_mesh = make_mesh(axis=f_axis)
        else:
            f_mesh = None
        # Resume (chunked runs): continue from a saved state; the kernel's
        # step counter starts at the absolute iteration, so a chunked fused
        # run draws the same stream as an unchunked one.
        if initial_state is not None:
            initial_params = initial_state.params
        transitions, final_state = sample_fused(
            model, sampler, n_samples, key=master, num_chains=num_chains,
            initial_params=initial_params,
            discard_initial=schedule.discard_initial,
            thinning=schedule.thinning,
            iteration_offset=iteration_offset or 0,
            mesh=f_mesh, mesh_axis=f_axis,
        )
        return _finish(
            transitions, final_state, schedule, num_chains, False, sampler,
            chain_type, param_names,
        )
    if engine != "xla":
        raise ValueError(f"Unknown engine: {engine!r}")
    from_state = initial_state is not None
    method, mesh, axis = _resolve_chain_method(chain_method)

    # Vectorized (chain-batched kernel) path: default whenever the sampler
    # provides step_batched and chains are batched. The sequential method and
    # explicit vectorized=False fall back to vmap-of-single-chain kernels
    # (bit-compatible with MCMCSerial, ≙ one-chain-per-worker semantics).
    use_vec = (
        vectorized
        if vectorized is not None
        else (
            num_chains is not None
            and sampler.has_batched_kernel
            and method in ("vmap", "shard_map")
        )
    )

    if from_state:
        # Resume: the state is already (per-chain) batched; thread it through
        # the same batched paths as batched initial params.
        initial_params = initial_state
        initial_params_batched = True

    if use_vec:
        state_sharding = None
        if method == "shard_map":
            from ..parallel.mesh import chain_sharding, make_mesh

            m = mesh if mesh is not None else make_mesh(axis=axis)
            if num_chains % m.shape[axis] != 0:
                raise ValueError(
                    f"num_chains={num_chains} must be divisible by mesh size "
                    f"{m.shape[axis]}"
                )
            state_sharding = chain_sharding(m, axis)
        chain_fn = build_chain_fn(
            sampler, model, schedule, collect_states,
            from_state=from_state, iteration_offset=iteration_offset,
            batch_shape=(num_chains,), init_batched=initial_params_batched,
            state_sharding=state_sharding,
        )
        if initial_params is None:
            out, final_state = jax.jit(lambda k: chain_fn(k))(master)
        else:
            out, final_state = jax.jit(chain_fn)(master, initial_params)
        return _finish(
            out, final_state, schedule, num_chains, collect_states, sampler,
            chain_type, param_names,
        )

    chain_fn = build_chain_fn(
        sampler, model, schedule, collect_states,
        from_state=from_state, iteration_offset=iteration_offset,
    )

    if num_chains is None and method == "shard_map":
        raise ValueError(
            "chain_method=MCMCDistributed()/'shard_map' shards the chain "
            "batch over the mesh and therefore requires num_chains."
        )
    if num_chains is None:
        fn = jax.jit(chain_fn) if initial_params is not None else jax.jit(
            lambda k: chain_fn(k)
        )
        args = (master,) if initial_params is None else (master, initial_params)
        out, final_state = fn(*args)
    else:
        chain_keys = jax.random.split(master, num_chains)
        if initial_params is None:
            batched = jax.vmap(lambda k: chain_fn(k))
            args = (chain_keys,)
        elif initial_params_batched:
            batched = jax.vmap(chain_fn)
            args = (chain_keys, initial_params)
        else:
            batched = jax.vmap(lambda k: chain_fn(k, initial_params))
            args = (chain_keys,)

        if method == "vmap":
            out, final_state = jax.jit(batched)(*args)
        elif method == "sequential":
            if initial_params is None:
                single = jax.jit(lambda k: chain_fn(k))
                results = [single(chain_keys[c]) for c in range(num_chains)]
            elif initial_params_batched:
                single = jax.jit(chain_fn)
                results = [
                    single(
                        chain_keys[c],
                        jax.tree_util.tree_map(lambda x: x[c], initial_params),
                    )
                    for c in range(num_chains)
                ]
            else:
                single = jax.jit(lambda k: chain_fn(k, initial_params))
                results = [single(chain_keys[c]) for c in range(num_chains)]
            out = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *[r[0] for r in results]
            )
            final_state = jax.tree_util.tree_map(
                lambda *xs: jnp.stack(xs), *[r[1] for r in results]
            )
        elif method == "shard_map":
            from ..parallel.sharded import shard_chain_fn

            sharded = shard_chain_fn(
                batched, mesh=mesh, axis=axis, num_chains=num_chains
            )
            out, final_state = sharded(*args)
        else:  # pragma: no cover
            raise ValueError(method)

    return _finish(
        out, final_state, schedule, num_chains, collect_states, sampler,
        chain_type, param_names,
    )


def _finish(
    out, final_state, schedule, num_chains, collect_states, sampler,
    chain_type, param_names,
):
    if collect_states:
        transitions, states = out
    else:
        transitions, states = out, None

    result = SamplingResult(
        transitions=transitions,
        final_state=final_state,
        schedule=schedule,
        num_chains=num_chains,
        states=states,
        sampler=sampler,
    )
    return _convert(result, chain_type, param_names)


def _convert(result: SamplingResult, chain_type, param_names):
    if chain_type in (None, "raw"):
        return result
    if chain_type == "chains":
        return result.to_chains(param_names=param_names)
    if chain_type == "structarray":
        return result.to_structarray(param_names=param_names)
    if chain_type in ("namedtuples", "vector_of_namedtuples"):
        return result.to_namedtuples(param_names=param_names)
    raise ValueError(f"Unknown chain_type: {chain_type!r}")
