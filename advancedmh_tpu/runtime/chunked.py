"""Chunked sampling: host offload, per-chunk callbacks, progress.

≙ three reference-runtime capabilities at once (SURVEY.md §5):

- **host offload** for very long runs: 100k-step × 10k-chain outputs do not
  fit in HBM; chunking scans ``chunk_size`` samples at a time and moves each
  chunk to host numpy while the next chunk runs (double-buffered via JAX's
  async dispatch);
- **per-iteration callback** (≙ the AbstractMCMC ``callback`` kwarg,
  exercised by the reference's RAM StatesExtractor test,
  test/RobustAdaptiveMetropolis.jl:14-28): called once per *chunk* on the
  host with the chunk's transitions (and states when ``collect_states``) —
  scan-chunk granularity is the device-friendly cadence for host hooks;
- **progress** (≙ the ``progress`` kwarg): one host-side line per chunk.

Chunk boundaries are invisible to the statistics: resume is bit-exact
(per-step RNG keys are indexed by absolute iteration), so
``sample_chunked(...)`` equals ``sample(...)`` value-for-value.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Optional, Union

import jax
import numpy as np

from ..utils import KeyArray
from ..utils.transfer import safe_device_get
from .checkpoint import load_state, save_state
from .sample import SamplingResult, sample
from .schedule import Schedule


# Chunk/state files both go through checkpoint.save_state/load_state: one
# serializer (PRNG-key aware) and atomic tmp+os.replace writes, so a crash
# mid-write never leaves a corrupt file for resume to load.


class ChunkInfo(int):
    """Chunk index enriched with the chunk's schedule context.

    Passed as the callback's second argument. It *is* the integer chunk
    index (an ``int`` subclass), so existing ``callback(chunk_result, idx)``
    code keeps working unchanged; richer callbacks additionally read

    - ``info.iteration_range`` — the absolute sampler-iteration labels of
      the chunk's emitted draws (a ``range`` with the thinning stride,
      1-based and aligned with ``result.schedule.iterations()`` / the
      Chains ``start``/``thin`` convention: the first kept sample is
      labeled ``discard_initial + 1``; ≙ the reference callback's
      ``iteration`` argument, test/RobustAdaptiveMetropolis.jl:46-56), and
    - ``info.final_state`` — the full sampler state after the chunk (≙ the
      reference callback's ``state`` argument), so adaptation dynamics are
      observable through the public ``sample(callback=...)`` without
      ``collect_states``. ``chunk_size=1`` makes both exactly
      per-iteration.
    """

    iteration_range: range
    final_state: Any

    def __new__(cls, idx: int, iteration_range: range, final_state: Any):
        self = super().__new__(cls, idx)
        self.iteration_range = iteration_range
        self.final_state = final_state
        return self


def sample_chunked(
    model,
    sampler,
    n_samples: int,
    *,
    chunk_size: int = 1000,
    key: Union[int, KeyArray] = 0,
    num_chains: Optional[int] = None,
    initial_params: Any = None,
    initial_params_batched: bool = False,
    initial_state: Any = None,
    iteration_offset: int = 0,
    num_warmup: int = 0,
    discard_initial: Optional[int] = None,
    thinning: int = 1,
    collect_states: bool = False,
    callback: Optional[Callable[[SamplingResult, int], None]] = None,
    progress: bool = False,
    to_host: bool = True,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    store_path: Optional[str] = None,
    param_names=None,
    **kwargs,
) -> SamplingResult:
    """Like :func:`sample` but in chunks of ``chunk_size`` samples.

    Returns a :class:`SamplingResult` whose transition leaves are host numpy
    arrays (``to_host=True``) concatenated over all chunks. ``callback`` runs
    after each chunk with ``(chunk_result, info)`` where ``info`` is a
    :class:`ChunkInfo` — the integer chunk index enriched with
    ``iteration_range`` and ``final_state`` (≙ the reference callback's
    ``(state, iteration)`` arguments).

    **Elastic recovery** (SURVEY.md §5 'failure detection'): with
    ``checkpoint_dir``, each completed chunk writes its transitions
    (``chunk_NNNNN.npz``), the sampler state (``state.npz``), and progress
    metadata (``meta.json``). After a crash, rerunning the identical call
    with ``resume=True`` skips completed chunks (reloaded from disk) and
    continues from the saved state — the result is bit-identical to an
    uninterrupted run.

    ``store_path`` streams every chunk into the native :class:`ChainStore`
    (io/chainstore.py): flattened ``params... , lp`` float32 rows written by
    a background C++ thread, so disk IO overlaps the next device chunk. Read
    back with ``advancedmh_tpu.io.open_reader(store_path)``.
    """
    schedule = Schedule(
        n_samples=n_samples,
        num_warmup=num_warmup,
        discard_initial=discard_initial,
        thinning=thinning,
    )
    D, W, th = schedule.discard_initial, schedule.num_warmup, schedule.thinning

    # ``initial_state``/``iteration_offset`` continue from a previously
    # obtained sampler state (≙ sample()'s resume kwargs): the first chunk
    # then steps from that state with the remaining warmup budget.
    chunks = []
    state = initial_state
    store = None
    offset = iteration_offset
    done = 0
    t0 = time.perf_counter()
    chunk_idx = 0

    def _to_host(res):
        if not to_host:
            return res
        # Hardened transfer: ≤64 MB slices + device-vs-host element
        # verification (utils/transfer.py).
        return SamplingResult(
            transitions=safe_device_get(res.transitions),
            final_state=res.final_state,
            schedule=res.schedule, num_chains=num_chains,
            states=(
                safe_device_get(res.states) if collect_states else None
            ),
            sampler=sampler,
        )

    def _stream_to_store(host):
        nonlocal store
        if store_path is None:
            return
        from ..output.flatten import flatten_params

        lp = np.asarray(host.transitions.lp)
        # lp carries exactly the sample axes — (S,), (C, S), or the
        # ensemble's (S, W) — so its ndim is the correct fold point.
        values, names = flatten_params(
            host.transitions.params, lp.ndim, param_names
        )
        rows = np.concatenate(
            [np.asarray(values), lp[..., None]], axis=-1
        ).reshape(-1, len(names) + 1)
        if store is None:
            from ..io import ChainStore

            store = ChainStore(store_path, list(names) + ["lp"])
        store.append(rows)

    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        meta_path = os.path.join(checkpoint_dir, "meta.json")
        if resume and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            done = meta["samples_done"]
            offset = meta["iteration_offset"]
            chunk_idx = meta["chunks_done"]
            if meta.get("chunk_size") != chunk_size or meta.get(
                "n_samples"
            ) != n_samples:
                raise ValueError(
                    "resume=True requires the same n_samples/chunk_size as "
                    f"the checkpointed run ({meta})."
                )
            if done > 0:
                # Template run (structure only) to deserialize the state and
                # the completed chunk files.
                template_result = sample(
                    model, sampler, 1, key=key, num_chains=num_chains,
                    initial_params=initial_params,
                    initial_params_batched=initial_params_batched,
                    discard_initial=0, collect_states=collect_states, **kwargs,
                )
                # State committed with the last completed chunk (per-chunk
                # file, referenced by the meta.json commit point — a crash
                # between state and meta writes leaves meta pointing at the
                # previous, consistent pair).
                state = load_state(
                    os.path.join(
                        checkpoint_dir, f"state_{chunk_idx - 1:05d}.npz"
                    ),
                    template_result.final_state,
                )
                # Reload completed chunks now and re-stream them into the
                # chain store (ChainStore truncates on open, so the store is
                # rebuilt consistent with the full run).
                for i in range(chunk_idx):
                    tr = load_state(
                        os.path.join(checkpoint_dir, f"chunk_{i:05d}.npz"),
                        template_result.transitions,
                    )
                    st = (
                        load_state(
                            os.path.join(
                                checkpoint_dir, f"states_{i:05d}.npz"
                            ),
                            template_result.states,
                        )
                        if collect_states
                        else None
                    )
                    host = _to_host(
                        SamplingResult(
                            transitions=tr, final_state=None,
                            schedule=schedule, num_chains=num_chains,
                            states=st, sampler=sampler,
                        )
                    )
                    chunks.append(host)
                    _stream_to_store(host)

    def _finalize(rec):
        """Host transfer + store/checkpoint/callback for a completed chunk.
        Runs after the *next* chunk has been dispatched, so the device
        computes chunk k+1 while chunk k crosses to host (the async-dispatch
        double buffer the module docstring promises)."""
        res, idx, done_after, offset_after, n_chunk = rec
        host = _to_host(res)
        chunks.append(host)
        _stream_to_store(host)
        if checkpoint_dir is not None:
            save_state(
                os.path.join(checkpoint_dir, f"chunk_{idx:05d}.npz"),
                host.transitions,
            )
            if collect_states:
                save_state(
                    os.path.join(checkpoint_dir, f"states_{idx:05d}.npz"),
                    host.states,
                )
            save_state(
                os.path.join(checkpoint_dir, f"state_{idx:05d}.npz"),
                res.final_state,
            )
            tmp = os.path.join(checkpoint_dir, "meta.json.tmp")
            with open(tmp, "w") as f:
                json.dump(
                    {
                        "samples_done": done_after,
                        "iteration_offset": offset_after,
                        "chunks_done": idx + 1,
                        "chunk_size": chunk_size,
                        "n_samples": n_samples,
                    },
                    f,
                )
            os.replace(tmp, os.path.join(checkpoint_dir, "meta.json"))
            prev_state = os.path.join(
                checkpoint_dir, f"state_{idx - 1:05d}.npz"
            )
            if idx > 0 and os.path.exists(prev_state):
                os.remove(prev_state)  # superseded by the meta commit above
        if callback is not None:
            callback(host, ChunkInfo(
                idx,
                range(offset_after - (n_chunk - 1) * th + 1,
                      offset_after + 2, th),
                res.final_state,
            ))
        if progress:
            rate = done_after / max(time.perf_counter() - t0, 1e-9)
            print(
                f"[sample] {done_after}/{n_samples} samples "
                f"({rate:.1f} samples/s/chain)",
                file=sys.stderr,
            )

    pending = None
    while done < n_samples:
        n_chunk = min(chunk_size, n_samples - done)
        if state is None:
            res = sample(
                model, sampler, n_chunk, key=key, num_chains=num_chains,
                initial_params=initial_params,
                initial_params_batched=initial_params_batched,
                num_warmup=W, discard_initial=D, thinning=th,
                collect_states=collect_states, **kwargs,
            )
            offset = res.schedule.total_steps
        else:
            # Remaining warmup steps relative to this chunk's start. The
            # very first chunk of a run resumed from a user-supplied state
            # honors the full discard_initial; continuation chunks discard
            # exactly one thinning group before their first emission.
            w_rem = max(0, W - offset)
            res = sample(
                model, sampler, n_chunk, key=key, num_chains=num_chains,
                initial_state=state, iteration_offset=offset,
                num_warmup=w_rem,
                discard_initial=(D if done == 0 else th), thinning=th,
                collect_states=collect_states, **kwargs,
            )
            offset += res.schedule.total_steps
        state = res.final_state
        done += n_chunk
        if pending is not None:
            _finalize(pending)  # chunk k to host while chunk k+1 computes
        pending = (res, chunk_idx, done, offset, n_chunk)
        chunk_idx += 1
    if pending is not None:
        _finalize(pending)

    if store is not None:
        store.close()

    axis = 0 if num_chains is None else 1
    cat = np.concatenate if to_host else (
        lambda xs, axis: jax.numpy.concatenate(xs, axis=axis)
    )
    transitions = jax.tree_util.tree_map(
        lambda *xs: cat(xs, axis=axis), *[c.transitions for c in chunks]
    )
    states = None
    if collect_states:
        states = jax.tree_util.tree_map(
            lambda *xs: cat(xs, axis=axis), *[c.states for c in chunks]
        )
    return SamplingResult(
        transitions=transitions,
        final_state=state,
        schedule=schedule,
        num_chains=num_chains,
        states=states,
        sampler=sampler,
    )
