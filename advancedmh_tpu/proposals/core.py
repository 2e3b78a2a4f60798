"""Composable proposal algebra as pytrees.

≙ reference src/proposal.jl:1-240. The reference's proposal *tree algebra*
(payloads: Distribution / array-of-distributions / function; containers:
Array / NamedTuple / Tuple, src/proposal.jl:132-175) maps onto JAX pytrees:

- A **proposal** is either a :class:`Proposal` leaf or an arbitrary pytree
  (dict / tuple / list / namedtuple) whose leaves are proposals. Samples come
  back "in the shape of the proposal" — scalar, vector, or tree — exactly as
  in the reference.
- Leaf payloads may be a :class:`Distribution`, a list/tuple of distributions
  (elementwise sample / summed log_prob, ≙ src/proposal.jl:26-35), or a
  *callable* returning a distribution (state-dependent proposals,
  ≙ src/proposal.jl:92-126) — the callable is traced into the jitted kernel.
- ``symmetric`` is a *static* Python bool: for symmetric proposals the
  Hastings log-ratio is short-circuited to a compile-time ``0.0`` and the
  proposal density is **never evaluated** (≙ src/proposal.jl:195-196 and the
  reference's CustomNormal negative tests, test/runtests.jl:215-260).

Everything here is shape-polymorphic and trace-stable: the tree structure is
static under jit, so there is no per-leaf dispatch at runtime — XLA sees one
fused propose→logpdf graph (the ≙ of the reference's @generated functions for
type-stable unrolling, src/proposal.jl:152-175).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import jax
import jax.numpy as jnp

from ..distributions import Distribution
from ..utils import KeyArray, pytree_dataclass, static_field

PayloadT = Union[Distribution, Sequence[Distribution], Callable]


class Proposal:
    """Abstract proposal leaf (≙ ``Proposal{P}``, src/proposal.jl:1)."""

    payload: PayloadT
    symmetric: bool


@pytree_dataclass
class StaticProposal(Proposal):
    """Independence proposal: candidates drawn ignoring the current state.

    ≙ ``StaticProposal{issymmetric,P}`` (src/proposal.jl:3-11).
    """

    payload: PayloadT
    symmetric: bool = static_field(default=False)


@pytree_dataclass
class RandomWalkProposal(Proposal):
    """Random-walk proposal: candidate = state + draw(payload).

    ≙ ``RandomWalkProposal{issymmetric,P}`` (src/proposal.jl:13-21).
    """

    payload: PayloadT
    symmetric: bool = static_field(default=False)


def SymmetricStaticProposal(payload) -> StaticProposal:
    """≙ ``SymmetricStaticProposal`` alias (src/proposal.jl:6)."""
    return StaticProposal(payload, symmetric=True)


def SymmetricRandomWalkProposal(payload) -> RandomWalkProposal:
    """≙ ``SymmetricRandomWalkProposal`` alias (src/proposal.jl:16)."""
    return RandomWalkProposal(payload, symmetric=True)


def is_proposal(x: Any) -> bool:
    return isinstance(x, Proposal)


def as_static_proposal_tree(payload):
    """Wrap each Distribution (or Distribution-sequence / callable) leaf of
    a payload pytree in a StaticProposal, so dict/tuple payloads compose the
    same way tree proposals do (the ensemble/population samplers use this
    for their initial per-member prior draws)."""

    def is_leaf(x):
        return (
            isinstance(x, Distribution)
            or _is_dist_seq(x)
            or callable(x)
        )

    return jax.tree_util.tree_map(StaticProposal, payload, is_leaf=is_leaf)


# ---------------------------------------------------------------------------
# Payload-level sample / log_prob (≙ Base.rand / Distributions.logpdf on
# Proposal, src/proposal.jl:24-35)
# ---------------------------------------------------------------------------


def _is_dist_seq(payload) -> bool:
    return isinstance(payload, (list, tuple)) and all(
        isinstance(p, Distribution) for p in payload
    )


def _payload_sample(
    key: KeyArray, payload, batch_shape: tuple = ()
) -> jax.Array:
    """Draw from a payload. ``batch_shape`` prepends an iid batch (the chain
    axis in the vectorized kernel path) — one RNG call for the whole batch,
    the key to batched throughput (no per-chain key folding)."""
    if isinstance(payload, Distribution):
        return payload.sample(key, batch_shape)
    if _is_dist_seq(payload):
        keys = jax.random.split(key, len(payload))
        return jnp.stack(
            [d.sample(k, batch_shape) for d, k in zip(payload, keys)],
            axis=len(batch_shape),
        )
    raise TypeError(
        f"Cannot sample from proposal payload of type {type(payload).__name__}; "
        "expected a Distribution, a sequence of Distributions, or a callable "
        "returning one."
    )


def _payload_sample_prebatched(key: KeyArray, payload) -> jax.Array:
    """Draw from a payload whose *parameters* already carry the batch axis
    (functional proposals resolved against batched state): one RNG call,
    shape follows the payload's own broadcast shape."""
    if isinstance(payload, Distribution):
        return payload.sample(key)
    if _is_dist_seq(payload):
        keys = jax.random.split(key, len(payload))
        return jnp.stack(
            [d.sample(k) for d, k in zip(payload, keys)], axis=-1
        )
    raise TypeError(
        f"Cannot sample from proposal payload of type {type(payload).__name__}."
    )


def _payload_logprob(payload, v, batch_ndim: int = 0) -> jax.Array:
    """Proposal log-density summed over event dims, keeping the leading
    ``batch_ndim`` axes (0 in the per-chain kernel, 1 in the vectorized one)."""

    def _reduce(lp):
        axes = tuple(range(batch_ndim, lp.ndim))
        return jnp.sum(lp, axis=axes) if axes else lp

    if isinstance(payload, Distribution):
        return _reduce(payload.log_prob(v))
    if _is_dist_seq(payload):
        idx = (slice(None),) * batch_ndim
        return sum(
            _reduce(d.log_prob(v[idx + (i,)])) for i, d in enumerate(payload)
        )
    raise TypeError(
        f"Cannot evaluate log_prob of proposal payload {type(payload).__name__}."
    )


def _resolve(proposal: Proposal, t=None) -> Proposal:
    """Resolve a functional payload against the conditioning state.

    ≙ the function-payload call overloads (src/proposal.jl:92-126):
    ``p()`` at init, ``p(t)`` conditioned on the current state.
    """
    payload = proposal.payload
    if callable(payload) and not isinstance(payload, Distribution):
        resolved = payload() if t is None else payload(t)
        if isinstance(resolved, Proposal):
            return resolved
        return type(proposal)(resolved, symmetric=proposal.symmetric)
    return proposal


# ---------------------------------------------------------------------------
# Tree-level propose / q / logratio (≙ src/proposal.jl:41-175, :190-240)
# ---------------------------------------------------------------------------


def _tree_map_with_keys(fn, key, proposals, *rest):
    """tree_map over proposal leaves, giving each leaf its own PRNG subkey."""
    leaves, treedef = jax.tree_util.tree_flatten(proposals, is_leaf=is_proposal)
    rest_leaves = [treedef.flatten_up_to(r) for r in rest]
    keys = jax.random.split(key, len(leaves)) if len(leaves) > 1 else [key]
    out = [fn(k, p, *(rl[i] for rl in rest_leaves)) for i, (k, p) in enumerate(zip(keys, leaves))]
    return treedef.unflatten(out)


def _leaf_is_functional(p: Proposal) -> bool:
    return callable(p.payload) and not isinstance(p.payload, Distribution)


def propose_initial(key: KeyArray, proposals, batch_shape: tuple = ()):
    """Initial draw: sample each leaf's payload directly.

    ≙ first-step ``propose(rng, sampler, model)`` (src/mh-core.jl:76-86 via
    src/proposal.jl:41-47, :70-85): both static and random-walk proposals draw
    from their payload distribution when there is no previous state.
    """

    def draw(k, p):
        return _payload_sample(k, _resolve(p, None).payload, batch_shape)

    return _tree_map_with_keys(draw, key, proposals)


def propose(
    key: KeyArray, proposals, params, batch_shape: tuple = (), conditioner=None
):
    """Propose a candidate conditioned on the current ``params`` pytree.

    ≙ ``propose(rng, proposal, model, t)`` (src/proposal.jl:49-56, :70-85,
    :104-126, :132-175). The ``params`` tree must match the proposal tree
    leaf-for-leaf.

    With ``batch_shape`` (the vectorized kernel path) the ``params`` leaves
    carry a leading chain batch; fixed-distribution payloads draw
    ``batch_shape`` iid samples in one RNG call, while functional payloads
    resolve against the batched conditioner (their distribution parameters
    then already broadcast the batch, so a single un-shaped draw suffices).

    ``conditioner`` is the tree functional payloads are resolved against;
    it defaults to ``params`` (MALA resolves against the *gradient* instead,
    ≙ src/MALA.jl:70).
    """
    if conditioner is None:
        conditioner = params

    def draw(k, p, t, c):
        functional = _leaf_is_functional(p)
        p = _resolve(p, c)
        if functional and batch_shape:
            draw_fn = lambda kk: _payload_sample_prebatched(kk, p.payload)
        else:
            draw_fn = lambda kk: _payload_sample(kk, p.payload, batch_shape)
        if isinstance(p, RandomWalkProposal):
            return t + draw_fn(k)
        return draw_fn(k)

    return _tree_map_with_keys(draw, key, proposals, params, conditioner)


def q(proposals, t, t_cond, batch_ndim: int = 0) -> jax.Array:
    """Proposal log-density ``log g(t | t_cond)`` summed over the tree.

    ≙ ``q`` (src/proposal.jl:58-64, :80-85, :120-126).
    """
    leaves, treedef = jax.tree_util.tree_flatten(proposals, is_leaf=is_proposal)
    t_leaves = treedef.flatten_up_to(t)
    tc_leaves = treedef.flatten_up_to(t_cond)
    total = 0.0
    for p, tl, tcl in zip(leaves, t_leaves, tc_leaves):
        p = _resolve(p, tcl)
        if isinstance(p, RandomWalkProposal):
            total = total + _payload_logprob(p.payload, tl - tcl, batch_ndim)
        else:
            total = total + _payload_logprob(p.payload, tl, batch_ndim)
    return total


def logratio_proposal_density(proposals, state, candidate, batch_ndim: int = 0):
    """Hastings correction ``log g(state|candidate) − log g(candidate|state)``.

    ≙ ``logratio_proposal_density`` (src/proposal.jl:190-240). Symmetric
    leaves contribute a *compile-time* zero and their density is never
    evaluated; a tree that is symmetric everywhere returns the Python float
    ``0.0`` (a static constant under jit — the ≙ of the reference's
    dispatch-level short-circuit at src/proposal.jl:195-196).
    """
    leaves, treedef = jax.tree_util.tree_flatten(proposals, is_leaf=is_proposal)
    s_leaves = treedef.flatten_up_to(state)
    c_leaves = treedef.flatten_up_to(candidate)
    total = 0.0
    for p, sl, cl in zip(leaves, s_leaves, c_leaves):
        if p.symmetric:
            continue
        p_fwd = _resolve(p, sl)  # g(candidate | state)
        p_bwd = _resolve(p, cl)  # g(state | candidate)
        if isinstance(p, RandomWalkProposal):
            total = (
                total
                + _payload_logprob(p_bwd.payload, sl - cl, batch_ndim)
                - _payload_logprob(p_fwd.payload, cl - sl, batch_ndim)
            )
        else:
            total = (
                total
                + _payload_logprob(p_bwd.payload, sl, batch_ndim)
                - _payload_logprob(p_fwd.payload, cl, batch_ndim)
            )
    return total
