"""Hamiltonian Monte Carlo (beyond-parity; no reference analog).

The natural endpoint of the reference's gradient family (src/MALA.jl is the
L=1 special case up to the kick/drift split): simulate Hamiltonian dynamics
for ``n_leapfrog`` leapfrog steps with step size ``step_size``, then accept
with the exact MH test on the total-energy error (Neal 2011, MCMC Using
Hamiltonian Dynamics §5.2; Duane et al. 1987). The MH correction makes the
discretization error vanish — HMC *is* a Metropolis-Hastings sampler with a
deterministic, volume-preserving, reversible proposal, hence in scope here.

Batched shape: the leapfrog loop is a ``lax.fori_loop`` with a **static** trip
count (compiler-friendly control flow; no data-dependent trajectory length —
that is NUTS, deliberately out of family). Each step costs exactly
``n_leapfrog`` fused value-and-gradient evaluations; the gradient is cached
in the transition (≙ GradientTransition, src/MALA.jl:14-19) so trajectories
start without a fresh forward pass. Params may be any pytree; the momentum
carries the same structure.

A diagonal ``inverse_mass`` pytree (matching params) preconditions the
dynamics exactly as a per-dimension step-size rescale: drift uses
``M⁻¹·p``, kinetic energy is ``½·pᵀM⁻¹p``, momenta draw from N(0, M).

Composes with :class:`~.adapt.StepSizeAdaptation` via
``StepSizeAdaptation.hmc(...)`` (dual-averaged ε toward the 0.65 optimum,
HG14 §3.2 / Neal 2011 §5.4.4).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model, check_capabilities, logdensity_and_gradient
from ..utils import KeyArray
from .base import GradientTransition, Sampler, accept_reject, select_tree


def _tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


@dataclasses.dataclass(frozen=True)
class HamiltonianMC(Sampler):
    """Fixed-trajectory HMC: ``n_leapfrog`` leapfrog steps of size
    ``step_size``, exact MH accept on the energy error.

    ``inverse_mass``: optional pytree (matching params, or broadcastable
    leaves) of diagonal inverse-mass entries; ``None`` = identity. Larger
    ``inverse_mass[i]`` = bigger effective step in dimension i (set it to
    the posterior variance estimate, e.g. from a RAM/AM warmup).
    """

    step_size: float
    n_leapfrog: int = 10
    inverse_mass: Optional[Any] = None
    # "endpoint": classic MH accept on the trajectory end (Duane 1987).
    # "multinomial": uniform trajectory offset + multinomial over all L+1
    # states with weights ∝ exp(lp − K) (Neal's windowed HMC with the
    # window = whole trajectory; the within-trajectory sampling NUTS uses,
    # Betancourt 2017 §A.3) — rejection-free, every gradient eval
    # contributes, streamed as a Gumbel-argmax so memory stays O(1) in L.
    trajectory_sampling: str = "endpoint"

    def __post_init__(self):
        # step_size may be a traced scalar under StepSizeAdaptation — only
        # validate concrete Python floats.
        if isinstance(self.step_size, (int, float)) and self.step_size <= 0.0:
            raise ValueError("step_size must be positive")
        if int(self.n_leapfrog) < 1:
            raise ValueError("n_leapfrog must be >= 1")
        if self.trajectory_sampling not in ("endpoint", "multinomial"):
            raise ValueError(
                "trajectory_sampling must be 'endpoint' or 'multinomial'"
            )

    # -- physics -----------------------------------------------------------

    def _minv(self, params):
        if self.inverse_mass is None:
            return _tmap(jnp.ones_like, params)
        return _tmap(
            lambda x, m: jnp.broadcast_to(jnp.asarray(m, x.dtype), x.shape),
            params,
            self.inverse_mass,
        )

    def _draw_momentum(self, key: KeyArray, params):
        """p ~ N(0, M): std = 1/√(M⁻¹) per dimension."""
        minv = self._minv(params)
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves))
        ps = [
            jax.random.normal(k, x.shape, x.dtype) / jnp.sqrt(m)
            for k, x, m in zip(keys, leaves, treedef.flatten_up_to(minv))
        ]
        return treedef.unflatten(ps)

    def _kinetic(self, p, params):
        minv = self._minv(params)
        parts = _tmap(lambda pp, m: jnp.sum(pp * pp * m * 0.5), p, minv)
        return jax.tree_util.tree_reduce(jnp.add, parts)

    def _leapfrog(self, model, x, p, lp, grad):
        """``n_leapfrog`` leapfrog steps; returns (x, p, lp, grad) at the
        trajectory end. Uses the standard kick-drift-kick splitting with the
        two half-kicks of adjacent steps left unfused (clearer, and XLA
        fuses the adjacent elementwise ops anyway)."""
        eps = jnp.asarray(self.step_size, jnp.float32)
        minv = self._minv(x)

        def grad_fn(xx):
            return logdensity_and_gradient(model, xx)

        def body(_, carry):
            x, p, lp, grad = carry
            p = _tmap(lambda pp, g: pp + 0.5 * eps * g, p, grad)
            x = _tmap(lambda xx, pp, m: xx + eps * m * pp, x, p, minv)
            lp, grad = grad_fn(x)
            p = _tmap(lambda pp, g: pp + 0.5 * eps * g, p, grad)
            return x, p, lp, grad

        return jax.lax.fori_loop(
            0, int(self.n_leapfrog), body, (x, p, lp, grad)
        )

    # -- multinomial trajectory sampling -----------------------------------

    def _step_multinomial(
        self, key: KeyArray, state: GradientTransition, model, batch_shape
    ) -> Tuple[GradientTransition, GradientTransition]:
        """Uniform-offset multinomial trajectory sampling (rejection-free).

        A shared offset j ~ U{0..L} places the current state inside an
        (L+1)-state orbit: integrate j leapfrog steps backward and L−j
        forward (exactly L gradient evals, like the endpoint kernel), then
        sample one state ∝ exp(lp − K) via a streaming Gumbel-argmax —
        reversible by the windowed-HMC construction (Neal 1994 §4), exact
        for any ε/L.

        Control flow is one **static-length** ``fori_loop`` of exactly L
        trips: step i integrates backward while ``i < j`` and forward
        otherwise, with the carry reset to the origin state at the switch
        trip (j backward + L−j forward always totals L, so no trip is
        wasted). The earlier two-``while_loop`` formulation measured 1.6x
        slower — traced-bound loops defeat XLA's static scheduling (the
        round-2 multinomial-vs-endpoint ESS comparison carried exactly
        that structural penalty).
        """
        model = as_model(model)
        bn = len(batch_shape)
        key_mom, key_j, key_g = jax.random.split(key, 3)

        if model.logdensity_and_gradient_fn is not None:
            vg = model.logdensity_and_gradient_fn
        else:
            vg = jax.value_and_grad(model.logdensity_fn)
        for _ in range(bn):
            vg = jax.vmap(vg)

        eps = jnp.asarray(self.step_size, jnp.float32)
        minv = self._minv(state.params)
        L = int(self.n_leapfrog)

        def e_for(leaf):
            if eps.ndim == 0 or eps.ndim == leaf.ndim:
                return eps
            return eps.reshape(eps.shape + (1,) * (leaf.ndim - eps.ndim))

        def ke(p):
            parts = _tmap(
                lambda pp, m: jnp.sum(
                    pp * pp * m * 0.5, axis=tuple(range(bn, pp.ndim))
                ),
                p, minv,
            )
            return jax.tree_util.tree_reduce(jnp.add, parts)

        def leap(x, p, grad, sign):
            p = _tmap(lambda pp, g: pp + sign * 0.5 * e_for(pp) * g, p, grad)
            x = _tmap(
                lambda xx, pp, m: xx + sign * e_for(xx) * m * pp, x, p, minv
            )
            lp, grad = vg(x)
            p = _tmap(lambda pp, g: pp + sign * 0.5 * e_for(pp) * g, p, grad)
            return x, p, lp, grad

        def sel(mask, c, prev):
            m = mask.reshape(mask.shape + (1,) * (c.ndim - bn))
            return jnp.where(m, c, prev)

        p0 = self._draw_momentum(key_mom, state.params)
        j = jax.random.randint(key_j, (), 0, L + 1)

        # Streamed argmax over w_i + Gumbel_i, w_i = lp_i − K_i; the moved
        # flag records whether any non-initial state won. All L+1 gumbels
        # come from ONE threefry call — a per-trip fold_in+draw measured as
        # the dominant bookkeeping cost (a full PRNG block per leapfrog
        # step at d=2 dwarfed the physics).
        gums = jax.random.gumbel(
            key_g, (L + 1,) + batch_shape, jnp.float32
        )
        best0 = (
            state.lp - ke(p0) + gums[0],  # score
            state.params, state.lp, state.gradient,
            jnp.zeros(batch_shape, jnp.float32),  # moved
        )

        def body(i, c):
            x, p, lp, grad, best = c
            # Switch trip: the forward segment restarts from the origin
            # (both segments integrate away from the current state).
            at_switch = i == j
            x = _tmap(lambda o, cur: jnp.where(at_switch, o, cur),
                      state.params, x)
            p = _tmap(lambda o, cur: jnp.where(at_switch, o, cur), p0, p)
            lp = jnp.where(at_switch, state.lp, lp)
            grad = _tmap(lambda o, cur: jnp.where(at_switch, o, cur),
                         state.gradient, grad)
            sign = jnp.where(i < j, jnp.float32(-1.0), jnp.float32(1.0))
            x, p, lp, grad = leap(x, p, grad, sign)
            # Gumbel stream indices 1..L: backward trips consume 1..j,
            # forward trips j+1..L — i+1 covers both in one loop.
            score = lp - ke(p) + gums[i + 1]
            bscore, bx, blp, bgrad, moved = best
            upd = score > bscore
            best = (
                jnp.where(upd, score, bscore),
                _tmap(lambda c_, p_: sel(upd, c_, p_), x, bx),
                jnp.where(upd, lp, blp),
                _tmap(lambda c_, p_: sel(upd, c_, p_), grad, bgrad),
                jnp.where(upd, 1.0, moved),
            )
            return x, p, lp, grad, best

        _, _, _, _, best = jax.lax.fori_loop(
            0, L, body, (state.params, p0, state.lp, state.gradient, best0)
        )
        _, x_sel, lp_sel, grad_sel, moved = best
        accepted = moved > 0.5
        t = GradientTransition(x_sel, lp_sel, grad_sel, accepted)
        return t, t

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[GradientTransition, GradientTransition]:
        """HMC requires initial parameters and an order-≥1 model (≙ the
        MALA contract, src/MALA.jl:37 + :42-52)."""
        if initial_params is None:
            raise ValueError("please specify initial parameters")
        model = as_model(model)
        check_capabilities(model)
        lp, grad = logdensity_and_gradient(model, initial_params)
        t = GradientTransition(initial_params, lp, grad, jnp.zeros((), bool))
        return t, t

    def step(
        self, key: KeyArray, state: GradientTransition, model
    ) -> Tuple[GradientTransition, GradientTransition]:
        if self.trajectory_sampling == "multinomial":
            return self._step_multinomial(key, state, model, ())
        model = as_model(model)
        key_mom, key_acc = jax.random.split(key)
        p0 = self._draw_momentum(key_mom, state.params)
        x1, p1, lp1, grad1 = self._leapfrog(
            model, state.params, p0, state.lp, state.gradient
        )
        # ΔH = (lp' − K') − (lp − K): the negated total-energy error.
        logalpha = (lp1 - self._kinetic(p1, x1)) - (
            state.lp - self._kinetic(p0, state.params)
        )
        accepted = accept_reject(key_acc, logalpha)
        params = select_tree(accepted, x1, state.params)
        lp = jnp.where(accepted, lp1, state.lp)
        gradient = select_tree(accepted, grad1, state.gradient)
        t = GradientTransition(params, lp, gradient, accepted)
        return t, t

    def step_batched(
        self, key: KeyArray, state: GradientTransition, model,
        batch_shape: Tuple[int, ...],
    ) -> Tuple[GradientTransition, GradientTransition]:
        """Vectorized HMC step: one batched value-and-gradient per leapfrog
        step across the whole chain batch (the hot path)."""
        if self.trajectory_sampling == "multinomial":
            return self._step_multinomial(key, state, model, batch_shape)
        model = as_model(model)
        key_mom, key_acc = jax.random.split(key)
        bn = len(batch_shape)

        # Batched momenta: leaves already carry batch_shape as leading axes.
        p0 = self._draw_momentum(key_mom, state.params)

        if model.logdensity_and_gradient_fn is not None:
            vg = model.logdensity_and_gradient_fn
        else:
            vg = jax.value_and_grad(model.logdensity_fn)
        for _ in range(bn):
            vg = jax.vmap(vg)

        eps = jnp.asarray(self.step_size, jnp.float32)
        minv = self._minv(state.params)

        def e_for(leaf):
            # Per-chain step sizes (shape == batch_shape, e.g. from
            # AdaptiveHMC) broadcast against each leaf's event dims; a
            # scalar ε passes through untouched.
            if eps.ndim == 0 or eps.ndim == leaf.ndim:
                return eps
            return eps.reshape(eps.shape + (1,) * (leaf.ndim - eps.ndim))

        def body(_, carry):
            x, p, lp, grad = carry
            p = _tmap(lambda pp, g: pp + 0.5 * e_for(pp) * g, p, grad)
            x = _tmap(lambda xx, pp, m: xx + e_for(xx) * m * pp, x, p, minv)
            lp, grad = vg(x)
            p = _tmap(lambda pp, g: pp + 0.5 * e_for(pp) * g, p, grad)
            return x, p, lp, grad

        x1, p1, lp1, grad1 = jax.lax.fori_loop(
            0, int(self.n_leapfrog), body,
            (state.params, p0, state.lp, state.gradient),
        )

        def ke(p, x):  # batched kinetic: reduce all but the batch axes
            minv_b = self._minv(x)
            parts = _tmap(
                lambda pp, m: jnp.sum(
                    pp * pp * m * 0.5, axis=tuple(range(bn, pp.ndim))
                ),
                p, minv_b,
            )
            return jax.tree_util.tree_reduce(jnp.add, parts)

        logalpha = (lp1 - ke(p1, x1)) - (state.lp - ke(p0, state.params))
        accepted = -jax.random.exponential(key_acc, batch_shape) < logalpha

        def sel(c, prev):
            mask = accepted.reshape(batch_shape + (1,) * (c.ndim - bn))
            return jnp.where(mask, c, prev)

        params = _tmap(sel, x1, state.params)
        lp = jnp.where(accepted, lp1, state.lp)
        gradient = _tmap(sel, grad1, state.gradient)
        t = GradientTransition(params, lp, gradient, accepted)
        return t, t
