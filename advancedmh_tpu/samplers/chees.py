"""ChEES-HMC: cross-chain trajectory-length adaptation (beyond-parity).

Hoffman, Radul & Sountsov (AISTATS 2021) — the many-chain, SIMD-friendly
alternative to NUTS. NUTS picks a per-chain, data-dependent trajectory
length (dynamic control flow — hostile to batched accelerators: every chain
waits for the deepest tree). ChEES instead tunes ONE shared trajectory
length T for the whole chain batch by stochastic gradient ascent on the
Change in the Estimator of the Expected Square criterion

    ChEES(T) = (1/4) · E[ (‖x′ − μ‖² − ‖x − μ‖²)² ],    μ = E[x],

whose gradient signal comes *for free* from the cross-chain batch: with the
trajectory end-velocity v′ = M⁻¹p′ (= dx′/dT), the per-chain contribution
is Δ·⟨x′−μ, v′⟩ weighted by the acceptance probability. All chains run the
SAME (jittered) trajectory length each iteration — no divergence between
chains of a batch — and the chain-axis means compile to a ``psum`` across
devices under GSPMD sharding (SURVEY §2 "psum … cross-chain
adaptation stats").

Jointly adapted during warmup, all from shared cross-chain statistics:

- **T** (trajectory length): Adam ascent on log T against the ChEES
  gradient estimate; uniform jitter ``t = u·T`` per iteration decorrelates
  and supplies the gradient scale.
- **ε** (step size): dual averaging (HG14 §3.2) on the cross-chain mean
  acceptance *probability* toward 0.65 — one shared ε (the paper's
  design), far lower variance than any single chain's indicator.
- **diag M⁻¹** (optional, ``adapt_mass=True``): pooled cross-chain Welford
  variance, Stan-regularized (≙ :class:`~.hmc_adapt.AdaptiveHMC` pooled).

Post-warmup everything freezes (ε̄ = exp(log ε̄), T̄ = exp(log T̄), last
M⁻¹) except the per-iteration jitter, which remains part of the kernel —
a fixed trajectory length resonates on near-Gaussian targets (Neal 2011
§5.4.1.3); jitter is what makes frozen-T HMC robust.

The leapfrog trip count ``L = clip(round(u·T/ε), 1, max_leapfrog)`` is a
*traced* integer driving a ``lax.while_loop`` — shared by every chain, so
the loop is one batched gradient evaluation per trip (compiler-friendly:
no per-chain divergence, no dynamic shapes).

Single-chain fallback: with no chain batch there is no cross-chain ChEES
signal; ``step_warmup`` then adapts ε (own acceptance) and per-chain
Welford mass only, holding T at its initial value — documented degradation,
not an error.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from ..models.density import as_model
from ..utils import KeyArray, pytree_dataclass, replace
from .base import GradientTransition, Sampler, accept_reject, select_tree
from .hmc import HamiltonianMC


def _tmap(f, *trees):
    return jax.tree_util.tree_map(f, *trees)


def _tsum(tree):
    return jax.tree_util.tree_reduce(jnp.add, tree)


@pytree_dataclass
class ChEESHMCState:
    """Batched HMC transition + shared (replicated) adaptation statistics."""

    inner: GradientTransition
    log_eps: jax.Array  # shared log step size (dual-averaging iterate)
    log_eps_bar: jax.Array  # running average — frozen post-warmup
    h_bar: jax.Array  # dual-averaging error sum
    log_traj: jax.Array  # shared log trajectory length T (Adam iterate)
    log_traj_bar: jax.Array  # running average — frozen post-warmup
    adam_m: jax.Array  # Adam first moment for log T
    adam_v: jax.Array  # Adam second moment for log T
    t: jax.Array  # warmup iteration counter (int32, starts at 1)
    mean: Any  # Welford mass moments (params-shaped pytrees)
    m2: Any
    n: jax.Array
    inverse_mass: Any


@dataclasses.dataclass(frozen=True)
class ChEESHMC(Sampler):
    """HMC with shared cross-chain (T, ε[, diag M⁻¹]) warmup adaptation.

    ``max_leapfrog`` statically bounds the per-iteration leapfrog trips (the
    compiled while_loop's reachable range); the adapted T is clipped so
    ``T/ε ≤ max_leapfrog`` always holds.
    """

    initial_trajectory_length: float = 1.0
    initial_step_size: float = 0.1
    target_accept: float = 0.65
    max_leapfrog: int = 256
    adapt_mass: bool = True
    learning_rate: float = 0.025  # Adam rate on log T (paper's setting)
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    # Dual-averaging hyperparameters (HG14 §3.2).
    t0: float = 10.0
    kappa: float = 0.75
    gamma: float = 0.05
    mu: Optional[float] = None
    # Mass regularization (≙ AdaptiveHMC).
    mass_regularization: float = 5.0
    mass_warm_start: int = 10

    def __post_init__(self):
        if self.initial_trajectory_length <= 0.0:
            raise ValueError("initial_trajectory_length must be positive")
        if self.initial_step_size <= 0.0:
            raise ValueError("initial_step_size must be positive")
        if not 0.0 < self.target_accept < 1.0:
            raise ValueError("target_accept must be in (0, 1)")
        if int(self.max_leapfrog) < 1:
            raise ValueError("max_leapfrog must be >= 1")
        if self.learning_rate <= 0.0:
            raise ValueError("learning_rate must be positive")
        if not 0.0 <= self.adam_b1 < 1.0 or not 0.0 <= self.adam_b2 < 1.0:
            raise ValueError("adam_b1/adam_b2 must be in [0, 1)")
        if self.gamma <= 0.0:
            raise ValueError("gamma must be positive")
        if self.t0 < 0.0:
            raise ValueError("t0 must be non-negative")
        if not 0.0 < self.kappa <= 1.0:
            raise ValueError("kappa must be in (0, 1]")
        if self.mass_regularization < 0.0:
            raise ValueError("mass_regularization must be non-negative")

    # -- shared helpers ----------------------------------------------------

    @property
    def _mu(self) -> float:
        return (
            math.log(10.0 * self.initial_step_size)
            if self.mu is None
            else self.mu
        )

    @staticmethod
    def _shared(x: jax.Array) -> jax.Array:
        """First element of a replicated statistic (scalar in single-chain)."""
        return x.reshape(-1)[0]

    def transition_of(self, state: ChEESHMCState) -> GradientTransition:
        return state.inner

    def _traced_leapfrog(self, vg, x, p, lp, grad, eps, minv, n_steps):
        """``n_steps`` (a traced int32) leapfrog steps via ``while_loop`` —
        one batched gradient eval per trip, shared by every chain."""

        def cond(carry):
            i, *_ = carry
            return i < n_steps

        def body(carry):
            i, x, p, lp, grad = carry
            p = _tmap(lambda pp, g: pp + 0.5 * eps * g, p, grad)
            x = _tmap(lambda xx, pp, m: xx + eps * m * pp, x, p, minv)
            lp, grad = vg(x)
            p = _tmap(lambda pp, g: pp + 0.5 * eps * g, p, grad)
            return i + 1, x, p, lp, grad

        _, x, p, lp, grad = jax.lax.while_loop(
            cond, body, (jnp.zeros((), jnp.int32), x, p, lp, grad)
        )
        return x, p, lp, grad

    def _n_steps(self, traj, eps):
        return jnp.clip(
            jnp.round(traj / eps).astype(jnp.int32), 1, int(self.max_leapfrog)
        )

    def _dual_avg_eps(self, state, accept_prob_mean):
        t = state.t.astype(jnp.float32)
        ts = self._shared(t)
        w = 1.0 / (ts + self.t0)
        h_bar = (1.0 - w) * self._shared(state.h_bar) + w * (
            self.target_accept - accept_prob_mean
        )
        log_eps = self._mu - jnp.sqrt(ts) / self.gamma * h_bar
        eta = jnp.power(ts, -self.kappa)
        log_eps_bar = eta * log_eps + (1.0 - eta) * self._shared(
            state.log_eps_bar
        )
        return log_eps, log_eps_bar, h_bar

    def _adam_update(self, state, grad_log_T, eps_now):
        """Adam ascent on log T, then clip so 1 ≤ T/ε ≤ max_leapfrog."""
        ts = self._shared(state.t).astype(jnp.float32)
        m = self.adam_b1 * self._shared(state.adam_m) + (
            1.0 - self.adam_b1
        ) * grad_log_T
        v = self.adam_b2 * self._shared(state.adam_v) + (
            1.0 - self.adam_b2
        ) * grad_log_T * grad_log_T
        m_hat = m / (1.0 - self.adam_b1**ts)
        v_hat = v / (1.0 - self.adam_b2**ts)
        log_T = self._shared(state.log_traj) + self.learning_rate * m_hat / (
            jnp.sqrt(v_hat) + 1e-8
        )
        log_T = jnp.clip(
            log_T,
            jnp.log(eps_now),
            jnp.log(float(self.max_leapfrog) * eps_now),
        )
        eta = jnp.power(ts, -self.kappa)
        log_T_bar = eta * log_T + (1.0 - eta) * self._shared(
            state.log_traj_bar
        )
        return log_T, log_T_bar, m, v

    # -- mass adaptation (≙ AdaptiveHMC pooled; diagonal CGL merge) --------

    def _regularized_inverse_mass(self, m2, n, prev):
        r = self.mass_regularization

        def leaf(m2_leaf, prev_leaf):
            nn = jnp.maximum(n, 1.0)
            nn = nn.reshape(nn.shape + (1,) * (m2_leaf.ndim - nn.ndim))
            var = m2_leaf / jnp.maximum(nn - 1.0, 1.0)
            est = (nn / (nn + r)) * var + 1e-3 * (r / (nn + r))
            use = n >= float(self.mass_warm_start)
            use = use.reshape(use.shape + (1,) * (m2_leaf.ndim - use.ndim))
            return jnp.where(use, est, prev_leaf)

        return _tmap(leaf, m2, prev)

    def _welford_pooled(self, mean, m2, n, x, batch_shape):
        bn = len(batch_shape)
        C = float(math.prod(batch_shape))
        axes = tuple(range(bn))
        n0 = n.reshape(-1)[0]
        n_new = n0 + C

        def mean_leaf(mean_l, x_l):
            mean0 = mean_l.reshape((-1,) + mean_l.shape[bn:])[0]
            b_mean = jnp.mean(x_l, axis=axes)
            out = mean0 + (C / n_new) * (b_mean - mean0)
            return jnp.broadcast_to(out, x_l.shape)

        def m2_leaf(m2_l, mean_l, x_l):
            mean0 = mean_l.reshape((-1,) + mean_l.shape[bn:])[0]
            m20 = m2_l.reshape((-1,) + m2_l.shape[bn:])[0]
            b_mean = jnp.mean(x_l, axis=axes)
            centered = x_l - b_mean
            m2_b = jnp.sum(centered * centered, axis=axes)
            delta = b_mean - mean0
            out = m20 + m2_b + (n0 * C / n_new) * delta * delta
            return jnp.broadcast_to(out, x_l.shape)

        mean_out = _tmap(mean_leaf, mean, x)
        m2_out = _tmap(m2_leaf, m2, mean, x)
        return mean_out, m2_out, jnp.broadcast_to(n_new, n.shape)

    def _welford_single(self, mean, m2, n, x):
        n_new = n + 1.0

        def nb(leaf):
            return n_new.reshape(n_new.shape + (1,) * (leaf.ndim - n.ndim))

        mean_new = _tmap(lambda ml, xl: ml + (xl - ml) / nb(xl), mean, x)
        m2_new = _tmap(
            lambda m2l, ml, mnl, xl: m2l + (xl - ml) * (xl - mnl),
            m2, mean, mean_new, x,
        )
        return mean_new, m2_new, n_new

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[GradientTransition, ChEESHMCState]:
        t, inner = HamiltonianMC(self.initial_step_size, 1).init(
            key, model, initial_params
        )
        log_eps0 = jnp.log(jnp.asarray(self.initial_step_size, jnp.float32))
        log_T0 = jnp.log(
            jnp.asarray(self.initial_trajectory_length, jnp.float32)
        )
        zero = jnp.zeros((), jnp.float32)
        state = ChEESHMCState(
            inner=inner,
            log_eps=log_eps0,
            log_eps_bar=log_eps0,
            h_bar=zero,
            log_traj=log_T0,
            log_traj_bar=log_T0,
            adam_m=zero,
            adam_v=zero,
            t=jnp.ones((), jnp.int32),
            mean=_tmap(lambda x: jnp.asarray(x, jnp.float32), inner.params),
            m2=_tmap(jnp.zeros_like, inner.params),
            n=zero,
            inverse_mass=_tmap(jnp.ones_like, inner.params),
        )
        return t, state

    # -- batched kernels (the ChEES hot path) ------------------------------

    def _vg(self, model, bn: int):
        model = as_model(model)
        if model.logdensity_and_gradient_fn is not None:
            vg = model.logdensity_and_gradient_fn
        else:
            vg = jax.value_and_grad(model.logdensity_fn)
        for _ in range(bn):
            vg = jax.vmap(vg)
        return vg

    def _draw_momentum(self, key, params, minv):
        leaves, treedef = jax.tree_util.tree_flatten(params)
        keys = jax.random.split(key, len(leaves))
        ps = [
            jax.random.normal(k, x.shape, x.dtype) / jnp.sqrt(m)
            for k, x, m in zip(keys, leaves, treedef.flatten_up_to(minv))
        ]
        return treedef.unflatten(ps)

    def _kinetic(self, p, minv, bn: int):
        parts = _tmap(
            lambda pp, m: jnp.sum(
                pp * pp * m * 0.5, axis=tuple(range(bn, pp.ndim))
            ),
            p, minv,
        )
        return _tsum(parts)

    def _trajectory_batched(
        self, key, state, model, batch_shape, traj, eps
    ):
        """One jittered shared-length trajectory for the whole batch.

        Returns (x1, p1, lp1, grad1, p0, logalpha, accepted, traj_len).
        """
        bn = len(batch_shape)
        key_mom, key_acc, key_u = jax.random.split(key, 3)
        vg = self._vg(model, bn)
        minv = state.inverse_mass
        u = jax.random.uniform(key_u, (), jnp.float32)
        traj_len = u * traj
        n_steps = self._n_steps(traj_len, eps)
        p0 = self._draw_momentum(key_mom, state.inner.params, minv)
        x1, p1, lp1, grad1 = self._traced_leapfrog(
            vg, state.inner.params, p0, state.inner.lp, state.inner.gradient,
            eps, minv, n_steps,
        )
        logalpha = (lp1 - self._kinetic(p1, minv, bn)) - (
            state.inner.lp - self._kinetic(p0, minv, bn)
        )
        accepted = (
            -jax.random.exponential(key_acc, batch_shape) < logalpha
        )
        return x1, p1, lp1, grad1, logalpha, accepted, traj_len

    def _select_inner(self, state, x1, lp1, grad1, accepted, bn):
        def sel(c, prev):
            mask = accepted.reshape(
                accepted.shape + (1,) * (c.ndim - bn)
            )
            return jnp.where(mask, c, prev)

        params = _tmap(sel, x1, state.inner.params)
        lp = jnp.where(accepted, lp1, state.inner.lp)
        gradient = _tmap(sel, grad1, state.inner.gradient)
        return GradientTransition(params, lp, gradient, accepted)

    def _chees_grad(self, state, x1, p1, w, traj_len, batch_shape):
        """Acceptance-weighted ChEES gradient w.r.t. log T.

        dChEES/dT ∝ E[ Δ·⟨x′−μ′, v′⟩ ],  Δ = ‖x′−μ′‖² − ‖x−μ‖²,
        v′ = M⁻¹p′;  d(u·T)/d(log T) = u·T folds the jitter scale in.
        """
        bn = len(batch_shape)
        axes = tuple(range(bn))

        # Divergence robustness (all observed on Neal's funnel). A diverged
        # or near-divergent trajectory carries a non-finite or astronomically
        # large endpoint (|x| ~ 1e15 while the state stays "finite"): it must
        # be EXCLUDED before the cross-chain means, or one sick chain shifts
        # μ′ for every healthy chain (and an inf endpoint nans the mean,
        # zeroing the whole batch's signal). Healthy = finite,
        # sanely-bounded endpoint per chain — a *rejected* finite endpoint
        # (w = 0) still contributes to the centering means, matching the
        # paper's full-batch μ′.
        def chain_finite(tree):
            flags = _tmap(
                lambda l: jnp.all(
                    jnp.abs(l) < 1e10, axis=tuple(range(bn, l.ndim))
                ),
                tree,
            )
            return jax.tree_util.tree_reduce(jnp.logical_and, flags)

        healthy = (chain_finite(x1) & chain_finite(p1)).astype(jnp.float32)
        cnt = jnp.maximum(jnp.sum(healthy), 1.0)

        def center(tree):
            def leaf(l):
                hb = healthy.reshape(
                    healthy.shape + (1,) * (l.ndim - bn)
                )
                mean = jnp.sum(
                    jnp.where(hb > 0, l, 0.0), axis=axes, keepdims=True
                ) / cnt
                return l - mean

            return _tmap(leaf, tree)

        x0c = center(state.inner.params)
        x1c = center(x1)
        sq = lambda tree: _tsum(
            _tmap(
                lambda l: jnp.sum(l * l, axis=tuple(range(bn, l.ndim))), tree
            )
        )
        delta = sq(x1c) - sq(x0c)  # (C,)
        vel = _tmap(lambda pp, m: pp * m, p1, state.inverse_mass)
        dot = _tsum(
            _tmap(
                lambda a, b: jnp.sum(a * b, axis=tuple(range(bn, a.ndim))),
                x1c, vel,
            )
        )
        contrib = w * delta * dot * healthy
        # f32 overflow backstops: zero any residual non-finite contribution
        # and clamp elements so the batch sum cannot overflow to ±inf (and
        # then nan via +inf − inf). Adam's update size is scale-invariant
        # (≤ learning_rate for any finite g), so the clamps only prevent
        # overflow — they don't distort the adapted-T trajectory.
        contrib = jnp.where(jnp.isfinite(contrib), contrib, 0.0)
        contrib = jnp.clip(contrib, -1e30, 1e30)
        num = jnp.sum(contrib)
        den = jnp.maximum(jnp.sum(w * healthy), 1e-6)
        return jnp.clip(traj_len * num / den, -1e6, 1e6)

    def step_warmup_batched(
        self, key: KeyArray, state: ChEESHMCState, model, batch_shape
    ) -> Tuple[GradientTransition, ChEESHMCState]:
        bn = len(batch_shape)
        eps = jnp.exp(self._shared(state.log_eps))
        traj = jnp.exp(self._shared(state.log_traj))
        x1, p1, lp1, grad1, logalpha, accepted, traj_len = (
            self._trajectory_batched(key, state, model, batch_shape, traj, eps)
        )
        t_inner = self._select_inner(state, x1, lp1, grad1, accepted, bn)

        # Accept probabilities. A divergent trajectory can carry logα = nan
        # (e.g. Neal's funnel: e^{−v} overflows while Σx² underflows, so
        # lp = −inf·0): the MH accept already treats nan as reject (IEEE
        # comparison is false), but nan would poison the *pooled statistics*
        # — treat any non-finite logα as acceptance probability 0.
        w = jnp.where(
            jnp.isfinite(logalpha),
            jnp.exp(jnp.minimum(logalpha, 0.0)),
            0.0,
        )
        # ε: dual averaging on the cross-chain mean acceptance probability.
        log_eps, log_eps_bar, h_bar = self._dual_avg_eps(state, jnp.mean(w))
        # T: Adam ascent on the ChEES gradient.
        g = self._chees_grad(state, x1, p1, w, traj_len, batch_shape)
        log_T, log_T_bar, m, v = self._adam_update(state, g, jnp.exp(log_eps))
        # diag M⁻¹: pooled Welford.
        if self.adapt_mass:
            mean, m2, n = self._welford_pooled(
                state.mean, state.m2, state.n, t_inner.params, batch_shape
            )
            inv_mass = self._regularized_inverse_mass(
                m2, n, state.inverse_mass
            )
        else:
            mean, m2, n, inv_mass = (
                state.mean, state.m2, state.n, state.inverse_mass
            )

        b = lambda s: jnp.broadcast_to(s, batch_shape)
        new_state = ChEESHMCState(
            inner=t_inner,
            log_eps=b(log_eps),
            log_eps_bar=b(log_eps_bar),
            h_bar=b(h_bar),
            log_traj=b(log_T),
            log_traj_bar=b(log_T_bar),
            adam_m=b(m),
            adam_v=b(v),
            t=state.t + 1,
            mean=mean,
            m2=m2,
            n=n,
            inverse_mass=inv_mass,
        )
        return t_inner, new_state

    def step_batched(
        self, key: KeyArray, state: ChEESHMCState, model, batch_shape
    ) -> Tuple[GradientTransition, ChEESHMCState]:
        """Post-warmup: frozen (ε̄, T̄, M⁻¹); jitter stays (anti-resonance)."""
        bn = len(batch_shape)
        eps = jnp.exp(self._shared(state.log_eps_bar))
        traj = jnp.exp(self._shared(state.log_traj_bar))
        x1, p1, lp1, grad1, logalpha, accepted, _ = (
            self._trajectory_batched(key, state, model, batch_shape, traj, eps)
        )
        t_inner = self._select_inner(state, x1, lp1, grad1, accepted, bn)
        return t_inner, replace(state, inner=t_inner)

    # -- single-chain kernels (degraded: no cross-chain ChEES signal) ------

    def _step_single(self, key, state, model, eps, traj, adapt: bool):
        model = as_model(model)
        key_mom, key_acc, key_u = jax.random.split(key, 3)
        minv = state.inverse_mass
        u = jax.random.uniform(key_u, (), jnp.float32)
        n_steps = self._n_steps(u * traj, eps)
        vg = self._vg(model, 0)
        p0 = self._draw_momentum(key_mom, state.inner.params, minv)
        x1, p1, lp1, grad1 = self._traced_leapfrog(
            vg, state.inner.params, p0, state.inner.lp, state.inner.gradient,
            eps, minv, n_steps,
        )
        logalpha = (lp1 - self._kinetic(p1, minv, 0)) - (
            state.inner.lp - self._kinetic(p0, minv, 0)
        )
        accepted = accept_reject(key_acc, logalpha)
        params = select_tree(accepted, x1, state.inner.params)
        lp = jnp.where(accepted, lp1, state.inner.lp)
        gradient = select_tree(accepted, grad1, state.inner.gradient)
        t_inner = GradientTransition(params, lp, gradient, accepted)
        if not adapt:
            return t_inner, replace(state, inner=t_inner)
        # Non-finite logα (divergence) contributes acceptance 0, never nan
        # (see step_warmup_batched).
        w = jnp.where(
            jnp.isfinite(logalpha),
            jnp.exp(jnp.minimum(logalpha, 0.0)),
            0.0,
        )
        log_eps, log_eps_bar, h_bar = self._dual_avg_eps(state, w)
        mean, m2, n = self._welford_single(
            state.mean, state.m2, state.n, params
        )
        inv_mass = (
            self._regularized_inverse_mass(m2, n, state.inverse_mass)
            if self.adapt_mass
            else state.inverse_mass
        )
        return t_inner, replace(
            state,
            inner=t_inner,
            log_eps=log_eps,
            log_eps_bar=log_eps_bar,
            h_bar=h_bar,
            t=state.t + 1,
            mean=mean,
            m2=m2,
            n=n,
            inverse_mass=inv_mass,
        )

    def step(
        self, key: KeyArray, state: ChEESHMCState, model
    ) -> Tuple[GradientTransition, ChEESHMCState]:
        return self._step_single(
            key, state, model,
            jnp.exp(state.log_eps_bar), jnp.exp(state.log_traj_bar),
            adapt=False,
        )

    def step_warmup(
        self, key: KeyArray, state: ChEESHMCState, model
    ) -> Tuple[GradientTransition, ChEESHMCState]:
        """Single-chain warmup: ε + per-chain mass only (T needs chains)."""
        return self._step_single(
            key, state, model,
            jnp.exp(state.log_eps), jnp.exp(state.log_traj),
            adapt=True,
        )
