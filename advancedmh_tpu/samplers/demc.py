"""Differential-evolution MCMC (DE-MC, ter Braak 2006).

Beyond-parity sampler (not in the reference — the natural companion to the
reference's only ensemble method, emcee at src/emcee.jl): a population of
members where each proposal is a scaled *difference of two other members*,

    y = x_i + γ·(x_{r1} − x_{r2}) + ε,          ε ~ N(0, noise_scale²·I)

with γ = 2.38/√(2d) (the ter Braak 2006 default, optimal for Gaussian
targets) and occasional γ = 1 "mode-jump" moves that let the population hop
between modes. The difference-vector proposal self-tunes to the target's
covariance — DE-MC is the population analog of adaptive Metropolis.

The optional **snooker update** (ter Braak-Vrugt 2008, taken with
probability ``snooker_probability`` per member-step) moves along the line
through x and a third member z by the *projected* difference of two others,
y = x + γ_s((x_{r1}−x_{r2})·ê)ê with ê = (x−z)/‖x−z‖, accepted with the
Hastings factor ‖y−z‖^{d−1}/‖x−z‖^{d−1}. Snooker moves travel farther in
directions the population spans and decorrelate faster in high d; the paper
recommends a ~10% mixing fraction and γ_s = 2.38/√2.

The batched formulation mirrors this framework's emcee (samplers/emcee.py): the
reference-style sequential population update would serialize, so the
population splits red-black — each half moves *in parallel* with both
difference members drawn from the frozen complementary half. Given the
frozen half, the proposal density is symmetric in (x_i, y) (r1, r2 are
exchangeable, ε is symmetric), so plain MH acceptance applies and detailed
balance holds per half-move. Mode-jump moves are taken *stochastically*
(probability ``jump_probability`` per member-step) rather than on ter
Braak's fixed every-10th-step schedule: a mixture kernel needs no iteration
counter in the state and each component preserves the target.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.density import as_model, logdensity
from ..proposals import as_static_proposal_tree, propose_initial
from ..utils import KeyArray
from .base import Sampler, Transition


@dataclasses.dataclass(frozen=True)
class DifferentialEvolution(Sampler):
    """DE-MC population sampler.

    ``payload`` (a Distribution or list of Distributions) seeds the initial
    per-member prior draws (≙ emcee's StretchProposal payload role);
    ``gamma=None`` uses the 2.38/√(2d) default at step time.

    ``n_members`` must be even (red-black halves) and ≥ 6 so each frozen
    half offers distinct difference pairs (ter Braak 2006 recommends
    ≥ 2d–3d members).
    """

    n_members: int
    payload: Any
    gamma: Optional[float] = None
    noise_scale: float = 1e-4
    jump_probability: float = 0.1
    snooker_probability: float = 0.0
    snooker_gamma: float = 1.683  # 2.38/√2, ter Braak-Vrugt 2008 §2

    is_population = True

    def __post_init__(self):
        if self.n_members % 2 != 0 or self.n_members < 6:
            raise ValueError(
                f"n_members must be even and ≥ 6, got {self.n_members}"
            )
        if not 0.0 <= self.snooker_probability <= 1.0:
            raise ValueError(
                f"snooker_probability must be in [0, 1], got "
                f"{self.snooker_probability}"
            )

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _dim_of(params) -> int:
        leaves = jax.tree_util.tree_leaves(params)
        return int(sum(int(np.prod(l.shape[1:])) for l in leaves))

    def _gamma(self, d: int) -> float:
        if self.gamma is not None:
            return float(self.gamma)
        return 2.38 / float(np.sqrt(2.0 * d))

    # -- kernel ------------------------------------------------------------

    def init(
        self, key: KeyArray, model, initial_params: Optional[Any] = None
    ) -> Tuple[Transition, Transition]:
        """Each member drawn from the payload as a static prior draw;
        ``initial_params`` (leading member axis) overrides."""
        model = as_model(model)
        if initial_params is None:
            keys = jax.random.split(key, self.n_members)
            static = as_static_proposal_tree(self.payload)
            params = jax.vmap(lambda k: propose_initial(k, static))(keys)
        else:
            params = initial_params
            got = jax.tree_util.tree_leaves(params)[0].shape[0]
            if got != self.n_members:
                raise ValueError(
                    f"initial_params carries {got} members but the sampler "
                    f"was built with n_members={self.n_members}"
                )
        lp = jax.vmap(lambda p: logdensity(model, p))(params)
        t = Transition(params, lp, jnp.zeros((self.n_members,), bool))
        return t, t

    def _half_move(self, key, active_params, active_lp, other_params, other_lp, model):
        """Parallel DE move of one half against the frozen other half."""
        n_active = jax.tree_util.tree_leaves(active_lp)[0].shape[0]
        n_other = jax.tree_util.tree_leaves(other_lp)[0].shape[0]
        d = self._dim_of(active_params)
        gamma = self._gamma(d)

        (key_r1, key_r2, key_j, key_eps, key_acc,
         key_z, key_s) = jax.random.split(key, 7)
        # Two distinct members of the frozen half: draw r1 in [0, H) and
        # r2 in [0, H-1), bumping r2 past r1 (the standard distinct-pair trick).
        r1 = jax.random.randint(key_r1, (n_active,), 0, n_other)
        r2 = jax.random.randint(key_r2, (n_active,), 0, n_other - 1)
        r2 = r2 + (r2 >= r1)
        x1 = jax.tree_util.tree_map(lambda p: p[r1], other_params)
        x2 = jax.tree_util.tree_map(lambda p: p[r2], other_params)

        # γ per member: mode-jump (γ=1) with probability jump_probability.
        jump = jax.random.uniform(key_j, (n_active,)) < self.jump_probability
        g = jnp.where(jump, 1.0, gamma)

        leaves = jax.tree_util.tree_leaves(active_params)
        eps_keys = jax.random.split(key_eps, len(leaves))
        eps_treedef = jax.tree_util.tree_structure(active_params)
        eps = jax.tree_util.tree_unflatten(
            eps_treedef,
            [
                self.noise_scale * jax.random.normal(k, l.shape, l.dtype)
                for k, l in zip(eps_keys, leaves)
            ],
        )

        def de_move(xi, a, b, e):
            gb = g.reshape((n_active,) + (1,) * (xi.ndim - 1))
            return xi + gb * (a - b) + e

        y = jax.tree_util.tree_map(de_move, active_params, x1, x2, eps)
        # Proposal-density log-ratio: 0 for the (symmetric) difference move.
        log_ratio = jnp.zeros((n_active,))

        if self.snooker_probability > 0.0:
            # Snooker update (ter Braak-Vrugt 2008 §2): move along the line
            # through x and a third member z, y = x + γ_s((x1−x2)·ê)ê with
            # ê = (x−z)/‖x−z‖ (the projected difference is anchor-free), and
            # Hastings factor ‖y−z‖^{d−1}/‖x−z‖^{d−1} for the line-to-volume
            # change of variables.
            bcast = lambda s, ref: s.reshape(
                (n_active,) + (1,) * (ref.ndim - 1)
            )
            # z distinct from r1 and r2: draw in [0, H-2) and bump past both.
            z_idx = jax.random.randint(key_z, (n_active,), 0, n_other - 2)
            lo, hi = jnp.minimum(r1, r2), jnp.maximum(r1, r2)
            z_idx = z_idx + (z_idx >= lo)
            z_idx = z_idx + (z_idx >= hi)
            xz = jax.tree_util.tree_map(lambda p: p[z_idx], other_params)

            def tree_dot(a, b):
                parts = jax.tree_util.tree_map(
                    lambda u, v: jnp.sum(
                        (u * v).reshape(u.shape[0], -1), axis=1
                    ),
                    a,
                    b,
                )
                return sum(jax.tree_util.tree_leaves(parts))

            e = jax.tree_util.tree_map(
                lambda xi, zz: xi - zz, active_params, xz
            )
            ee = tree_dot(e, e)
            safe = ee > 1e-30  # x ≡ z: direction undefined → force reject
            coef = self.snooker_gamma * tree_dot(
                jax.tree_util.tree_map(lambda a, b: a - b, x1, x2), e
            ) * jnp.where(safe, 1.0 / jnp.maximum(ee, 1e-30), 0.0)
            y_s = jax.tree_util.tree_map(
                lambda xi, ei: xi + bcast(coef, ei) * ei, active_params, e
            )
            ey = jax.tree_util.tree_map(
                lambda yy, zz: yy - zz, y_s, xz
            )
            ee_y = tree_dot(ey, ey)
            log_j = jnp.where(
                safe & (ee_y > 1e-30),
                0.5 * (d - 1) * (jnp.log(jnp.maximum(ee_y, 1e-30))
                                 - jnp.log(jnp.maximum(ee, 1e-30))),
                -jnp.inf,
            )
            snooker = (
                jax.random.uniform(key_s, (n_active,))
                < self.snooker_probability
            )
            y = jax.tree_util.tree_map(
                lambda ys, yd: jnp.where(bcast(snooker, ys), ys, yd), y_s, y
            )
            log_ratio = jnp.where(snooker, log_j, 0.0)

        lp_y = jax.vmap(lambda p: logdensity(model, p))(y)

        # logα = Δlp + proposal log-ratio (0 unless a snooker move).
        logalpha = lp_y - active_lp + log_ratio
        accepted = -jax.random.exponential(key_acc, (n_active,)) < logalpha

        new_params = jax.tree_util.tree_map(
            lambda yy, pp: jnp.where(
                accepted.reshape((n_active,) + (1,) * (yy.ndim - 1)), yy, pp
            ),
            y,
            active_params,
        )
        new_lp = jnp.where(accepted, lp_y, active_lp)
        return new_params, new_lp, accepted

    def step(self, key: KeyArray, state: Transition, model) -> Tuple[Transition, Transition]:
        """One full population update = two complementary half-moves."""
        model = as_model(model)
        h = self.n_members // 2
        key_a, key_b = jax.random.split(key)

        take = lambda tree, sl: jax.tree_util.tree_map(lambda x: x[sl], tree)
        pA, lpA = take(state.params, slice(0, h)), state.lp[:h]
        pB, lpB = take(state.params, slice(h, None)), state.lp[h:]

        pA, lpA, accA = self._half_move(key_a, pA, lpA, pB, lpB, model)
        pB, lpB, accB = self._half_move(key_b, pB, lpB, pA, lpA, model)

        params = jax.tree_util.tree_map(
            lambda x, y: jnp.concatenate([x, y], axis=0), pA, pB
        )
        lp = jnp.concatenate([lpA, lpB])
        accepted = jnp.concatenate([accA, accB])
        t = Transition(params, lp, accepted)
        return t, t
