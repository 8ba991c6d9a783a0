"""Functional environment interface: noise-as-input, auto-reset.

The reference structures envs as a template-method class hierarchy around a
stateful C++ simulator (vss/vss_gym_base.py:72-90, ssl/ssl_gym_base.py:73-90)
with truncation supplied by gymnasium's ``TimeLimit``
(rsoccer_gym/__init__.py:3-30).

Here an env is a plain object holding only static Python constants, and its
dynamics are *deterministic pure functions of pre-drawn noise*:

    transition_noise_spec() -> {name: (shape, "uniform"|"normal")}
    reset_noise_spec()      -> {name: (shape, "uniform"|"normal")}
    reset_state(noise)              -> state
    transition(state, act, noise)   -> (state, reward, terminated, info)
    observe(state)                  -> obs

Randomness enters only through the declared noise blocks.  This decouples the
PRNG from the env logic: the batched layer (``rsoccer_tpu.batch.vecenv``)
draws each step's entire noise block with ONE fused generator call per kind
— with whatever key implementation the caller provides (threefry, or
``rbg`` for XLA's RngBitGenerator) — instead of thousands of tiny per-env
threefry splits.

Key-based conveniences are provided on top:

    reset(key)                 -> (state, obs)
    step_env(state, act, key)  -> (state, obs, reward, terminated, info)
    step(state, act, key)      -> (state, obs, reward, term, trunc, info)

``step`` folds TimeLimit truncation and auto-reset in: when an episode ends
the returned state/obs are those of a freshly reset episode (reward/flags/
info still describe the ending step); the observation is computed once, from
the post-select state.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

NoiseSpec = Dict[str, Tuple[Tuple[int, ...], str]]


def _flat_sizes(spec: NoiseSpec, kind: str):
    return [
        (name, shape, math.prod(shape))
        for name, (shape, k) in spec.items()
        if k == kind
    ]


def draw_noise(key, spec: NoiseSpec, batch: int | None = None):
    """Draw every block of ``spec`` with one generator call per kind.

    ``batch``: if given, a trailing batch axis is appended to every block —
    the batched layer's one-fused-draw path.
    """
    uni = _flat_sizes(spec, "uniform")
    nrm = _flat_sizes(spec, "normal")
    n_u = sum(s for _, _, s in uni)
    n_n = sum(s for _, _, s in nrm)
    ku, kn = jax.random.split(key)
    tail = () if batch is None else (batch,)
    if not spec:
        # keep the pytree non-empty so vmap always has a mapped leaf (e.g.
        # Dribbling's deterministic reset); costs no generator call
        return {"_pad": jnp.zeros((1,) + tail)}
    out = {}
    if n_u:
        # optimization_barrier: without it XLA fuses the generator into
        # every consumer, REGENERATING the full block once per consuming
        # fusion.
        # The barrier materialises the block once; consumers read slices.
        u = jax.lax.optimization_barrier(jax.random.uniform(ku, (n_u,) + tail))
        off = 0
        for name, shape, size in uni:
            out[name] = u[off : off + size].reshape(shape + tail)
            off += size
    if n_n:
        n = jax.lax.optimization_barrier(jax.random.normal(kn, (n_n,) + tail))
        off = 0
        for name, shape, size in nrm:
            out[name] = n[off : off + size].reshape(shape + tail)
            off += size
    return out


def strongify(tree):
    """Clear weak typing on every leaf.

    Reset states built from Python scalars (``jnp.asarray(-0.1)``,
    ``jnp.full(n, jnp.pi)``) carry weak-typed leaves, while stepped states
    are strong-typed — without this, the second call of a jitted
    rollout/step silently retraces and recompiles.
    """
    return jax.tree.map(lambda l: jnp.asarray(l, jnp.asarray(l).dtype), tree)


class Env:
    """Base class — subclasses define obs_size/action_size/max_episode_steps
    and implement the noise-spec'd hooks above."""

    obs_size: int
    action_size: int
    max_episode_steps: int

    # -- to implement ------------------------------------------------------
    def transition_noise_spec(self) -> NoiseSpec:
        return {}

    def reset_noise_spec(self) -> NoiseSpec:
        return {}

    def reset_state(self, noise):
        raise NotImplementedError

    def transition(self, state, action, noise):
        """-> (next_state, reward, terminated, info)."""
        raise NotImplementedError

    def observe(self, state) -> jnp.ndarray:
        raise NotImplementedError

    # -- core pure step (noise injected; what the batched layer vmaps) -----
    def step_with_noise(self, state, action, t_noise, r_noise):
        ns, reward, terminated, info = self.transition(state, action, t_noise)
        # gymnasium's TimeLimit sets truncated whenever the step budget is
        # hit, independently of terminated (both may be True on the same
        # step) — mirror that.
        truncated = ns.steps >= self.max_episode_steps
        done = jnp.logical_or(terminated, truncated)
        reset_state = self.reset_state(r_noise)
        out_state = jax.tree.map(
            lambda r, n: jnp.where(done, r, n), reset_state, ns
        )
        return (
            out_state,
            self.observe(out_state),
            reward,
            terminated,
            truncated,
            info,
        )

    def step_with_noise_final(self, state, action, t_noise, r_noise):
        """Like :meth:`step_with_noise` but additionally returns the FINAL
        (pre-auto-reset) observation — gymnasium's same-step autoreset
        convention surfaces it as ``final_obs``.  Costs a second obs build,
        so only API-compat layers use it; the hot rollout path does not.

        Returns (state, obs, final_obs, reward, terminated, truncated, info).
        """
        ns, reward, terminated, info = self.transition(state, action, t_noise)
        truncated = ns.steps >= self.max_episode_steps
        done = jnp.logical_or(terminated, truncated)
        final_obs = self.observe(ns)
        reset_state = self.reset_state(r_noise)
        out_state = jax.tree.map(
            lambda r, n: jnp.where(done, r, n), reset_state, ns
        )
        return (
            out_state,
            self.observe(out_state),
            final_obs,
            reward,
            terminated,
            truncated,
            info,
        )

    # -- key-based conveniences (single-env) -------------------------------
    def reset(self, key) -> Tuple[Any, jnp.ndarray]:
        state = strongify(self.reset_state(draw_noise(key, self.reset_noise_spec())))
        return state, self.observe(state)

    def step_env(self, state, action, key):
        """Raw step: no truncation, no auto-reset."""
        noise = draw_noise(key, self.transition_noise_spec())
        ns, reward, terminated, info = self.transition(state, action, noise)
        return ns, self.observe(ns), reward, terminated, info

    def step(self, state, action, key):
        """transition + TimeLimit truncation + auto-reset."""
        kt, kr = jax.random.split(key)
        return self.step_with_noise(
            state,
            action,
            draw_noise(kt, self.transition_noise_spec()),
            draw_noise(kr, self.reset_noise_spec()),
        )

    # -- conveniences ------------------------------------------------------
    def zero_info(self) -> Dict[str, jnp.ndarray]:
        return {}
