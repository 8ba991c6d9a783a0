"""Batched (vmapped) environments.

The reference has no batching of any kind — one env instance drives one C++
simulator synchronously (Simulators/rsim.py:25-33, vss_gym_base.py:72-90).
Here single-env pure functions are vmapped over a *trailing* batch
dimension ("lane layout"): robot state becomes ``(n_robots, B)`` instead of
``(B, n_robots)``, so the env index is the contiguous, fastest-varying axis
of every per-entity array and elementwise step code reads whole rows.

Randomness: envs are deterministic functions of pre-drawn noise (see
``rsoccer_tpu.envs.base``).  The batched layer draws each step's entire
noise block — all envs, all uses — with ONE fused generator call per kind
from a single per-step key.  This replaces thousands of per-env threefry
splits with two wide generator calls, and the key's implementation flows
through: a ``jax.random.key(seed, impl="rbg")`` key fills the blocks with
XLA's ``RngBitGenerator`` instead of threefry.

``BatchedEnv.step`` therefore takes/returns:
    state  — pytree, every leaf with a trailing batch axis
    obs    — ``(obs_size, B)``
    action — ``(action_size, B)``
    key    — ONE key for the whole batch step

Use ``obs.T`` / ``actions.T`` at the API edge when batch-first is needed;
inside a rollout loop everything stays lane-layout.
"""

from __future__ import annotations

import jax

from rsoccer_tpu.envs.base import Env, draw_noise, strongify


class BatchedEnv:
    """vmap wrapper around a single-env :class:`Env`."""

    def __init__(self, env: Env, n_envs: int):
        self.env = env
        self.n_envs = n_envs
        self.obs_size = env.obs_size
        self.action_size = env.action_size
        self._t_spec = env.transition_noise_spec()
        self._r_spec = env.reset_noise_spec()
        self._reset_v = jax.vmap(
            lambda noise: _reset_obs(env, noise), in_axes=-1, out_axes=-1
        )
        self._step_v = jax.vmap(env.step_with_noise, in_axes=-1, out_axes=-1)
        self._step_final_v = jax.vmap(
            env.step_with_noise_final, in_axes=-1, out_axes=-1
        )
        self._step_env_v = jax.vmap(
            lambda s, a, n: _step_env(env, s, a, n), in_axes=-1, out_axes=-1
        )

    def reset(self, key):
        """One key for the whole batch."""
        noise = draw_noise(key, self._r_spec, batch=self.n_envs)
        return self._reset_v(noise)

    def _draw_step_noise(self, key):
        kt, kr = jax.random.split(key)
        return (
            draw_noise(kt, self._t_spec, batch=self.n_envs),
            draw_noise(kr, self._r_spec, batch=self.n_envs),
        )

    def step(self, state, actions, key):
        """Auto-resetting step. actions (A, B), one key."""
        return self._step_v(state, actions, *self._draw_step_noise(key))

    def step_final(self, state, actions, key):
        """Auto-resetting step that also returns the final pre-reset obs
        (gymnasium same-step autoreset convention).  Returns
        (state, obs, final_obs, reward, term, trunc, info)."""
        return self._step_final_v(state, actions, *self._draw_step_noise(key))

    def step_env(self, state, actions, key):
        """Raw step without auto-reset/truncation."""
        t_noise = draw_noise(key, self._t_spec, batch=self.n_envs)
        return self._step_env_v(state, actions, t_noise)


def _reset_obs(env: Env, noise):
    # strongify: avoid weak-typed leaves that make the first post-reset
    # jitted step a silent retrace (see envs/base.strongify)
    state = strongify(env.reset_state(noise))
    return state, env.observe(state)


def _step_env(env: Env, state, action, noise):
    ns, reward, terminated, info = env.transition(state, action, noise)
    return ns, env.observe(ns), reward, terminated, info
