"""Gymnasium-compatible wrapper — drop-in parity with the reference API.

The reference exposes classic Gymnasium class envs (``gym.make("VSS-v0")``
etc., rsoccer_gym/__init__.py:3-30).  This module wraps the functional
envs in a ``gymnasium.Env`` so reference users keep their training loops:
same ids, spaces, reset/step/render/close signatures, degree-based ``frame``
attribute, and info dicts.

Differences (documented, deliberate):
  - Seeding actually works: ``reset(seed=...)`` drives every downstream
    sample via explicit PRNG keys (the reference seeds gymnasium's RNG but
    draws spawns from the global ``random`` module and OU noise from global
    numpy — SURVEY §3.2).
  - Episode truncation is built in (the functional env already applies the
    registry's ``max_episode_steps``); wrapping in ``TimeLimit`` again is a
    no-op but harmless.

Call :func:`register_gymnasium` once to register all five ids under
gymnasium's global registry with a ``"-tpu"`` suffix-free name.
"""

from __future__ import annotations

from typing import Optional

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np

import rsoccer_tpu
from rsoccer_tpu.core.frame import frame_from_world


class GymnasiumEnv(gym.Env):
    """Single-env host-side wrapper around a functional env."""

    metadata = {
        "render.modes": ["human", "rgb_array"],
        "render_modes": ["human", "rgb_array"],
        "render_fps": 60,
        "render.fps": 60,
    }

    def __init__(self, env_id: str, render_mode: Optional[str] = None, **kwargs):
        super().__init__()
        self.env = rsoccer_tpu.make(env_id, **kwargs)
        self.env_id = env_id
        self.render_mode = render_mode
        self.action_space = gym.spaces.Box(
            low=-1, high=1, shape=(self.env.action_size,), dtype=np.float32
        )
        self.observation_space = gym.spaces.Box(
            low=-1.2, high=1.2, shape=(self.env.obs_size,), dtype=np.float32
        )
        self._state = None
        self._key = jax.random.PRNGKey(0)
        self._renderer = None
        # jit the hot fns once per wrapper
        self._reset_fn = jax.jit(self.env.reset)
        self._step_fn = jax.jit(self.env.step_env)
        self.steps = 0

    # -- gymnasium API ------------------------------------------------------
    def reset(self, *, seed: Optional[int] = None, options=None):
        # seed gymnasium's np_random too (conformance: check_env expects
        # super().reset(seed=...) semantics); actual env randomness flows
        # through the jax PRNG key below
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, k = jax.random.split(self._key)
        self._state, obs = self._reset_fn(k)
        self.steps = 0
        if self.render_mode == "human":
            self.render()
        return np.asarray(obs), {}

    def step(self, action):
        action = jnp.asarray(action, jnp.float32)
        if action.shape != (self.env.action_size,):
            raise ValueError(
                f"action shape {action.shape} does not match action space "
                f"({self.env.action_size},) for {self.env_id}"
            )
        self._key, k = jax.random.split(self._key)
        self._state, obs, reward, terminated, info = self._step_fn(
            self._state, action, k
        )
        self.steps += 1
        truncated = self.steps >= self.env.max_episode_steps
        if self.render_mode == "human":
            self.render()
        # one batched D2H transfer for the whole step result (a per-value
        # float() fetch costs one device round-trip each)
        obs_h, reward_h, term_h, info_h = jax.device_get(
            (obs, reward, terminated, info)
        )
        return (
            np.asarray(obs_h),
            float(reward_h),
            bool(term_h),
            bool(truncated),
            {k_: float(v) for k_, v in info_h.items()},
        )

    @property
    def frame(self):
        """Degree-based Frame view of the current state (reference
        ``self.frame``, vss_gym_base.py:61)."""
        if self._state is None:
            return None
        return frame_from_world(
            self._state.world, self.env.n_blue, self.env.n_yellow
        )

    def render(self):
        from rsoccer_tpu.render.renderer import Renderer

        if self._renderer is None:
            self._renderer = Renderer(
                self.env.league, self.render_mode or "rgb_array"
            )
        return self._renderer.render_frame(self.frame)

    def close(self):
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None

    # compatibility accessors mirroring the reference base classes
    @property
    def field(self):
        return self.env.field

    @property
    def n_robots_blue(self):
        return self.env.n_blue

    @property
    def n_robots_yellow(self):
        return self.env.n_yellow


def register_gymnasium():
    """Register all five reference ids in gymnasium's global registry.

    Mirrors rsoccer_gym/__init__.py:3-30 (ids, step limits already baked
    into the functional envs).
    """
    for env_id in rsoccer_tpu.registered_ids():
        if env_id in gym.registry:
            continue
        gym.register(
            id=env_id,
            entry_point="rsoccer_tpu.gym_compat:GymnasiumEnv",
            kwargs={"env_id": env_id},
        )
