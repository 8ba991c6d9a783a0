"""Gymnasium VectorEnv wrapper over the batched envs.

The reference has no vector API at all (SURVEY §2: not even
``gymnasium.vector``); this gives gymnasium-ecosystem users (e.g.
vector-env-based training loops) the batched engine behind the standard
``VectorEnv`` interface: numpy in, numpy out.

Auto-reset follows gymnasium's SAME_STEP convention
(``metadata["autoreset_mode"] = AutoresetMode.SAME_STEP``): the step that
ends an episode returns the *reset* observation, while the final pre-reset
observation and that episode's info are surfaced under ``infos["final_obs"]``
/ ``infos["final_info"]`` with the standard ``_final_obs`` mask — what
gymnasium-convention training code (e.g. advantage bootstrapping on
truncation) relies on.
"""

from __future__ import annotations

from typing import Optional

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv


class VectorGymnasiumEnv(gym.vector.VectorEnv):
    """numpy-facing vectorised env backed by a jitted batched step."""

    metadata = {"autoreset_mode": gym.vector.AutoresetMode.SAME_STEP}

    def __init__(self, env_id: str, num_envs: int, **kwargs):
        self.env = rsoccer_tpu.make(env_id, **kwargs)
        self.benv = BatchedEnv(self.env, num_envs)
        self.num_envs = num_envs
        self.single_action_space = gym.spaces.Box(
            low=-1, high=1, shape=(self.env.action_size,), dtype=np.float32
        )
        self.single_observation_space = gym.spaces.Box(
            low=-1.2, high=1.2, shape=(self.env.obs_size,), dtype=np.float32
        )
        self.action_space = gym.vector.utils.batch_space(
            self.single_action_space, num_envs
        )
        self.observation_space = gym.vector.utils.batch_space(
            self.single_observation_space, num_envs
        )
        self._state = None
        self._key = jax.random.PRNGKey(0)
        self._reset_fn = jax.jit(self.benv.reset)
        self._step_fn = jax.jit(self.benv.step_final)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        self._key, k = jax.random.split(self._key)
        self._state, obs = self._reset_fn(k)
        return np.asarray(obs).T, {}

    def step(self, actions):
        actions = jnp.asarray(actions, jnp.float32).T  # (A, B) lane layout
        self._key, k = jax.random.split(self._key)
        self._state, obs, final_obs, reward, term, trunc, info = self._step_fn(
            self._state, actions, k
        )
        # one batched D2H transfer for everything
        obs, final_obs, reward, term, trunc, info = jax.device_get(
            (obs, final_obs, reward, term, trunc, info)
        )
        infos = {k_: np.asarray(v) for k_, v in info.items()}
        done = np.logical_or(term, trunc)
        if done.any():
            # gymnasium SAME_STEP convention: object arrays masked by done
            fo = np.full(self.num_envs, None, dtype=object)
            fi = np.full(self.num_envs, None, dtype=object)
            final_obs_t = np.asarray(final_obs).T  # (B, obs)
            for i in np.nonzero(done)[0]:
                fo[i] = final_obs_t[i]
                fi[i] = {k_: infos[k_][i] for k_ in infos}
            infos["final_obs"] = fo
            infos["_final_obs"] = done.copy()
            infos["final_info"] = fi
            infos["_final_info"] = done.copy()
        return (
            np.asarray(obs).T,
            np.asarray(reward),
            np.asarray(term),
            np.asarray(trunc),
            infos,
        )

    def close_extras(self, **kwargs):
        pass
