"""On-device rollout driver: ``lax.scan`` over batched env steps.

Replaces the reference's host-side Python step loop (README.md:116-133 rollout
example; per-step C++ boundary crossings at vss_gym_base.py:72-90) with a
single compiled program: policy -> physics -> obs/reward/done -> auto-reset,
iterated T times with zero host synchronisation and donated state buffers.

RNG: the carry holds one env key and one policy key; each step splits them
once (scalar splits — cheap) and the batched env draws its whole noise block
from the step key (see ``rsoccer_tpu.batch.vecenv``); the key's
implementation (threefry or rbg) picks the generator.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from rsoccer_tpu.batch.vecenv import BatchedEnv


class RolloutCarry(NamedTuple):
    state: object  # batched env state (batch-last leaves)
    obs: jnp.ndarray  # (obs_size, B) lane-layout observations
    key: jnp.ndarray  # env RNG key (whole batch)
    pol_key: jnp.ndarray  # policy key stream
    ep_return: jnp.ndarray  # (B,) running return of the current episode
    ep_length: jnp.ndarray  # (B,) running length of the current episode


class RolloutMetrics(NamedTuple):
    total_reward: jnp.ndarray  # scalar — summed over steps and envs
    episodes: jnp.ndarray  # scalar — number of episode ends observed
    episode_return_sum: jnp.ndarray  # scalar — sum of completed returns
    episode_length_sum: jnp.ndarray  # scalar — sum of completed lengths

    @property
    def mean_episode_return(self):
        return self.episode_return_sum / jnp.maximum(self.episodes, 1)

    @property
    def mean_episode_length(self):
        return self.episode_length_sum / jnp.maximum(self.episodes, 1)


def init_carry(benv: BatchedEnv, key) -> RolloutCarry:
    reset_key, carry_key, pol_key = jax.random.split(key, 3)
    state, obs = benv.reset(reset_key)
    b = benv.n_envs
    return RolloutCarry(
        state, obs, carry_key, pol_key, jnp.zeros((b,)), jnp.zeros((b,))
    )


def uniform_policy(action_size: int):
    """Random policy in [-1, 1], lane layout (A, B)."""

    def policy(key, obs):
        b = obs.shape[-1]
        return jax.random.uniform(key, (action_size, b), minval=-1.0, maxval=1.0)

    return policy


def make_step_fn(benv: BatchedEnv, policy: Callable, metrics_fn: Callable):
    """Shared scan body for rollout/eval drivers.

    ``metrics_fn(reward, done, ep_ret, ep_len, info)`` computes the
    per-step metrics pytree from the PRE-reset episode accumulators; the
    carry's accumulators are zeroed on done lanes afterwards.
    """

    def one_step(carry: RolloutCarry, _):
        step_key, next_key = jax.random.split(carry.key)
        pol_key, next_pol = jax.random.split(carry.pol_key)
        actions = policy(pol_key, carry.obs)
        state, obs, reward, term, trunc, info = benv.step(
            carry.state, actions, step_key
        )
        done = term | trunc
        ep_ret = carry.ep_return + reward
        ep_len = carry.ep_length + 1.0
        metrics = metrics_fn(reward, done, ep_ret, ep_len, info)
        ep_ret = jnp.where(done, 0.0, ep_ret)
        ep_len = jnp.where(done, 0.0, ep_len)
        return (
            RolloutCarry(state, obs, next_key, next_pol, ep_ret, ep_len),
            metrics,
        )

    return one_step


def make_rollout_fn(
    benv: BatchedEnv,
    n_steps: int,
    policy: Callable | None = None,
    unroll: int = 1,
):
    """Build ``rollout(carry) -> (carry, metrics)`` running ``n_steps``
    batched steps fully on-device.  Jit with ``donate_argnums=0``.

    ``policy(key, obs) -> actions`` sees lane-layout obs ``(obs_size, B)``
    and must return ``(action_size, B)``.
    """
    if policy is None:
        policy = uniform_policy(benv.action_size)

    def metrics_fn(reward, done, ep_ret, ep_len, info):
        return RolloutMetrics(
            total_reward=jnp.sum(reward),
            episodes=jnp.sum(done.astype(jnp.int32)),
            episode_return_sum=jnp.sum(jnp.where(done, ep_ret, 0.0)),
            episode_length_sum=jnp.sum(jnp.where(done, ep_len, 0.0)),
        )

    one_step = make_step_fn(benv, policy, metrics_fn)

    def rollout(carry: RolloutCarry):
        carry, ms = jax.lax.scan(one_step, carry, None, length=n_steps, unroll=unroll)
        return carry, jax.tree.map(jnp.sum, ms)

    return rollout
