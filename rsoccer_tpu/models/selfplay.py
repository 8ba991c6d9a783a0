"""Self-play machinery: a frozen opponent drives the yellow team.

``SelfPlayBatchedEnv`` adapts a both-teams-controlled
:class:`~rsoccer_tpu.envs.vss_selfplay.VSSSelfPlayEnv` back into the
blue-only interface the learners expect: the learner supplies blue actions,
while yellow actions come from a frozen policy evaluated on the MIRRORED
observation (the field rotated 180 degrees with teams swapped — see
``VSSSelfPlayEnv.mirror_world``), so one "blue attacking +x" network plays
both sides.

The opponent's parameters (and the obs-normaliser statistics it was trained
under) travel INSIDE the env state as an :class:`OpponentPayload`.  That
makes an opponent swap a pure data operation between train steps — no
retrace, no recompile — which is what makes frozen-past self-play cheap:

    benv = SelfPlayBatchedEnv(env, n_envs, trainer.net, init_params)
    state = trainer.init(key)
    ...
    state = benv.swap_opponent(state, snapshot_params, snapshot_obs_norm)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.envs.vss_selfplay import VSSSelfPlayEnv


class OpponentPayload(NamedTuple):
    params: dict
    norm_mean: jnp.ndarray  # (O,) obs-normaliser the snapshot trained under
    norm_var: jnp.ndarray  # (O,)


class SelfPlayBatchedEnv:
    """BatchedEnv-compatible adapter (reset/step/n_envs/obs_size/action_size)
    whose state is ``(inner_state, OpponentPayload)``.

    ``ou_lanes``: the first K batch lanes play against the REFERENCE
    opponent distribution instead of the frozen policy — yellow robots
    driven by the Ornstein-Uhlenbeck process of VSS-v0 (vss_gym.py:127-140;
    process state rides the env state's ``ou_x`` field, which self-play
    otherwise carries unused).  Mixing anchors training on the distribution
    the absolute evaluation (tools/vss_anchor_eval.py) measures — the
    round-4 league drifted to 63.4% on that anchor while plain single-agent
    PPO reached 72.9% — while the remaining lanes keep self-play pressure.
    """

    def __init__(
        self, env: VSSSelfPlayEnv, n_envs: int, net, init_params,
        ou_lanes: int = 0,
    ):
        self.env = env
        self.benv = BatchedEnv(env, n_envs)
        self.n_envs = n_envs
        self.obs_size = env.obs_size
        self.action_size = env.action_size // 2  # learner drives blue only
        self.net = net
        if not 0 <= ou_lanes <= n_envs:
            raise ValueError(f"ou_lanes={ou_lanes} not in [0, {n_envs}]")
        self.ou_lanes = ou_lanes
        self._init_payload = OpponentPayload(
            params=init_params,
            norm_mean=jnp.zeros((env.obs_size,)),
            norm_var=jnp.ones((env.obs_size,)),
        )
        self._opp_obs_v = jax.vmap(
            env.observe_opponent, in_axes=-1, out_axes=-1
        )

    def reset(self, key):
        state, obs = self.benv.reset(key)
        # fresh buffers every reset: the payload ends up inside donated
        # TrainStates, and donation would delete a shared _init_payload
        payload = jax.tree.map(
            lambda x: jnp.array(x, copy=True), self._init_payload
        )
        return (state, payload), obs

    def _yellow_actions(self, inner, opp, key):
        """Frozen-policy yellow actions, with the first ``ou_lanes`` lanes
        overridden by the reference OU process (advanced in-place on the
        env state's ``ou_x``).  Returns (inner, yellow_actions)."""
        opp_obs = self._opp_obs_v(inner)  # (O, B) mirrored view
        # same normalisation the snapshot saw in training (ObsNorm.normalize)
        o = jnp.clip(
            (opp_obs.T - opp.norm_mean) / jnp.sqrt(opp.norm_var + 1e-8),
            -10.0, 10.0,
        )
        mean, _log_std, _v = self.net.apply(opp.params, o)
        # deterministic opponent, clipped to the Box(-1, 1) action space
        # (same boundary rule as PPOTrainer's rollout/make_policy)
        yellow = jnp.clip(mean.T, -1.0, 1.0)
        if self.ou_lanes:
            from rsoccer_tpu.envs import ou

            nb = self.env.n_blue
            ou_x = ou.ou_update(
                inner.ou_x,
                jax.random.normal(key, inner.ou_x.shape),
                self.env.time_step,
            )
            inner = inner._replace(ou_x=ou_x)
            # yellow rows of the (n_robots, 2, B) process, flattened to the
            # (A, B) action layout (robot-major, wheels within robot) —
            # unclipped, exactly how VSS-v0 feeds OU to the wheel model
            yellow_ou = ou_x[nb:].reshape(self.action_size, -1)
            is_ou = (jnp.arange(self.n_envs) < self.ou_lanes)[None, :]
            yellow = jnp.where(is_ou, yellow_ou, yellow)
        return inner, yellow

    def step(self, state, blue_actions, key):
        inner, opp = state
        k_ou, key = jax.random.split(key)
        inner, yellow_actions = self._yellow_actions(inner, opp, k_ou)
        full = jnp.concatenate([blue_actions, yellow_actions], axis=0)
        inner, obs, reward, term, trunc, info = self.benv.step(inner, full, key)
        return (inner, opp), obs, reward, term, trunc, info

    def step_final(self, state, blue_actions, key):
        """Like :meth:`step` but also returns the final pre-reset obs
        (PPO bootstraps truncated lanes from its value)."""
        inner, opp = state
        k_ou, key = jax.random.split(key)
        inner, yellow_actions = self._yellow_actions(inner, opp, k_ou)
        full = jnp.concatenate([blue_actions, yellow_actions], axis=0)
        inner, obs, fobs, reward, term, trunc, info = self.benv.step_final(
            inner, full, key
        )
        return (inner, opp), obs, fobs, reward, term, trunc, info

    # ----------------------------------------------------------- opponents
    def payload_from(self, params, obs_norm=None) -> OpponentPayload:
        """Snapshot the given params (+ optional models.ppo.ObsNorm).

        Deep-copies every leaf: train loops donate the TrainState buffers
        into the jitted step, and a payload aliasing them would be deleted
        on the next update."""
        params = jax.tree.map(lambda x: jnp.array(x, copy=True), params)
        if obs_norm is None:
            return self._init_payload._replace(params=params)
        return OpponentPayload(
            params=params,
            norm_mean=jnp.array(obs_norm.mean, copy=True),
            norm_var=jnp.array(obs_norm.var, copy=True),
        )

    @staticmethod
    def swap_opponent(train_state, payload: OpponentPayload):
        """Replace the frozen opponent inside a PPO TrainState — pure data,
        safe between jitted train steps (no retrace).

        Embeds a COPY of the payload: the TrainState is donated into the
        jitted train step, which would delete the caller's payload buffers
        if they were shared."""
        inner, _old = train_state.env_state
        payload = jax.tree.map(lambda x: jnp.array(x, copy=True), payload)
        return train_state._replace(env_state=(inner, payload))
