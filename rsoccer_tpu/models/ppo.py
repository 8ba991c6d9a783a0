"""PPO trainer fused with the on-device rollout.

A full training iteration — T batched env steps, GAE, and K epochs of
minibatched clipped-surrogate updates — is ONE jitted program: no host
round-trips, rollout storage lives in (T, ...) scan stacks on the device, and
the policy/value matmuls run in bf16.

Scales by sharding the env batch over the mesh (data parallelism); gradients
are averaged across shards by jit/XLA automatically when the batch axis is
sharded (the mean over the batch induces the collective).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.networks import (
    ActorCritic,
    gaussian_entropy,
    gaussian_logp,
    sample_action,
)


class PPOConfig(NamedTuple):
    rollout_steps: int = 128
    num_epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    anneal_updates: int = 0  # >0: linear lr decay to 0 over this many updates
    max_grad_norm: float = 0.5
    normalize_obs: bool = True  # running mean/std normalisation
    # keep normalising with the restored stats but stop updating them —
    # for fine-tuning a warm-started policy: fresh rollouts quickly swamp
    # the restored moment estimates, and a normalisation shift under a
    # precision-fitted policy silently re-scales its effective weights
    freeze_obs_norm: bool = False
    # critic warmup for warm-started policies: freeze actor params (and
    # log_std) for the first N updates so the fresh value head fits the
    # returns before its noise reaches the policy gradient — fine-tuning a
    # 96.8% BC clone with a cold critic measured 96.8% -> 37% in 50 updates
    critic_warmup_updates: int = 0
    # "shuffle": classic PPO — every epoch draws a fresh permutation of all
    # T*B samples (random-row gathers over the whole flat buffer dominate
    # the measured update time).  "time": permute only the TIME axis
    # and slice minibatches as (T/num_minibatches) random steps x ALL envs —
    # contiguous reads instead of row gathers.  With thousands of
    # independent parallel envs each minibatch is still sample-diverse
    # (the env axis is i.i.d.; only the few same-env timesteps inside one
    # minibatch stay correlated).
    minibatch_mode: str = "shuffle"
    # actor/critic tower widths (models/networks.ActorCritic)
    hidden: tuple = (256, 256)
    # lax.scan unroll for the rollout loop: >1 amortises the per-iteration
    # scan overhead (same lever as the bench driver's unroll; the physics
    # kernel + policy body is replicated, so keep it small)
    rollout_unroll: int = 1


class ObsNorm(NamedTuple):
    """Running mean/var (Welford-style batched updates)."""

    mean: jnp.ndarray  # (O,)
    var: jnp.ndarray  # (O,)
    count: jnp.ndarray  # scalar

    @staticmethod
    def init(obs_size: int):
        return ObsNorm(
            mean=jnp.zeros((obs_size,)),
            var=jnp.ones((obs_size,)),
            count=jnp.asarray(1e-4),
        )

    def update(self, batch):
        """batch (N, O) -> updated stats."""
        return self.update_moments(batch.mean(0), batch.var(0), batch.shape[0])

    def update_moments(self, b_mean, b_var, b_count):
        delta = b_mean - self.mean
        tot = self.count + b_count
        mean = self.mean + delta * (b_count / tot)
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta**2 * (self.count * b_count / tot)
        return ObsNorm(mean=mean, var=m2 / tot, count=tot)

    def normalize(self, obs):
        """obs (..., O) -> normalised, clipped to +-10."""
        return jnp.clip(
            (obs - self.mean) / jnp.sqrt(self.var + 1e-8), -10.0, 10.0
        )


class TrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    env_state: object  # batched env state (batch-last leaves)
    obs: jnp.ndarray  # (O, B)
    env_key: jnp.ndarray  # env RNG key (whole batch)
    obs_norm: "ObsNorm"
    update_step: jnp.ndarray


class Transition(NamedTuple):
    obs: jnp.ndarray  # (B, O)
    action: jnp.ndarray  # (B, A)
    logp: jnp.ndarray  # (B,)
    value: jnp.ndarray  # (B,)
    reward: jnp.ndarray  # (B,)
    term: jnp.ndarray  # (B,) terminated (true episode end)
    trunc: jnp.ndarray  # (B,) truncated (TimeLimit cut, not terminal)
    # V(final pre-reset obs) — the correct GAE bootstrap on truncated
    # lanes.  Gymnasium truncation semantics (the reference inherits them
    # via TimeLimit, rsoccer_gym/__init__.py:4): a truncated episode is
    # NOT terminal, so returns must bootstrap from the value of the last
    # observation of the old episode, not zero and not the fresh spawn.
    boot_value: jnp.ndarray  # (B,)


class PPOTrainer:
    def __init__(self, benv: BatchedEnv, config: PPOConfig = PPOConfig()):
        self.benv = benv
        self.cfg = config
        self.net = ActorCritic(
            action_size=benv.action_size, hidden=tuple(config.hidden)
        )
        # optax schedules tick per optimiser step; one trainer update runs
        # num_epochs x num_minibatches of those
        lr = (
            optax.linear_schedule(
                config.lr, 0.0,
                config.anneal_updates
                * config.num_epochs
                * config.num_minibatches,
            )
            if config.anneal_updates > 0
            else config.lr
        )
        self.tx = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(lr),
        )

    # ------------------------------------------------------------------
    def init(self, key) -> TrainState:
        k_net, k_env, k_keys = jax.random.split(key, 3)
        obs_dummy = jnp.zeros((1, self.benv.obs_size))
        params = self.net.init(k_net, obs_dummy)
        env_state, obs = self.benv.reset(k_env)
        return TrainState(
            params=params,
            opt_state=self.tx.init(params),
            env_state=env_state,
            obs=obs,
            env_key=k_keys,
            obs_norm=ObsNorm.init(self.benv.obs_size),
            update_step=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------------
    def _rollout(self, params, env_state, obs, env_key, obs_norm, key):
        """Collect cfg.rollout_steps transitions. obs is lane-layout (O, B)."""

        def one_step(carry, step_key):
            env_state, obs, env_key, o_sum, o_sq = carry
            # raw-obs moment accumulators feed the running normaliser
            o_sum = o_sum + obs.sum(axis=-1)
            o_sq = o_sq + (obs * obs).sum(axis=-1)
            net_obs = obs_norm.normalize(obs.T) if self.cfg.normalize_obs else obs.T
            mean, log_std, value = self.net.apply(params, net_obs)
            action, logp = sample_action(step_key, mean, log_std)
            env_step_key, env_key = jax.random.split(env_key)
            # envs define Box(-1, 1) action spaces (and the reference's SSL
            # command conversion does NOT clip, e.g. v_theta
            # static_defenders.py:142) — clip at the env boundary like SB3
            # does, keeping the unclipped sample for the log-prob
            act = jnp.clip(action.T, -1.0, 1.0)
            ns, nobs, fobs, reward, term, trunc, info = self.benv.step_final(
                env_state, act, env_step_key
            )
            net_fobs = (
                obs_norm.normalize(fobs.T) if self.cfg.normalize_obs else fobs.T
            )
            # value of the pre-reset obs; only the value head survives
            # DCE here (mean/log_std outputs are unused)
            _, _, boot_value = self.net.apply(params, net_fobs)
            t = Transition(
                obs=net_obs, action=action, logp=logp, value=value,
                reward=reward,
                term=term.astype(jnp.float32),
                trunc=trunc.astype(jnp.float32),
                boot_value=boot_value,
            )
            return (ns, nobs, env_key, o_sum, o_sq), t

        o = jnp.zeros((self.benv.obs_size,))
        step_keys = jax.random.split(key, self.cfg.rollout_steps)
        (env_state, obs, env_key, o_sum, o_sq), traj = jax.lax.scan(
            one_step, (env_state, obs, env_key, o, o), step_keys,
            unroll=self.cfg.rollout_unroll,
        )
        n = self.cfg.rollout_steps * self.benv.n_envs
        raw_mean = o_sum / n
        raw_var = jnp.maximum(o_sq / n - raw_mean**2, 0.0)
        return env_state, obs, env_key, (raw_mean, raw_var, n), traj

    def _gae(self, traj: Transition, last_value):
        """GAE as an associative scan (no sequential T-step loop).

        The backward recurrence ``gae_t = delta_t + c_t * gae_{t+1}`` with
        ``c_t = gamma * lambda * (1 - done_t)`` is a first-order linear
        recurrence, so it runs as ``lax.associative_scan`` in O(log T)
        sweeps over the whole (T, B) buffer instead of T sequential
        micro-steps, each of which costs per-iteration loop overhead.
        """
        cfg = self.cfg
        # truncated-but-not-terminated lanes bootstrap from the value of
        # the final pre-reset obs (value_{t+1} is the NEXT episode's spawn
        # there); terminated lanes don't bootstrap at all — gymnasium
        # semantics, terminal dominates when both
        next_value = jnp.concatenate(
            [traj.value[1:], last_value[None]], axis=0
        )
        nv = jnp.where(traj.trunc > 0.5, traj.boot_value, next_value)
        delta = traj.reward + cfg.gamma * nv * (1.0 - traj.term) - traj.value
        done = jnp.maximum(traj.term, traj.trunc)
        c = cfg.gamma * cfg.gae_lambda * (1.0 - done)

        # reverse time so the recurrence reads y_k = d_k + c_k * y_{k-1};
        # composing affine maps x -> d + c*x gives the associative op
        # (a then b) = (d_b + c_b * d_a, c_a * c_b)
        def op(a, b):
            return b[0] + b[1] * a[0], a[1] * b[1]

        y, _ = jax.lax.associative_scan(op, (delta[::-1], c[::-1]))
        advantages = y[::-1]
        returns = advantages + traj.value
        return advantages, returns

    def _loss(self, params, batch, advantages, returns):
        cfg = self.cfg
        mean, log_std, value = self.net.apply(params, batch.obs)
        logp = gaussian_logp(batch.action, mean, log_std)
        ratio = jnp.exp(logp - batch.logp)
        adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        unclipped = ratio * adv
        clipped = jnp.clip(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv
        policy_loss = -jnp.mean(jnp.minimum(unclipped, clipped))
        value_loss = 0.5 * jnp.mean((value - returns) ** 2)
        entropy = gaussian_entropy(log_std)
        total = (
            policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
        )
        metrics = {
            "loss": total,
            "policy_loss": policy_loss,
            "value_loss": value_loss,
            "entropy": entropy,
        }
        return total, metrics

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, key):
        """One full PPO iteration; jit this (donate state)."""
        cfg = self.cfg
        k_roll, k_perm = jax.random.split(key)
        env_state, obs, env_key, raw_moments, traj = self._rollout(
            state.params, state.env_state, state.obs, state.env_key,
            state.obs_norm, k_roll
        )
        last_obs = (
            state.obs_norm.normalize(obs.T) if cfg.normalize_obs else obs.T
        )
        _, _, last_value = self.net.apply(state.params, last_obs)
        advantages, returns = self._gae(traj, last_value)

        def apply_minibatch(carry, b, adv_b, ret_b):
            params, opt_state = carry
            grads, metrics = jax.grad(self._loss, has_aux=True)(
                params, b, adv_b, ret_b
            )
            if cfg.critic_warmup_updates:
                scale = (
                    state.update_step >= cfg.critic_warmup_updates
                ).astype(jnp.float32)

                def _mask(path, g):
                    keys = [str(getattr(p, "key", "")) for p in path]
                    actor = any(
                        k.startswith("actor") or k == "log_std"
                        for k in keys
                    )
                    return g * scale if actor else g

                grads = jax.tree_util.tree_map_with_path(_mask, grads)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), metrics

        if cfg.minibatch_mode == "time":
            # permute the time axis only; minibatch = mt random steps x all
            # envs, read as contiguous (B, ...) rows — no row gathers
            t_steps = cfg.rollout_steps
            if t_steps % cfg.num_minibatches:
                raise ValueError(
                    "minibatch_mode='time' needs rollout_steps divisible "
                    f"by num_minibatches ({t_steps} % {cfg.num_minibatches})"
                )
            mt = t_steps // cfg.num_minibatches

            def epoch(carry, ek):
                perm_t = jax.random.permutation(ek, t_steps)

                def shuf(x):
                    x = jnp.take(x, perm_t, axis=0)
                    return x.reshape(
                        (cfg.num_minibatches, mt * x.shape[1]) + x.shape[2:]
                    )

                batches = jax.tree.map(shuf, traj)
                carry, metrics = jax.lax.scan(
                    lambda c, xs: apply_minibatch(c, *xs),
                    carry,
                    (batches, shuf(advantages), shuf(returns)),
                )
                return carry, metrics

        else:
            if cfg.minibatch_mode != "shuffle":
                raise ValueError(
                    f"unknown minibatch_mode {cfg.minibatch_mode!r}"
                )
            # flatten (T, B) -> (N,) and gather fresh random rows per epoch
            flat = jax.tree.map(
                lambda x: x.reshape((-1,) + x.shape[2:]), traj
            )
            adv_f = advantages.reshape(-1)
            ret_f = returns.reshape(-1)
            n = adv_f.shape[0]
            mb = n // cfg.num_minibatches

            def epoch(carry, ek):
                perm = jax.random.permutation(ek, n)

                def minibatch(carry, idx):
                    take = lambda x: jnp.take(x, idx, axis=0)
                    return apply_minibatch(
                        carry, jax.tree.map(take, flat),
                        take(adv_f), take(ret_f),
                    )

                idxs = perm[: mb * cfg.num_minibatches].reshape(
                    cfg.num_minibatches, mb
                )
                carry, metrics = jax.lax.scan(minibatch, carry, idxs)
                return carry, metrics

        eks = jax.random.split(k_perm, cfg.num_epochs)
        (params, opt_state), metrics = jax.lax.scan(
            epoch, (state.params, state.opt_state), eks
        )

        obs_norm = (
            state.obs_norm.update_moments(*raw_moments)
            if cfg.normalize_obs and not cfg.freeze_obs_norm
            else state.obs_norm
        )
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            env_key=env_key,
            obs_norm=obs_norm,
            update_step=state.update_step + 1,
        )
        out_metrics = {
            **jax.tree.map(lambda m: m[-1, -1], metrics),
            "mean_reward": traj.reward.mean(),
            "mean_episode_ends": jnp.maximum(traj.term, traj.trunc).sum(),
        }
        return new_state, out_metrics

    def make_policy(self, params, obs_norm=None, deterministic: bool = True):
        """Lane-layout policy fn usable with batch.rollout drivers."""

        def policy(key, obs):
            o = obs.T if obs_norm is None else obs_norm.normalize(obs.T)
            mean, log_std, _ = self.net.apply(params, o)
            if deterministic:
                return jnp.clip(mean.T, -1.0, 1.0)
            action, _ = sample_action(key, mean, log_std)
            return jnp.clip(action.T, -1.0, 1.0)

        return policy
