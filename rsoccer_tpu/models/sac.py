"""Soft Actor-Critic with an on-device replay buffer.

Second algorithm family next to PPO (models/ppo.py): off-policy, suited to
the sparse-terminal SSL skill tasks.  Everything — env stepping, the
circular replay buffer, critic/actor/temperature updates, polyak targets —
lives in one jitted train step; the buffer is a pytree of preallocated
arrays so there is no host round-trip anywhere in the loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax

from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.networks import dense, dense_init


class SACConfig(NamedTuple):
    buffer_size: int = 1 << 18
    batch_size: int = 256
    env_steps_per_iter: int = 1  # batched env steps per train iteration
    grad_steps_per_iter: int = 1
    gamma: float = 0.99
    tau: float = 0.005  # polyak rate
    lr: float = 3e-4
    compute_dtype: Any = jnp.float32  # actor/critic matmul dtype; bf16
    # mirrors networks.ActorCritic.  Params and the Q/mean/log_std heads
    # stay f32 either way.  Default f32 keeps
    # existing checkpoints' eval numerics bit-stable; flip per-run via
    # train_sac_vss.py --bf16.
    actor_freeze_iters: int = 0  # keep the actor (and temperature) frozen
    # for the first N iterations while the critics fit — the BC-warm-start
    # analog of PPO's --critic-warmup: a cloned actor would otherwise be
    # shredded by gradients from still-random critics in the first updates.
    init_alpha: float = 0.1
    target_entropy_scale: float = 1.0  # target entropy = -scale * act_dim
    warmup_steps: int = 1000  # uniform-random actions before learning
    reward_scale: float = 1.0  # Q-target scale: lift tiny shaped rewards
    # above entropy-term noise (the standard SAC knob for tasks whose
    # per-step rewards are ~1e-2, e.g. the SSL shaping cascades)
    n_step: int = 1  # n-step Q targets.  Insertion is env-major with a
    # fixed stride (one batched step inserts all B envs contiguously), so
    # env b's NEXT transition sits exactly B slots later in the ring —
    # n-step chains are strided gathers, no sequence storage needed.
    # Chains stop at episode boundaries (terminated OR truncated) and
    # bootstrap from the last pre-boundary next_obs.  n_step=1 is exactly
    # classic SAC.  The standard fix for sparse terminal rewards (the
    # measured SAC failure mode on the SSL goal tasks — docs/training.md).


@dataclasses.dataclass(frozen=True)
class SquashedGaussianActor:
    action_size: int
    hidden: tuple = (256, 256)
    compute_dtype: Any = jnp.float32

    def init(self, key, obs) -> dict:
        return {"params": _mlp_init(
            key, obs.shape[-1], self.hidden,
            {"mean": self.action_size, "log_std": self.action_size},
        )}

    def apply(self, params, obs):
        p = params["params"]
        x = _relu_tower(p, obs, len(self.hidden), self.compute_dtype)
        mean = dense(p["mean"], x)
        log_std = jnp.clip(dense(p["log_std"], x), -5.0, 2.0)
        return mean, log_std


@dataclasses.dataclass(frozen=True)
class QCritic:
    hidden: tuple = (256, 256)
    compute_dtype: Any = jnp.float32

    def init(self, key, obs, action) -> dict:
        n_in = obs.shape[-1] + action.shape[-1]
        return {"params": _mlp_init(key, n_in, self.hidden, {"q": 1})}

    def apply(self, params, obs, action):
        p = params["params"]
        x = jnp.concatenate([obs, action], axis=-1)
        x = _relu_tower(p, x, len(self.hidden), self.compute_dtype)
        return dense(p["q"], x)[..., 0]


def _mlp_init(key, n_in, hidden, heads) -> dict:
    """Params of ``fc{i}`` hidden layers plus the named heads, all with
    the lecun-normal kernels of :func:`networks.dense_init`."""
    p = {}
    for i, h in enumerate(hidden):
        p[f"fc{i}"] = dense_init(key, f"fc{i}", n_in, h)
        n_in = h
    for name, n_out in heads.items():
        p[name] = dense_init(key, name, n_in, n_out)
    return p


def _relu_tower(p, x, n_layers, compute_dtype):
    """ReLU hidden layers in ``compute_dtype``; returns float32 features
    for the float32 heads."""
    x = x.astype(compute_dtype)
    for i in range(n_layers):
        x = jax.nn.relu(dense(p[f"fc{i}"], x, compute_dtype))
    return x.astype(jnp.float32)


def sample_squashed(key, mean, log_std):
    std = jnp.exp(log_std)
    z = mean + std * jax.random.normal(key, mean.shape)
    a = jnp.tanh(z)
    # log-prob with tanh correction
    logp = jnp.sum(
        -0.5 * ((z - mean) / std) ** 2 - log_std - 0.5 * jnp.log(2 * jnp.pi),
        axis=-1,
    )
    logp = logp - jnp.sum(jnp.log(1.0 - a**2 + 1e-6), axis=-1)
    return a, logp


class Buffer(NamedTuple):
    obs: jnp.ndarray  # (C, O)
    action: jnp.ndarray  # (C, A)
    rdb: jnp.ndarray  # (C, 3) packed scalars [reward, done, boundary]:
    # done = terminated only (not truncation); boundary = episode end of
    # ANY kind (term | trunc) — the next same-env slot starts a fresh
    # episode, so n-step chains stop there.  Packed into one ring so the
    # n-step chain walk costs ONE row gather instead of three scalar
    # gathers (tools/profile_sac.py).
    next_obs: jnp.ndarray  # (C, O)
    ptr: jnp.ndarray
    filled: jnp.ndarray

    # column indices of the packed scalar ring
    R, D, B = 0, 1, 2

    @property
    def reward(self):
        return self.rdb[:, Buffer.R]

    @property
    def done(self):
        return self.rdb[:, Buffer.D]

    @property
    def boundary(self):
        return self.rdb[:, Buffer.B]

    @staticmethod
    def init(capacity, obs_size, action_size):
        return Buffer(
            obs=jnp.zeros((capacity, obs_size)),
            action=jnp.zeros((capacity, action_size)),
            rdb=jnp.zeros((capacity, 3)),
            next_obs=jnp.zeros((capacity, obs_size)),
            ptr=jnp.zeros((), jnp.int32),
            filled=jnp.zeros((), jnp.int32),
        )

    def add_batch(self, obs, action, reward, next_obs, done, boundary):
        """Insert B transitions at the circular pointer (B must divide C)."""
        b = obs.shape[0]
        c = self.obs.shape[0]
        if c % b == 0:
            # ptr starts at 0 and advances by b mod c, so when b divides c
            # the block [ptr, ptr+b) never wraps — the insert is ONE
            # contiguous dynamic-slice copy per array instead of a
            # row-scatter (`.at[idx].set`).
            upd = lambda arr, val: jax.lax.dynamic_update_slice_in_dim(
                arr, val, self.ptr, axis=0
            )
        else:
            idx = (self.ptr + jnp.arange(b)) % c
            upd = lambda arr, val: arr.at[idx].set(val)
        return self._replace(
            obs=upd(self.obs, obs),
            action=upd(self.action, action),
            rdb=upd(self.rdb, jnp.stack([reward, done, boundary], axis=-1)),
            next_obs=upd(self.next_obs, next_obs),
            ptr=(self.ptr + b) % c,
            filled=jnp.minimum(self.filled + b, c),
        )

    def sample(self, key, batch_size):
        idx = jax.random.randint(
            key, (batch_size,), 0, jnp.maximum(self.filled, 1)
        )
        take = lambda arr: arr[idx]
        rdb = take(self.rdb)
        return (
            take(self.obs), take(self.action), rdb[:, Buffer.R],
            take(self.next_obs), rdb[:, Buffer.D],
        )

    def sample_nstep(self, key, batch_size, stride, n_step, gamma):
        """Sample n-step transitions: ``(obs, action, G, boot_obs,
        boot_disc)`` with ``G = sum_k gamma^k r_k`` up to the first episode
        boundary (inclusive) or ``n_step`` transitions, and ``boot_disc =
        gamma^m * (1 - done_last)`` the bootstrap coefficient for
        ``boot_obs`` (the last chained next_obs).  ``stride`` is the
        insertion batch width B: env b's successor transition lives exactly
        B slots later in the ring.  Chains are drawn only from the window
        where all ``n_step`` links are stored (offset < filled - (n-1)*B
        from the OLDEST element), so they never straddle the write head.
        Reduces exactly to :meth:`sample` semantics at ``n_step=1``."""
        import numpy as np

        c = self.obs.shape[0]
        span = (n_step - 1) * stride
        valid = jnp.maximum(self.filled - span, 1)
        start = jnp.mod(self.ptr - self.filled, c)  # oldest element
        off = jax.random.randint(key, (batch_size,), 0, valid)
        base = jnp.mod(start + off, c)

        # all n_step links of every chain gathered at once — ONE gather per
        # ring array instead of a Python loop of n_step small gathers (the
        # loop form was ~half the SAC iteration's op count,
        # tools/profile_sac.py)
        ks = jnp.arange(n_step)
        pos = jnp.mod(base[None, :] + ks[:, None] * stride, c)  # (n, B)
        rdb = self.rdb[pos]  # (n, B, 3) — one row gather for all scalars
        r = rdb[..., Buffer.R]
        b = rdb[..., Buffer.B]
        # a chain link ends the walk if its episode ended there, or the
        # NEXT link isn't stored yet (early filling, when the valid-window
        # clamp cannot exclude short chains — the chain then truncates and
        # bootstraps from THIS next_obs instead of reading unwritten slots)
        unwritten = (off[None, :] + (ks[:, None] + 1) * stride) >= self.filled
        unwritten = unwritten.at[-1].set(False)  # k = n-1: no next link
        kill = jnp.maximum(b, unwritten.astype(b.dtype))
        alive = jnp.concatenate(
            [jnp.ones((1, batch_size)), jnp.cumprod(1.0 - kill, axis=0)[:-1]],
            axis=0,
        )  # exclusive product: link k alive iff no earlier link killed it
        gammas = jnp.asarray(
            np.power(float(gamma), np.arange(n_step + 1)), dtype=r.dtype
        )
        g = jnp.sum(alive * gammas[:n_step, None] * r, axis=0)
        stop = (b > 0.0) | unwritten | (ks[:, None] == n_step - 1)
        last = jnp.argmax((alive > 0.0) & stop, axis=0)  # first chain end
        take_last = lambda a: jnp.take_along_axis(a, last[None, :], axis=0)[0]
        pos_last = take_last(pos)
        boot_obs = self.next_obs[pos_last]
        # done at the chain end comes from the already-gathered block
        boot_disc = gammas[last + 1] * (1.0 - take_last(rdb[..., Buffer.D]))
        return self.obs[base], self.action[base], g, boot_obs, boot_disc


class SACState(NamedTuple):
    actor_params: Any
    qs_params: Any  # twin critics as ONE stacked tree (leading axis 2):
    # vmapped apply runs both critics in single double-width ops, and one
    # Adam/polyak chain serves both.  The q loss is separable per critic,
    # so the stacked update is mathematically identical to two separate
    # critics — at roughly half the op count (tools/profile_sac.py).
    qs_target: Any
    log_alpha: jnp.ndarray
    opt_actor: optax.OptState
    opt_qs: optax.OptState
    opt_alpha: optax.OptState
    buffer: Buffer
    env_state: Any
    obs: jnp.ndarray  # (O, B)
    env_key: jnp.ndarray
    total_steps: jnp.ndarray


class SACTrainer:
    def __init__(
        self,
        benv: BatchedEnv,
        config: SACConfig = SACConfig(),
        axis_name: str | None = None,
    ):
        """``axis_name``: mesh axis to ``pmean`` gradients over.  Set when
        this trainer runs INSIDE ``shard_map`` as the per-device half of a
        data-parallel step (parallel/sac.py): each device computes grads on
        its local replay minibatch, the pmean makes the applied update the
        gradient of the global-batch mean, so replicated params stay
        bit-identical across devices.  None (default) = single-device."""
        self.benv = benv
        self.cfg = config
        self.axis_name = axis_name
        self.actor = SquashedGaussianActor(
            action_size=benv.action_size, compute_dtype=config.compute_dtype
        )
        self.q = QCritic(compute_dtype=config.compute_dtype)
        self.tx = optax.adam(config.lr)
        self.target_entropy = -config.target_entropy_scale * benv.action_size
        # sample_nstep walks n_step strided links of stride n_envs through
        # the ring; with buffer_size <= (n_step-1)*n_envs the valid window
        # clamps to 1 and every sampled element collapses to the single
        # oldest transition — silent degradation, so reject outright
        if config.buffer_size < config.n_step * benv.n_envs:
            raise ValueError(
                f"buffer_size ({config.buffer_size}) must be >= "
                f"n_step * n_envs ({config.n_step} * {benv.n_envs} = "
                f"{config.n_step * benv.n_envs}) for strided n-step chains"
            )

    def init(self, key) -> SACState:
        ka, k1, k2, kenv, kkey = jax.random.split(key, 5)
        obs_d = jnp.zeros((1, self.benv.obs_size))
        act_d = jnp.zeros((1, self.benv.action_size))
        actor_params = self.actor.init(ka, obs_d)
        q1 = self.q.init(k1, obs_d, act_d)
        q2 = self.q.init(k2, obs_d, act_d)
        qs = jax.tree.map(lambda a, b: jnp.stack([a, b]), q1, q2)
        env_state, obs = self.benv.reset(kenv)
        log_alpha = jnp.log(jnp.asarray(self.cfg.init_alpha))
        copy = lambda t: jax.tree.map(jnp.copy, t)
        return SACState(
            actor_params=actor_params,
            qs_params=qs,
            # distinct buffers: aliasing the live critics would make donated
            # train steps hand the same buffer to Execute() twice
            qs_target=copy(qs),
            log_alpha=log_alpha,
            opt_actor=self.tx.init(actor_params),
            opt_qs=self.tx.init(qs),
            opt_alpha=self.tx.init(log_alpha),
            buffer=Buffer.init(
                self.cfg.buffer_size, self.benv.obs_size, self.benv.action_size
            ),
            env_state=env_state,
            obs=obs,
            env_key=kkey,
            total_steps=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------------
    def _collect(self, state: SACState, key):
        k_act, k_env = jax.random.split(key)
        obs_bf = state.obs.T  # (B, O)
        mean, log_std = self.actor.apply(state.actor_params, obs_bf)
        a_pol, _ = sample_squashed(k_act, mean, log_std)
        a_rand = jax.random.uniform(
            k_act, a_pol.shape, minval=-1.0, maxval=1.0
        )
        action = jnp.where(
            state.total_steps < self.cfg.warmup_steps, a_rand, a_pol
        )
        # true successor obs (pre-reset on episode ends): the replay must
        # bootstrap truncated transitions from the FINAL obs of the
        # episode, not the next episode's spawn.
        env_state, next_obs, final_obs, reward, term, trunc, info = (
            self.benv.step_final(state.env_state, action.T, k_env)
        )
        succ_obs = final_obs
        buffer = state.buffer.add_batch(
            obs_bf, action, reward, succ_obs.T,
            term.astype(jnp.float32),
            (term | trunc).astype(jnp.float32),
        )
        return state._replace(
            buffer=buffer,
            env_state=env_state,
            obs=next_obs,
            total_steps=state.total_steps + 1,
        ), reward

    def _q_both(self, qs_params, obs, action):
        """Both critics in one vmapped (double-width) pass -> (2, B)."""
        return jax.vmap(self.q.apply, in_axes=(0, None, None))(
            qs_params, obs, action
        )

    def _update(self, state: SACState, key):
        cfg = self.cfg
        k_s, k_next, k_pi = jax.random.split(key, 3)
        obs, action, g, boot_obs, boot_disc = state.buffer.sample_nstep(
            k_s, cfg.batch_size, self.benv.n_envs, cfg.n_step, cfg.gamma
        )
        alpha = jnp.exp(state.log_alpha)

        # targets: G_n + gamma^m (1-done) V(boot_obs); at n_step=1 this is
        # the classic  r + gamma (1-done) V(next_obs)
        n_mean, n_log_std = self.actor.apply(state.actor_params, boot_obs)
        next_a, next_logp = sample_squashed(k_next, n_mean, n_log_std)
        tq = self._q_both(state.qs_target, boot_obs, next_a)
        target_v = jnp.min(tq, axis=0) - alpha * next_logp
        target_q = cfg.reward_scale * g + boot_disc * target_v
        target_q = jax.lax.stop_gradient(target_q)

        def q_loss(params):
            q = self._q_both(params, obs, action)
            # SUM of the two per-critic mean losses: the loss separates
            # over the stacked axis, so the grad of each slice equals the
            # standalone critic's grad — one Adam chain, same update
            return jnp.sum(jnp.mean((q - target_q[None, :]) ** 2, axis=1))

        # cross-device mean: per-shard minibatches are equal-sized, so the
        # pmean of per-shard mean-grads IS the grad of the global-batch
        # mean loss (identity when axis_name is unset)
        pmean = (
            (lambda t: jax.tree.map(
                lambda g: jax.lax.pmean(g, self.axis_name), t
            ))
            if self.axis_name
            else (lambda t: t)
        )
        gq = pmean(jax.grad(q_loss)(state.qs_params))
        uq, opt_qs = self.tx.update(gq, state.opt_qs)
        qs_params = optax.apply_updates(state.qs_params, uq)

        def actor_loss(params):
            mean, log_std = self.actor.apply(params, obs)
            a, logp = sample_squashed(k_pi, mean, log_std)
            q = jnp.min(self._q_both(qs_params, obs, a), axis=0)
            return jnp.mean(alpha * logp - q), logp

        (a_loss, logp), ga = jax.value_and_grad(actor_loss, has_aux=True)(
            state.actor_params
        )
        ga = pmean(ga)
        ua, opt_actor = self.tx.update(ga, state.opt_actor)
        actor_params = optax.apply_updates(state.actor_params, ua)

        def alpha_loss(log_alpha):
            return -jnp.mean(
                jnp.exp(log_alpha)
                * jax.lax.stop_gradient(logp + self.target_entropy)
            )

        gal = pmean(jax.grad(alpha_loss)(state.log_alpha))
        ual, opt_alpha = self.tx.update(gal, state.opt_alpha)
        log_alpha = optax.apply_updates(state.log_alpha, ual)

        if cfg.actor_freeze_iters:
            # critics keep learning; actor/temperature hold until the value
            # estimates are trustworthy (BC warm start protection)
            # total_steps was already incremented by this iteration's
            # collect, so iteration i sees total_steps == i+1: freeze the
            # first N iterations means holding while total_steps <= N
            frozen = state.total_steps <= cfg.actor_freeze_iters
            hold = lambda new, old: jax.tree.map(
                lambda n, o: jnp.where(frozen, o, n), new, old
            )
            actor_params = hold(actor_params, state.actor_params)
            opt_actor = hold(opt_actor, state.opt_actor)
            log_alpha = jnp.where(frozen, state.log_alpha, log_alpha)
            opt_alpha = hold(opt_alpha, state.opt_alpha)

        polyak = lambda t, p: jax.tree.map(
            lambda a, b: (1 - cfg.tau) * a + cfg.tau * b, t, p
        )
        metrics = {
            # halved so the reported number stays the per-critic MSE scale
            "q_loss": q_loss(qs_params) * 0.5,
            "actor_loss": a_loss,
            "alpha": jnp.exp(log_alpha),
        }
        return state._replace(
            actor_params=actor_params,
            qs_params=qs_params,
            qs_target=polyak(state.qs_target, qs_params),
            log_alpha=log_alpha,
            opt_actor=opt_actor, opt_qs=opt_qs,
            opt_alpha=opt_alpha,
        ), metrics

    def train_step(self, state: SACState, key):
        """cfg.env_steps_per_iter collects + cfg.grad_steps_per_iter updates;
        jit this (donate state)."""
        rews = jnp.zeros(())
        for _ in range(self.cfg.env_steps_per_iter):
            key, k = jax.random.split(key)
            state, r = self._collect(state, k)
            rews = rews + jnp.mean(r)
        metrics = {}
        for _ in range(self.cfg.grad_steps_per_iter):
            key, k = jax.random.split(key)
            state, metrics = self._update(state, k)
        metrics["mean_reward"] = rews / self.cfg.env_steps_per_iter
        return state, metrics

    def make_policy(self, actor_params, deterministic: bool = True):
        def policy(key, obs):
            mean, log_std = self.actor.apply(actor_params, obs.T)
            if deterministic:
                return jnp.tanh(mean).T
            a, _ = sample_squashed(key, mean, log_std)
            return a.T

        return policy
