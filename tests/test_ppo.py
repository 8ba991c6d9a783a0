"""PPO trainer tests: shapes, jit, learning signal plumbing."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer


@pytest.fixture(scope="module")
def trainer():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = PPOConfig(rollout_steps=8, num_epochs=2, num_minibatches=2)
    return PPOTrainer(benv, cfg)


def test_init_shapes(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    assert state.obs.shape == (40, 16)
    assert state.env_key.shape == (2,)
    assert int(state.update_step) == 0


def test_train_step_runs_and_updates(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    new_state, metrics = step(state, jax.random.PRNGKey(1))
    assert int(new_state.update_step) == 1
    for k in ("loss", "policy_loss", "value_loss", "entropy", "mean_reward"):
        assert np.isfinite(float(metrics[k])), k
    # params changed
    p0 = jax.tree.leaves(state.params)[0]
    p1 = jax.tree.leaves(new_state.params)[0]
    assert not np.allclose(np.asarray(p0), np.asarray(p1))


def test_two_steps_chain(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    state, m1 = step(state, jax.random.PRNGKey(1))
    state, m2 = step(state, jax.random.PRNGKey(2))
    assert int(state.update_step) == 2
    assert np.isfinite(float(m2["loss"]))


def test_policy_rollout_integration(trainer):
    from rsoccer_tpu.batch import rollout as R

    state = trainer.init(jax.random.PRNGKey(0))
    policy = trainer.make_policy(state.params)
    roll = jax.jit(R.make_rollout_fn(trainer.benv, 10, policy=policy, unroll=1))
    carry = R.init_carry(trainer.benv, jax.random.PRNGKey(3))
    carry, ms = roll(carry)
    assert np.isfinite(float(ms.total_reward))


def test_gae_analytic():
    # single env, 3 steps, no dones: check GAE against hand computation
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 1)
    cfg = PPOConfig(gamma=0.9, gae_lambda=0.8)
    tr = PPOTrainer(benv, cfg)
    from rsoccer_tpu.models.ppo import Transition

    T, B = 3, 1
    rewards = jnp.asarray([[1.0], [0.5], [2.0]])
    values = jnp.asarray([[0.2], [0.3], [0.1]])
    traj = Transition(
        obs=jnp.zeros((T, B, 40)), action=jnp.zeros((T, B, 2)),
        logp=jnp.zeros((T, B)), value=values, reward=rewards,
        term=jnp.zeros((T, B)), trunc=jnp.zeros((T, B)),
        boot_value=jnp.zeros((T, B)),
    )
    last_value = jnp.asarray([0.4])
    adv, ret = tr._gae(traj, last_value)

    g, lam = 0.9, 0.8
    v = [0.2, 0.3, 0.1, 0.4]
    r = [1.0, 0.5, 2.0]
    deltas = [r[t] + g * v[t + 1] - v[t] for t in range(3)]
    a2 = deltas[2]
    a1 = deltas[1] + g * lam * a2
    a0 = deltas[0] + g * lam * a1
    np.testing.assert_allclose(
        np.asarray(adv)[:, 0], [a0, a1, a2], rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ret)[:, 0], np.asarray(adv)[:, 0] + [0.2, 0.3, 0.1],
        rtol=1e-5,
    )


def test_gae_truncation_bootstrap():
    """A truncated (not terminated) step bootstraps from V(final pre-reset
    obs), and GAE accumulation is cut at the boundary; a terminated step
    bootstraps from nothing."""
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 1)
    cfg = PPOConfig(gamma=0.9, gae_lambda=0.8)
    tr = PPOTrainer(benv, cfg)
    from rsoccer_tpu.models.ppo import Transition

    T, B = 4, 1
    rewards = jnp.asarray([[1.0], [0.5], [2.0], [-1.0]])
    values = jnp.asarray([[0.2], [0.3], [0.1], [0.6]])
    # step 1 truncated with V(final obs)=0.7; step 2 terminated
    trunc = jnp.asarray([[0.0], [1.0], [0.0], [0.0]])
    term = jnp.asarray([[0.0], [0.0], [1.0], [0.0]])
    boot = jnp.asarray([[0.0], [0.7], [0.0], [0.0]])
    traj = Transition(
        obs=jnp.zeros((T, B, 40)), action=jnp.zeros((T, B, 2)),
        logp=jnp.zeros((T, B)), value=values, reward=rewards,
        term=term, trunc=trunc, boot_value=boot,
    )
    last_value = jnp.asarray([0.4])
    adv, _ = tr._gae(traj, last_value)

    g, lam = 0.9, 0.8
    # backward, by hand:
    d3 = -1.0 + g * 0.4 - 0.6
    a3 = d3
    d2 = 2.0 + g * 0.0 - 0.1          # terminated: no bootstrap
    a2 = d2                            # cut
    d1 = 0.5 + g * 0.7 - 0.3           # truncated: bootstrap from boot=0.7
    a1 = d1                            # cut (no leak from a2)
    d0 = 1.0 + g * 0.3 - 0.2
    a0 = d0 + g * lam * a1
    np.testing.assert_allclose(
        np.asarray(adv)[:, 0], [a0, a1, a2, a3], rtol=1e-5
    )


def test_rollout_truncation_uses_final_obs_value():
    """The rollout stores a boot_value equal to V(normalised final obs) on
    every step (checked at a real TimeLimit truncation boundary)."""
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 4)
    cfg = PPOConfig(rollout_steps=6, normalize_obs=False)
    tr = PPOTrainer(benv, cfg)
    state = tr.init(jax.random.PRNGKey(0))
    # force lanes close to the step limit so the scan crosses a truncation
    env_state = state.env_state._replace(
        steps=jnp.full_like(state.env_state.steps, env.max_episode_steps - 3)
    )
    _, _, _, _, traj = tr._rollout(
        state.params, env_state, state.obs, state.env_key,
        state.obs_norm, jax.random.PRNGKey(1),
    )
    trunc = np.asarray(traj.trunc)
    assert trunc.sum() >= 4, "expected every lane to truncate in-rollout"
    # boot_value must NOT equal the value of the post-reset obs: recompute
    # V on the stored (pre-step) obs of the step AFTER the truncation; if
    # the rollout had bootstrapped from the spawn obs these would match.
    t_idx, b_idx = np.argwhere(trunc > 0.5)[0]
    assert t_idx + 1 < trunc.shape[0]
    _, _, v_spawn = tr.net.apply(
        state.params, jnp.asarray(traj.obs[t_idx + 1, b_idx])[None]
    )
    assert not np.allclose(
        float(traj.boot_value[t_idx, b_idx]), float(v_spawn[0]), atol=1e-6
    )


def test_obs_norm_statistics():
    from rsoccer_tpu.models.ppo import ObsNorm

    rng = np.random.default_rng(0)
    data = rng.normal(loc=3.0, scale=2.0, size=(1000, 5)).astype(np.float32)
    norm = ObsNorm.init(5)
    for i in range(10):
        norm = norm.update(jnp.asarray(data[i * 100 : (i + 1) * 100]))
    np.testing.assert_allclose(np.asarray(norm.mean), data.mean(0), rtol=0.02)
    np.testing.assert_allclose(
        np.sqrt(np.asarray(norm.var)), data.std(0), rtol=0.05
    )
    z = np.asarray(norm.normalize(jnp.asarray(data)))
    assert abs(z.mean()) < 0.05 and abs(z.std() - 1.0) < 0.05


def test_train_state_obs_norm_updates(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    s1, _ = step(state, jax.random.PRNGKey(1))
    # stats moved away from init
    assert float(jnp.abs(s1.obs_norm.mean).sum()) > 0
    assert float(s1.obs_norm.count) > 1


def test_critic_warmup_freezes_actor():
    """During warmup only critic params move; after it the actor moves too."""
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = PPOConfig(
        rollout_steps=8, num_epochs=1, num_minibatches=2,
        critic_warmup_updates=2,
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)

    def split(params):
        actor, critic = {}, {}
        for name, leaf in params["params"].items():
            (actor if name.startswith("actor") or name == "log_std"
             else critic)[name] = leaf
        return actor, critic

    a0, c0 = split(state.params)
    state, _ = step(state, jax.random.PRNGKey(1))
    a1, c1 = split(state.params)
    assert all(
        bool(jnp.all(x == y))
        for x, y in zip(jax.tree.leaves(a0), jax.tree.leaves(a1))
    ), "actor moved during critic warmup"
    assert any(
        bool(jnp.any(x != y))
        for x, y in zip(jax.tree.leaves(c0), jax.tree.leaves(c1))
    ), "critic did not move during warmup"

    state, _ = step(state, jax.random.PRNGKey(2))  # update 1 (< 2): frozen
    a2, _ = split(state.params)
    assert all(
        bool(jnp.all(x == y))
        for x, y in zip(jax.tree.leaves(a1), jax.tree.leaves(a2))
    )
    state, _ = step(state, jax.random.PRNGKey(3))  # update 2: unfrozen
    a3, _ = split(state.params)
    assert any(
        bool(jnp.any(x != y))
        for x, y in zip(jax.tree.leaves(a2), jax.tree.leaves(a3))
    ), "actor still frozen after warmup"


def test_freeze_obs_norm():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = PPOConfig(
        rollout_steps=8, num_epochs=1, num_minibatches=2,
        freeze_obs_norm=True,
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    state2, _ = jax.jit(trainer.train_step)(state, jax.random.PRNGKey(1))
    assert bool(jnp.all(state2.obs_norm.mean == state.obs_norm.mean))
    assert float(state2.obs_norm.count) == float(state.obs_norm.count)


def test_time_minibatch_mode_runs_and_updates():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = PPOConfig(
        rollout_steps=8, num_epochs=2, num_minibatches=2,
        minibatch_mode="time",
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    new_state, metrics = jax.jit(trainer.train_step)(
        state, jax.random.PRNGKey(1)
    )
    for k in ("loss", "policy_loss", "value_loss", "entropy", "mean_reward"):
        assert np.isfinite(float(metrics[k])), k
    p0 = jax.tree.leaves(state.params)[0]
    p1 = jax.tree.leaves(new_state.params)[0]
    assert not np.allclose(np.asarray(p0), np.asarray(p1))


def test_time_minibatch_mode_requires_divisibility():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = PPOConfig(
        rollout_steps=9, num_epochs=1, num_minibatches=2,
        minibatch_mode="time",
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(trainer.train_step)(state, jax.random.PRNGKey(1))
