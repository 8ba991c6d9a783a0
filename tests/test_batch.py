"""Batched execution: vmap-vs-single equivalence, rollout, determinism."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rsoccer_tpu
from rsoccer_tpu.batch import rollout as R
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.envs.base import draw_noise


def test_vmap_matches_single_env_given_same_noise():
    """The batched step is exactly B independent single-env steps: feeding
    env i the i-th noise slice must reproduce the batched results."""
    env = rsoccer_tpu.make("VSS-v0")
    B = 4
    benv = BatchedEnv(env, B)

    r_noise = draw_noise(jax.random.PRNGKey(0), env.reset_noise_spec(), batch=B)
    bstate, bobs = benv._reset_v(r_noise)
    actions = jax.random.uniform(
        jax.random.PRNGKey(1), (env.action_size, B), minval=-1, maxval=1
    )
    t_noise = draw_noise(jax.random.PRNGKey(2), env.transition_noise_spec(), batch=B)
    r2_noise = draw_noise(jax.random.PRNGKey(3), env.reset_noise_spec(), batch=B)
    bs2, bobs2, br, bterm, btrunc, binfo = benv._step_v(
        bstate, actions, t_noise, r2_noise
    )

    for i in range(B):
        take = lambda tree: jax.tree.map(lambda l: l[..., i], tree)
        s = env.reset_state(take(r_noise))
        o = env.observe(s)
        s2, o2, r, term, trunc, info = env.step_with_noise(
            s, actions[:, i], take(t_noise), take(r2_noise)
        )
        np.testing.assert_allclose(np.asarray(o), np.asarray(bobs[:, i]), atol=1e-6)
        np.testing.assert_allclose(np.asarray(o2), np.asarray(bobs2[:, i]), atol=1e-6)
        np.testing.assert_allclose(float(r), float(br[i]), atol=1e-6)
        assert bool(term) == bool(bterm[i])


def test_rollout_runs_and_is_deterministic():
    env = rsoccer_tpu.make("VSS-v0")
    B = 32
    benv = BatchedEnv(env, B)
    roll = jax.jit(R.make_rollout_fn(benv, 50, unroll=2))
    c1 = R.init_carry(benv, jax.random.PRNGKey(7))
    c2 = R.init_carry(benv, jax.random.PRNGKey(7))
    _, m1 = roll(c1)
    _, m2 = roll(c2)
    np.testing.assert_allclose(
        float(m1.total_reward), float(m2.total_reward), rtol=1e-6
    )
    assert int(m1.episodes) == int(m2.episodes)


def test_rollout_episode_accounting():
    env = rsoccer_tpu.make("VSS-v0")
    B = 8
    benv = BatchedEnv(env, B)
    # force truncation quickly by starting near the limit
    state, obs = benv.reset(jax.random.PRNGKey(0))
    state = state._replace(
        steps=jnp.full((B,), env.max_episode_steps - 3, jnp.int32)
    )
    carry = R.RolloutCarry(
        state, obs, jax.random.PRNGKey(1), jax.random.PRNGKey(9),
        jnp.zeros((B,)), jnp.zeros((B,)),
    )
    roll = jax.jit(R.make_rollout_fn(benv, 10, unroll=1))
    _, ms = roll(carry)
    # every env truncates at least once within 10 steps
    assert int(ms.episodes) >= B


def test_steps_counter_resets_per_env_independently():
    env = rsoccer_tpu.make("VSS-v0")
    B = 3
    benv = BatchedEnv(env, B)
    state, obs = benv.reset(jax.random.PRNGKey(0))
    # env 1 at the cliff, others not
    steps = jnp.asarray([0, env.max_episode_steps - 1, 5], jnp.int32)
    state = state._replace(steps=steps)
    acts = jnp.zeros((2, B))
    ns, *_ , trunc, info = benv.step(state, acts, jax.random.PRNGKey(1))
    assert list(np.asarray(trunc)) == [False, True, False]
    assert int(ns.steps[1]) == 0
    assert int(ns.steps[0]) == 1 and int(ns.steps[2]) == 6


def test_rbg_keys_flow_through():
    """Passing an rbg-impl key must work end to end."""
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 8)
    key = jax.random.key(0, impl="rbg")  # typed key carries the impl
    state, obs = benv.reset(key)
    assert bool(jnp.isfinite(obs).all())
    carry = R.init_carry(benv, key)
    roll = jax.jit(R.make_rollout_fn(benv, 5, unroll=1))
    carry, ms = roll(carry)
    assert np.isfinite(float(ms.total_reward))


@pytest.mark.parametrize("env_id", rsoccer_tpu.registered_ids())
def test_step_final_surfaces_the_pre_reset_obs(env_id):
    """``step_final``'s final_obs is ``obs`` on lanes that go on and the
    observation of the pre-reset state on lanes that end; its other outputs
    are those of ``step``."""
    env = rsoccer_tpu.make(env_id)
    B = 8
    benv = BatchedEnv(env, B)
    state, _ = benv.reset(jax.random.PRNGKey(0))
    # odd lanes one step from the time limit: they truncate and reset
    state = state._replace(steps=jnp.where(
        jnp.arange(B) % 2 == 1, env.max_episode_steps - 1, state.steps
    ).astype(state.steps.dtype))
    acts = jax.random.uniform(
        jax.random.PRNGKey(1), (env.action_size, B), minval=-1, maxval=1
    )
    key = jax.random.PRNGKey(2)
    _, obs, fobs, r, term, trunc, _ = jax.jit(benv.step_final)(state, acts, key)
    # the same transition without truncation or reset: step_final draws its
    # transition noise from the first half of the split key
    kt, _ = jax.random.split(key)
    _, pre_obs, *_ = jax.jit(benv.step_env)(state, acts, kt)
    done = np.asarray(term | trunc)
    assert done[1::2].all()
    np.testing.assert_allclose(
        np.asarray(fobs)[:, done], np.asarray(pre_obs)[:, done], atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(fobs)[:, ~done], np.asarray(obs)[:, ~done], atol=1e-6
    )
    _, obs_s, r_s, term_s, trunc_s, _ = jax.jit(benv.step)(state, acts, key)
    np.testing.assert_allclose(np.asarray(obs), np.asarray(obs_s), atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), np.asarray(r_s), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(term), np.asarray(term_s))
    np.testing.assert_array_equal(np.asarray(trunc), np.asarray(trunc_s))
