"""SAC trainer tests: buffer mechanics, updates, end-to-end step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.sac import Buffer, SACConfig, SACTrainer


def test_buffer_circular_and_sample():
    buf = Buffer.init(8, 3, 2)
    obs = jnp.arange(12.0).reshape(4, 3)
    act = jnp.ones((4, 2))
    z = jnp.zeros(4)
    buf = buf.add_batch(obs, act, jnp.ones(4), obs + 1, z, z)
    assert int(buf.ptr) == 4 and int(buf.filled) == 4
    buf = buf.add_batch(obs, act, jnp.ones(4), obs + 1, z, z)
    buf = buf.add_batch(obs + 100, act, jnp.ones(4), obs, z, z)
    assert int(buf.ptr) == 4 and int(buf.filled) == 8  # wrapped
    # slots 0..3 hold the newest (+100) batch
    np.testing.assert_allclose(np.asarray(buf.obs[0]), np.asarray(obs[0] + 100))
    o, a, r, no, d = buf.sample(jax.random.PRNGKey(0), 16)
    assert o.shape == (16, 3) and a.shape == (16, 2)


def _chain_buffer(rewards, boundaries, dones, stride):
    """Buffer holding one env's trajectory laid out with the given stride
    (other env columns hold sentinel junk that a correct chain never reads)."""
    t = len(rewards)
    c = t * stride
    buf = Buffer.init(c, 1, 1)
    for k in range(t):
        r = jnp.full((stride,), 999.0).at[0].set(rewards[k])
        b = jnp.full((stride,), 1.0).at[0].set(boundaries[k])
        d = jnp.full((stride,), 1.0).at[0].set(dones[k])
        o = jnp.full((stride, 1), -1.0).at[0, 0].set(float(k))
        no = jnp.full((stride, 1), -1.0).at[0, 0].set(float(k + 1))
        buf = buf.add_batch(o, jnp.zeros((stride, 1)), r, no, d, b)
    return buf


def test_nstep_sampling_chains_and_boundaries():
    # env-0 trajectory: r=[1,2,4,8], episode boundary (terminal) at step 2
    gamma = 0.5
    buf = _chain_buffer(
        rewards=[1.0, 2.0, 4.0, 8.0],
        boundaries=[0.0, 0.0, 1.0, 0.0],
        dones=[0.0, 0.0, 1.0, 0.0],
        stride=4,
    )
    # sample many; every draw starts at some step 0..1 of env 0 (steps with
    # a full 3-link chain) or an env>0 slot (boundary=1 -> 1-step chain)
    o, a, g, boot, disc = buf.sample_nstep(
        jax.random.PRNGKey(0), 256, stride=4, n_step=3, gamma=gamma
    )
    o = np.asarray(o)[:, 0]
    g = np.asarray(g)
    boot = np.asarray(boot)[:, 0]
    disc = np.asarray(disc)
    for i in range(256):
        if o[i] == 0.0:  # chain 1,2,4 hits terminal at k=2
            assert g[i] == 1.0 + gamma * 2.0 + gamma**2 * 4.0
            assert disc[i] == 0.0  # done at chain end: no bootstrap
            assert boot[i] == 3.0  # next_obs of step 2
        elif o[i] == 1.0:  # chain 2,4 -> terminal at k=1
            assert g[i] == 2.0 + gamma * 4.0
            assert disc[i] == 0.0
            assert boot[i] == 3.0
        else:  # sentinel env columns: boundary=1 everywhere -> 1-step
            assert g[i] == 999.0
            assert disc[i] == 0.0


def test_nstep_one_matches_classic_sample_semantics():
    # n_step=1 must produce (r, next_obs, gamma*(1-done)) per transition
    gamma = 0.9
    buf = _chain_buffer(
        rewards=[3.0, 5.0],
        boundaries=[0.0, 1.0],
        dones=[0.0, 1.0],
        stride=2,
    )
    o, a, g, boot, disc = buf.sample_nstep(
        jax.random.PRNGKey(1), 128, stride=2, n_step=1, gamma=gamma
    )
    o = np.asarray(o)[:, 0]
    g = np.asarray(g)
    boot = np.asarray(boot)[:, 0]
    disc = np.asarray(disc)
    for i in range(128):
        if o[i] == 0.0:
            assert g[i] == 3.0 and boot[i] == 1.0
            assert np.isclose(disc[i], gamma)  # not done: bootstrap
        elif o[i] == 1.0:
            assert g[i] == 5.0 and boot[i] == 2.0 and disc[i] == 0.0


@pytest.fixture(scope="module")
def trainer():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = SACConfig(buffer_size=1 << 10, batch_size=64, warmup_steps=2)
    return SACTrainer(benv, cfg)


def test_train_step_runs_and_updates(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    s1, m1 = step(state, jax.random.PRNGKey(1))
    assert int(s1.total_steps) == 1
    for k_ in ("q_loss", "actor_loss", "alpha", "mean_reward"):
        assert np.isfinite(float(m1[k_])), k_
    # params changed
    p0 = jax.tree.leaves(state.actor_params)[0]
    p1 = jax.tree.leaves(s1.actor_params)[0]
    assert not np.allclose(np.asarray(p0), np.asarray(p1))
    # targets moved toward the new critics (polyak)
    t0 = jax.tree.leaves(state.qs_target)[0]
    t1 = jax.tree.leaves(s1.qs_target)[0]
    assert not np.allclose(np.asarray(t0), np.asarray(t1))


def test_chained_steps_fill_buffer(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step)
    for i in range(5):
        state, m = step(state, jax.random.PRNGKey(10 + i))
    assert int(state.buffer.filled) == 5 * 16
    assert np.isfinite(float(m["q_loss"]))


def test_policy_deterministic_in_bounds(trainer):
    state = trainer.init(jax.random.PRNGKey(0))
    policy = trainer.make_policy(state.actor_params)
    obs = jnp.zeros((trainer.benv.obs_size, 16))
    acts = policy(jax.random.PRNGKey(0), obs)
    assert acts.shape == (2, 16)
    assert float(jnp.abs(acts).max()) <= 1.0


def test_actor_freeze_holds_actor_while_critics_learn():
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 16)
    cfg = SACConfig(
        buffer_size=1 << 10, batch_size=64, warmup_steps=2,
        actor_freeze_iters=3,
    )
    trainer = SACTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    a0 = jax.tree.map(np.asarray, state.actor_params)
    q0 = jax.tree.map(np.asarray, state.qs_params)
    step = jax.jit(trainer.train_step)
    for i in range(3):
        state, _ = step(state, jax.random.PRNGKey(5 + i))
    # within the freeze window: actor/alpha untouched, critics moved
    for a, b in zip(jax.tree.leaves(a0), jax.tree.leaves(state.actor_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert any(
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(q0), jax.tree.leaves(state.qs_params))
    )
    state, _ = step(state, jax.random.PRNGKey(9))
    assert any(
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(a0), jax.tree.leaves(state.actor_params))
    )


def test_nstep_vectorized_matches_loop_reference():
    """Property test: the vectorized chain walk must agree with a plain
    Python reference implementation on random ring contents, across
    fill levels (partial, full, wrapped) and n_step values."""
    rng = np.random.default_rng(7)
    stride, n_cap = 4, 8  # capacity = 32
    c = stride * n_cap
    for n_step in (1, 3, 5):
        for n_inserts in (3, n_cap, n_cap + 5):  # partial / full / wrapped
            buf = Buffer.init(c, 2, 1)
            for t in range(n_inserts):
                o = jnp.asarray(rng.normal(size=(stride, 2)), jnp.float32)
                no = o + 1000.0
                r = jnp.asarray(rng.normal(size=(stride,)), jnp.float32)
                d = jnp.asarray(rng.random(stride) < 0.2, jnp.float32)
                b = jnp.maximum(
                    d, jnp.asarray(rng.random(stride) < 0.1, jnp.float32)
                )
                buf = buf.add_batch(o, jnp.zeros((stride, 1)), r, no, d, b)
            gamma = 0.9
            key = jax.random.PRNGKey(n_step * 100 + n_inserts)
            o, a, g, boot, disc = buf.sample_nstep(
                key, 64, stride=stride, n_step=n_step, gamma=gamma
            )
            # reference walk, straight from the docstring contract
            filled = int(buf.filled)
            start = (int(buf.ptr) - filled) % c
            span = (n_step - 1) * stride
            off = np.asarray(
                jax.random.randint(key, (64,), 0, max(filled - span, 1))
            )
            R = np.asarray(buf.reward)
            D = np.asarray(buf.done)
            Bd = np.asarray(buf.boundary)
            NO = np.asarray(buf.next_obs)
            O = np.asarray(buf.obs)
            for i in range(64):
                base = (start + off[i]) % c
                gg, alive = 0.0, 1.0
                eb, ed = None, None
                for k in range(n_step):
                    pos = (base + k * stride) % c
                    if alive:
                        gg += (gamma ** k) * R[pos]
                    unwritten = (
                        k < n_step - 1
                        and (off[i] + (k + 1) * stride) >= filled
                    )
                    is_last = alive and (
                        Bd[pos] > 0 or k == n_step - 1 or unwritten
                    )
                    if is_last and eb is None:
                        eb = NO[pos]
                        ed = (gamma ** (k + 1)) * (1.0 - D[pos])
                    if Bd[pos] > 0 or unwritten:
                        alive = 0.0
                np.testing.assert_allclose(np.asarray(g)[i], gg, rtol=2e-5)
                np.testing.assert_allclose(np.asarray(boot)[i], eb, rtol=1e-6)
                np.testing.assert_allclose(np.asarray(disc)[i], ed, rtol=2e-6)
                np.testing.assert_allclose(np.asarray(o)[i], O[base], rtol=1e-6)
