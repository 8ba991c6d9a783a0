"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

import rsoccer_tpu
from rsoccer_tpu.batch import rollout as R
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.parallel import mesh as M
from rsoccer_tpu.parallel.rollout import make_sharded_rollout, shard_carry


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    return jax.devices()[:8]


def test_mesh_creation(eight_devices):
    mesh = M.make_env_mesh(8)
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("env",)


def test_sharded_rollout_matches_single_device(eight_devices):
    env = rsoccer_tpu.make("VSS-v0")
    B = 64
    benv = BatchedEnv(env, B)

    # single device
    roll1 = jax.jit(R.make_rollout_fn(benv, 20, unroll=1))
    c1 = R.init_carry(benv, jax.random.PRNGKey(0))
    _, m1 = roll1(c1)

    # 8-device mesh
    mesh = M.make_env_mesh(8)
    roll8, init8 = make_sharded_rollout(benv, mesh, 20, unroll=1)
    c8 = init8(jax.random.PRNGKey(0))
    _, m8 = roll8(c8)

    np.testing.assert_allclose(
        float(m1.total_reward), float(m8.total_reward), rtol=1e-4
    )
    assert int(m1.episodes) == int(m8.episodes)


def test_state_actually_sharded(eight_devices):
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 64)
    mesh = M.make_env_mesh(8)
    carry = shard_carry(R.init_carry(benv, jax.random.PRNGKey(1)), mesh)
    obs = carry.obs  # (40, 64)
    assert len(obs.sharding.device_set) == 8
    # each shard holds 64/8 = 8 envs of the lane axis
    shard = obs.addressable_shards[0]
    assert shard.data.shape == (40, 8)


def test_indivisible_batch_rejected(eight_devices):
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 63)
    mesh = M.make_env_mesh(8)
    with pytest.raises(ValueError):
        make_sharded_rollout(benv, mesh, 5)


def test_shard_map_rollout(eight_devices):
    import jax.numpy as jnp

    from rsoccer_tpu.parallel.rollout import make_shard_map_rollout

    env = rsoccer_tpu.make("VSS-v0")
    B = 64
    benv = BatchedEnv(env, B)
    mesh = M.make_env_mesh(8)
    roll = make_shard_map_rollout(benv, mesh, n_steps=10)
    carry = shard_carry(R.init_carry(benv, jax.random.PRNGKey(0)), mesh)
    with mesh:
        carry2, ms = jax.jit(roll)(carry)
    assert np.isfinite(float(ms.total_reward))
    # state stayed sharded over 8 devices
    assert len(carry2.obs.sharding.device_set) == 8
    # shards drew independent noise: env positions differ across shards
    xs = np.asarray(carry2.state.world.ball.x)
    assert np.std(xs[:8]) > 0 and np.std(xs) > 0
    # deterministic
    carry_b = shard_carry(R.init_carry(benv, jax.random.PRNGKey(0)), mesh)
    with mesh:
        _, ms_b = jax.jit(roll)(carry_b)
    np.testing.assert_allclose(
        float(ms.total_reward), float(ms_b.total_reward), rtol=1e-6
    )


def test_sharded_sac_step(eight_devices):
    """Full SAC iteration over the mesh: per-shard replay rings, pmean'd
    gradients.  Params must stay bit-identical across devices, the local
    ring bookkeeping must advance, and the program must actually learn
    (params move, losses finite)."""
    import jax.numpy as jnp

    from rsoccer_tpu.models.sac import SACConfig
    from rsoccer_tpu.parallel.sac import make_sharded_sac

    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, 32)
    cfg = SACConfig(buffer_size=1024, batch_size=64, warmup_steps=2)
    mesh = M.make_env_mesh(8)
    local, init, step = make_sharded_sac(benv, cfg, mesh)
    assert local.benv.n_envs == 4
    assert local.cfg.buffer_size == 128 and local.cfg.batch_size == 8

    state = init(jax.random.PRNGKey(0))
    p0 = jax.tree.map(np.asarray, state.actor_params)
    jstep = jax.jit(step, donate_argnums=0)
    for i in range(6):
        state, m = jstep(state, jax.random.fold_in(jax.random.PRNGKey(1), i))
    jax.block_until_ready(m)

    assert all(np.isfinite(float(v)) for v in m.values())
    # per-shard bookkeeping: 6 iters x 4 local envs
    assert int(state.buffer.filled) == 24 and int(state.total_steps) == 6
    # replay ring is actually sharded on the capacity axis
    assert len(state.buffer.obs.sharding.device_set) == 8
    assert state.buffer.obs.addressable_shards[0].data.shape[0] == 128
    # params replicated bit-identically across all 8 devices
    for leaf in jax.tree.leaves(state.actor_params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        for s in shards[1:]:
            np.testing.assert_array_equal(shards[0], s)
    # ... and they moved (the update applied)
    moved = any(
        not np.array_equal(a, np.asarray(b))
        for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(state.actor_params))
    )
    assert moved


def test_sharded_sac_indivisible_rejected(eight_devices):
    from rsoccer_tpu.models.sac import SACConfig
    from rsoccer_tpu.parallel.sac import make_sharded_sac

    env = rsoccer_tpu.make("VSS-v0")
    mesh = M.make_env_mesh(8)
    with pytest.raises(ValueError):
        make_sharded_sac(BatchedEnv(env, 30), SACConfig(), mesh)
    with pytest.raises(ValueError):
        make_sharded_sac(
            BatchedEnv(env, 32), SACConfig(batch_size=60), mesh
        )


@pytest.mark.parametrize("impl", ["threefry2x32", "rbg"])
def test_shard_map_rollout_takes_typed_keys(eight_devices, impl):
    """``jax.random.key`` keys (the kind bench.py passes) survive the
    shard_map rollout's key re-replication, impl and all."""
    from rsoccer_tpu.parallel.rollout import make_shard_map_rollout

    benv = BatchedEnv(rsoccer_tpu.make("VSS-v0"), 16)
    mesh = M.make_env_mesh(8)
    roll = jax.jit(make_shard_map_rollout(benv, mesh, n_steps=3))
    carry = shard_carry(R.init_carry(benv, jax.random.key(0, impl=impl)), mesh)
    carry, ms = roll(carry)
    carry, ms = roll(carry)  # the returned carry feeds the next call
    assert np.isfinite(float(ms.total_reward))
    assert str(jax.random.key_impl(carry.key)) == str(jax.random.key_impl(
        jax.random.key(0, impl=impl)
    ))
