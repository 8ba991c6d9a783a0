"""Sharded rollouts over a device mesh.

The batched rollout (``rsoccer_tpu.batch.rollout``) is already a pure
function of lane-layout pytrees; scaling it across chips is just sharding the
env batch axis over the mesh and letting XLA partition the program — the
physics/task step has no cross-env data flow, so the partitioned program has
zero collectives in the hot loop (metric sums reduce at the end).
"""

from __future__ import annotations

import jax

from rsoccer_tpu.batch.rollout import (
    RolloutCarry,
    RolloutMetrics,
    init_carry,
    make_rollout_fn,
)
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.parallel.mesh import Mesh, shard_batched_tree


def shard_carry(carry: RolloutCarry, mesh: Mesh) -> RolloutCarry:
    """Place a rollout carry on the mesh: batched leaves batch-last, the
    two scalar RNG keys replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    replicated = NamedSharding(mesh, P())
    return RolloutCarry(
        state=shard_batched_tree(carry.state, mesh, batch_axis=-1),
        obs=shard_batched_tree(carry.obs, mesh, batch_axis=-1),
        key=jax.device_put(carry.key, replicated),
        pol_key=jax.device_put(carry.pol_key, replicated),
        ep_return=shard_batched_tree(carry.ep_return, mesh, batch_axis=-1),
        ep_length=shard_batched_tree(carry.ep_length, mesh, batch_axis=-1),
    )


def make_shard_map_rollout(
    benv: BatchedEnv,
    mesh: Mesh,
    n_steps: int,
    policy=None,
    unroll: int = 1,
):
    """Explicit-SPMD rollout via ``shard_map``: each device steps its local
    env shard with zero cross-chip communication; metrics ``psum`` at the
    end.  The env key is folded with the device index so shards draw
    independent noise (numerically different from the jit-partitioned
    rollout, same distribution).

    Prefer :func:`make_sharded_rollout` (jit + NamedSharding) by default;
    this variant guarantees no accidental resharding and is the template
    for multi-host topologies where explicit control matters.
    """
    from functools import partial

    from jax.sharding import PartitionSpec as P

    shard_map = jax.shard_map

    from rsoccer_tpu.parallel.mesh import ENV_AXIS

    n_dev = mesh.devices.size
    if benv.n_envs % n_dev:
        raise ValueError(
            f"n_envs={benv.n_envs} not divisible by mesh size {n_dev}"
        )
    # inside shard_map each device sees only its local slice of the batch
    local_benv = BatchedEnv(benv.env, benv.n_envs // n_dev)
    rollout = make_rollout_fn(local_benv, n_steps, policy=policy, unroll=unroll)

    def batch_spec(tree):
        return jax.tree.map(lambda l: P(*([None] * (l.ndim - 1) + [ENV_AXIS])), tree)

    def make(carry: RolloutCarry):
        in_spec = RolloutCarry(
            state=batch_spec(carry.state),
            obs=P(None, ENV_AXIS),
            key=P(),
            pol_key=P(),
            ep_return=P(ENV_AXIS),
            ep_length=P(ENV_AXIS),
        )
        metrics_spec = jax.tree.map(lambda _: P(), RolloutMetrics(0, 0, 0, 0))

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(in_spec,),
            out_specs=(in_spec, metrics_spec),
            check_vma=False,
        )
        def sharded(carry):
            idx = jax.lax.axis_index(ENV_AXIS)
            carry = carry._replace(
                key=jax.random.fold_in(carry.key, idx),
                pol_key=jax.random.fold_in(carry.pol_key, idx),
            )
            carry, ms = rollout(carry)
            ms = jax.tree.map(lambda x: jax.lax.psum(x, ENV_AXIS), ms)
            # restore a replicated key stream for the next call
            carry = carry._replace(
                key=_first_shard(carry.key), pol_key=_first_shard(carry.pol_key)
            )
            return carry, ms

        return sharded

    def rollout_sm(carry: RolloutCarry):
        return make(carry)(carry)

    return rollout_sm


def _first_shard(key):
    """Device 0's key, replicated over the mesh axis.  Gathered as raw key
    data: ``all_gather`` does not take typed (``jax.random.key``) keys."""
    from rsoccer_tpu.parallel.mesh import ENV_AXIS

    data = jax.lax.all_gather(jax.random.key_data(key), ENV_AXIS)[0]
    if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
        return jax.random.wrap_key_data(data, impl=jax.random.key_impl(key))
    return data


def make_sharded_rollout(
    benv: BatchedEnv,
    mesh: Mesh,
    n_steps: int,
    policy=None,
    unroll: int = 4,
):
    """Build (jitted, donated) rollout + an init helper, both mesh-sharded.

    ``benv.n_envs`` must be divisible by the mesh size.
    """
    n_dev = mesh.devices.size
    if benv.n_envs % n_dev:
        raise ValueError(
            f"n_envs={benv.n_envs} not divisible by mesh size {n_dev}"
        )
    rollout = make_rollout_fn(benv, n_steps, policy=policy, unroll=unroll)
    rollout_jit = jax.jit(rollout, donate_argnums=0)

    def init(key) -> RolloutCarry:
        return shard_carry(init_carry(benv, key), mesh)

    return rollout_jit, init
