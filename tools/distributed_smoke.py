"""Multi-process distributed rollout smoke — the multi-host launch recipe.

Runs the sharded rollout under ``jax.distributed.initialize`` with N
processes, each owning a slice of the device mesh, and prints one JSON line
of rollout metrics (process 0).  This is exactly the shape of a multi-host
GPU launch — one process per host, each seeing that host's GPUs, same
script on every host — exercised here with CPU devices so CI can run it
(SURVEY §4: multi-host tests "via jax.distributed simulated with
multi-process CPU devices").

Single-host multi-process simulation (what tests/test_distributed.py runs):

    # terminal/process i of N, each seeing 4 virtual CPU devices:
    env -u PYTHONPATH JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python tools/distributed_smoke.py \
        --coordinator localhost:<port> --num-processes N --process-id i

Real multi-host GPU launch: drop the env vars (each process sees its host's
GPUs), keep --coordinator pointing at host 0 (host:port), run one process
per host with --num-processes set to the host count and its --process-id;
see docs/distributed.md.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--impl", choices=["jit", "shard_map", "ppo", "sac"], default="jit",
        help="jit: NamedSharding-partitioned rollout; shard_map: explicit "
        "SPMD; ppo: two FULL sharded PPO train steps (rollout + GAE + "
        "minibatched updates, gradients averaged across the mesh); sac: "
        "FULL sharded SAC iterations (per-shard replay rings, pmean'd "
        "gradients, replicated params)",
    )
    args = p.parse_args()

    import jax

    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import rsoccer_tpu
    from rsoccer_tpu.batch import rollout as R
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.parallel.mesh import make_env_mesh
    from rsoccer_tpu.parallel.rollout import (
        make_shard_map_rollout,
        make_sharded_rollout,
        shard_carry,
    )

    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == args.num_processes * n_local, (n_global, n_local)

    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, args.envs)
    mesh = make_env_mesh()  # 1-D env mesh over ALL global devices

    key = jax.random.PRNGKey(args.seed)
    if args.impl == "sac":
        # the full off-policy learner across process boundaries: env batch
        # AND replay ring sharded over the global mesh (each device owns a
        # private ring fed by its local envs; n-step chains stay local),
        # params/targets replicated via pmean'd gradients inside shard_map
        from rsoccer_tpu.models.sac import SACConfig
        from rsoccer_tpu.parallel.sac import make_sharded_sac

        cfg = SACConfig(
            buffer_size=args.envs * 16, batch_size=64, warmup_steps=2,
            n_step=3,
        )
        _, init, sstep = make_sharded_sac(benv, cfg, mesh)
        state = init(key)
        step = jax.jit(sstep, donate_argnums=0)
        metrics = None
        for i in range(10):
            state, metrics = step(state, jax.random.PRNGKey(100 + i))
        jax.block_until_ready(metrics)
        # params are replicated -> identical checksum on every process
        psum = sum(
            float(abs(l).sum()) for l in jax.tree.leaves(state.actor_params)
        )
        out = {
            "impl": args.impl,
            "num_processes": args.num_processes,
            "global_devices": n_global,
            "q_loss": float(metrics["q_loss"]),
            "mean_reward": float(metrics["mean_reward"]),
            "alpha": float(metrics["alpha"]),
            "param_checksum": psum,
            "obs_sum": float(abs(state.obs).sum()),
            "filled_local": int(state.buffer.filled),
        }
        if args.process_id == 0:
            print(json.dumps(out))
        jax.distributed.shutdown()
        return

    if args.impl == "ppo":
        # the full learner across process boundaries: env batch sharded
        # over the global mesh (dp), params/opt replicated, the batch-mean
        # losses inducing the cross-host gradient collective inside jit
        from jax.sharding import NamedSharding, PartitionSpec as P

        from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer
        from rsoccer_tpu.parallel.mesh import shard_batched_tree

        cfg = PPOConfig(rollout_steps=8, num_epochs=2, num_minibatches=2)
        trainer = PPOTrainer(benv, cfg)
        state = trainer.init(key)
        replicated = NamedSharding(mesh, P())
        state = state._replace(
            params=jax.device_put(state.params, replicated),
            opt_state=jax.device_put(state.opt_state, replicated),
            env_state=shard_batched_tree(state.env_state, mesh, batch_axis=-1),
            obs=shard_batched_tree(state.obs, mesh, batch_axis=-1),
            env_key=jax.device_put(state.env_key, replicated),
        )
        step = jax.jit(trainer.train_step)
        metrics = None
        for i in range(2):
            state, metrics = step(state, jax.random.PRNGKey(100 + i))
        jax.block_until_ready(metrics)
        # params are replicated -> identical checksum on every process
        psum = sum(
            float(abs(l).sum()) for l in jax.tree.leaves(state.params)
        )
        out = {
            "impl": args.impl,
            "num_processes": args.num_processes,
            "global_devices": n_global,
            "loss": float(metrics["loss"]),
            "mean_reward": float(metrics["mean_reward"]),
            "param_checksum": psum,
            "obs_sum": float(abs(state.obs).sum()),
        }
        if args.process_id == 0:
            print(json.dumps(out))
        jax.distributed.shutdown()
        return

    if args.impl == "jit":
        roll, init = make_sharded_rollout(benv, mesh, args.steps, unroll=1)
        carry = init(key)
        carry, ms = roll(carry)
    else:
        roll = make_shard_map_rollout(benv, mesh, args.steps)
        carry = shard_carry(R.init_carry(benv, key), mesh)
        carry, ms = jax.jit(roll)(carry)

    # metrics are replicated scalars — addressable on every process
    out = {
        "impl": args.impl,
        "num_processes": args.num_processes,
        "global_devices": n_global,
        "total_reward": float(ms.total_reward),
        "episodes": int(ms.episodes),
        "episode_length_sum": float(ms.episode_length_sum),
        "obs_sum": float(abs(carry.obs).sum()),
    }
    if args.process_id == 0:
        print(json.dumps(out))
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
