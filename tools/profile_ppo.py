"""Profile one jitted PPO train step (rollout + GAE + minibatched updates).

Same trace reduction as tools/profile_step.py, pointed at the
learner: prints the top on-device ops so update-phase bottlenecks
(random-index gathers, optimizer elementwise chains, matmul shares) are
attributable.

    python tools/profile_ppo.py [--envs 4096] [--env-id SSLStaticDefenders-v0]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--minibatch-mode", default="shuffle")
    p.add_argument("--hidden", default="256,256")
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=4)
    p.add_argument("--rollout-unroll", type=int, default=1)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument(
        "--chain", type=int, default=1,
        help="profile a lax.scan of K train steps per launch (the training "
        "scripts' --chain path) instead of a single step",
    )
    p.add_argument("--out", default="traces/ppo")
    args = p.parse_args()

    from rsoccer_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer

    env = rsoccer_tpu.make(args.env_id)
    benv = BatchedEnv(env, args.envs)
    trainer = PPOTrainer(
        benv,
        PPOConfig(
            rollout_steps=args.rollout_steps,
            minibatch_mode=args.minibatch_mode,
            hidden=tuple(int(h) for h in args.hidden.split(",")),
            num_minibatches=args.num_minibatches,
            num_epochs=args.num_epochs,
            rollout_unroll=args.rollout_unroll,
        ),
    )
    state = trainer.init(jax.random.PRNGKey(0))
    if args.chain > 1:

        def chained(state, key):
            state, ms = jax.lax.scan(
                trainer.train_step, state, jax.random.split(key, args.chain)
            )
            return state, jax.tree.map(lambda m: m[-1], ms)

        step = jax.jit(chained, donate_argnums=0)
    else:
        step = jax.jit(trainer.train_step, donate_argnums=0)

    # sync the whole state tree, not just the scalar metrics
    state, ms = step(state, jax.random.PRNGKey(1))
    jax.block_until_ready(state)
    state, ms = step(state, jax.random.PRNGKey(2))
    jax.block_until_ready(state)

    t0 = time.perf_counter()
    for i in range(args.iters):
        state, ms = step(state, jax.random.PRNGKey(3 + i))
        jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / (args.iters * args.chain)
    steps_per = args.rollout_steps * args.envs
    print(
        f"{dt * 1e3:.1f} ms/update, {steps_per / dt / 1e6:.2f}M env-steps/s "
        f"({args.envs} envs x {args.rollout_steps} rollout steps, "
        f"chain {args.chain}, full-tree sync)"
    )

    from rsoccer_tpu.utils.profiling import device_activity, load_profile, trace

    with trace(args.out):
        state, ms = step(state, jax.random.PRNGKey(99))
        jax.block_until_ready(state)
    act = device_activity(load_profile(args.out), top=40)
    print(
        f"trace: {act['busy_ns'] / 1e6:.2f} ms device busy per launch, idle "
        f"share {act['idle_share']:.3f}, {act['n_kernels']} kernels"
    )
    for name, ns, count in act["top"]:
        print(f"{ns / 1e6:10.2f} ms  x{count:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
