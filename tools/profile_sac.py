"""Profile one jitted SAC iteration (collect + replay + gradient steps).

Same trace reduction as tools/profile_ppo.py, pointed at the
off-policy learner: prints per-op device time so the iteration's cost can
be attributed (replay gathers/scatters, the 3-network update matmuls,
optimizer chains, polyak averaging).

    python tools/profile_sac.py [--envs 512] [--chain 200] \
        [--env-id SSLStaticDefenders-v0] [--n-step 8] [--bf16]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--grad-steps", type=int, default=2)
    p.add_argument("--env-steps-per-iter", type=int, default=1)
    p.add_argument("--n-step", type=int, default=8)
    p.add_argument("--gamma", type=float, default=0.995)
    p.add_argument("--reward-scale", type=float, default=10.0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--iters", type=int, default=5)
    p.add_argument(
        "--chain", type=int, default=200,
        help="profile a lax.scan of K iterations per launch (the training "
        "script's --chain path)",
    )
    p.add_argument("--out", default="traces/sac")
    args = p.parse_args()

    from rsoccer_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.models.sac import SACConfig, SACTrainer

    env = rsoccer_tpu.make(args.env_id)
    benv = BatchedEnv(env, args.envs)
    trainer = SACTrainer(
        benv,
        SACConfig(
            batch_size=args.batch_size, warmup_steps=50,
            grad_steps_per_iter=args.grad_steps,
            env_steps_per_iter=args.env_steps_per_iter,
            reward_scale=args.reward_scale,
            n_step=args.n_step, gamma=args.gamma,
            compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
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
    steps_per = args.envs * args.env_steps_per_iter
    print(
        f"{dt * 1e6:.0f} us/iter, {steps_per / dt / 1e6:.2f}M env-steps/s "
        f"({args.envs} envs x {args.env_steps_per_iter} step(s), "
        f"{args.grad_steps} grad steps @ batch {args.batch_size}, "
        f"n_step {args.n_step}, chain {args.chain}, full-tree sync)"
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
