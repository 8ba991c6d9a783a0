"""Train a PPO agent on VSS-v0, fully on-device.

Usage:
    python examples/train_ppo_vss.py [--envs 2048] [--updates 50]

Each update is one jitted program: 128 env steps x n_envs transitions,
GAE, and 4 epochs of minibatched PPO — no host round-trips.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from rsoccer_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu.utils import checkpoint


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--save", default="")
    p.add_argument(
        "--rng-impl", default="threefry2x32",
        help="PRNG impl for env noise ('rbg' = XLA's RngBitGenerator)",
    )
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument(
        "--anneal", action="store_true",
        help="linearly decay lr to 0 over --updates",
    )
    p.add_argument(
        "--anneal-updates", type=int, default=0,
        help="pin the anneal schedule length independently of --updates "
        "(e.g. to reuse one compiled program across runs of different "
        "lengths, or to stop an annealed run early)",
    )
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument(
        "--minibatch-mode", default="shuffle", choices=["shuffle", "time"],
        help="'time' permutes only the time axis (contiguous minibatch "
        "reads, measurably faster updates; see models/ppo.PPOConfig)",
    )
    p.add_argument("--gae-lambda", type=float, default=0.95)
    p.add_argument(
        "--env-kwargs", default="{}",
        help='JSON kwargs for the env ctor, e.g. \'{"curriculum": true}\'',
    )
    p.add_argument(
        "--init", default="",
        help="warm-start from a {params, obs_norm} checkpoint (--save format)",
    )
    p.add_argument(
        "--save-every", type=int, default=0,
        help="also write --save every K updates (crash insurance on flaky links)",
    )
    p.add_argument(
        "--freeze-obs-norm", action="store_true",
        help="normalise with the --init checkpoint's stats without updating "
        "them (fine-tuning: fresh moments shift the policy's effective "
        "weights)",
    )
    p.add_argument(
        "--critic-warmup", type=int, default=0,
        help="freeze the actor for the first N updates (fine-tuning: let "
        "the fresh value head fit before its noise hits the policy)",
    )
    p.add_argument(
        "--hidden", default="256,256",
        help="comma-separated actor/critic tower widths",
    )
    p.add_argument(
        "--num-epochs", type=int, default=4,
        help="PPO epochs over each rollout; 2 halves the update-phase cost "
        "per env-step at a small sample-efficiency cost per update",
    )
    p.add_argument(
        "--num-minibatches", type=int, default=8,
        help="minibatches per epoch; fewer = larger matmuls per "
        "optimiser step at the same sample count",
    )
    p.add_argument(
        "--rollout-unroll", type=int, default=1,
        help="lax.scan unroll for the rollout loop",
    )
    p.add_argument(
        "--chain", type=int, default=1,
        help="fuse K train steps into one jitted lax.scan launch: the host "
        "and the per-launch overhead leave the loop entirely",
    )
    p.add_argument(
        "--log-every", type=int, default=1,
        help="sync + print metrics every K launches; between logs the host "
        "runs ahead of the device (async dispatch), so per-update prints "
        "never stall the chip",
    )
    args = p.parse_args()

    import json

    env = rsoccer_tpu.make(args.env_id, **json.loads(args.env_kwargs))
    benv = BatchedEnv(env, args.envs)
    cfg = PPOConfig(
        lr=args.lr,
        anneal_updates=(
            (args.anneal_updates or args.updates) if args.anneal else 0
        ),
        gamma=args.gamma,
        ent_coef=args.ent_coef,
        rollout_steps=args.rollout_steps,
        gae_lambda=args.gae_lambda,
        freeze_obs_norm=args.freeze_obs_norm,
        critic_warmup_updates=args.critic_warmup,
        minibatch_mode=args.minibatch_mode,
        hidden=tuple(int(h) for h in args.hidden.split(",")),
        num_minibatches=args.num_minibatches,
        num_epochs=args.num_epochs,
        rollout_unroll=args.rollout_unroll,
    )
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.key(0, impl=args.rng_impl))
    if args.init:
        like = {"params": state.params, "obs_norm": state.obs_norm}
        ck = jax.tree.map(jax.numpy.asarray, checkpoint.restore(args.init, like=like))
        state = state._replace(params=ck["params"], obs_norm=ck["obs_norm"])
        print(f"warm-started params+obs_norm from {args.init}")
    if args.chain > 1:
        # the loop below indexes LAUNCHES of --chain updates each, so both
        # the total and the save cadence must land on chain boundaries or
        # the run would execute extra updates / silently reinterpret
        # --save-every in launches (mirrors the SAC script's checks)
        if args.updates % args.chain:
            p.error("--updates must be divisible by --chain")
        if args.save_every % args.chain:
            p.error("--save-every must be a multiple of --chain (or 0)")
        # one launch = --chain full PPO iterations under lax.scan; metrics
        # of the last iteration in the chain are returned for logging
        def chained(state, key):
            state, ms = jax.lax.scan(
                trainer.train_step, state, jax.random.split(key, args.chain)
            )
            return state, jax.tree.map(lambda m: m[-1], ms)

        step = jax.jit(chained, donate_argnums=0)
    else:
        step = jax.jit(trainer.train_step, donate_argnums=0)

    steps_per_update = trainer.cfg.rollout_steps * args.envs
    launches = (args.updates + args.chain - 1) // args.chain
    key = jax.random.PRNGKey(1)
    t_sustained = None
    t_log = (time.perf_counter(), 0)
    for i in range(launches):
        key, k = jax.random.split(key)
        state, metrics = step(state, k)
        if i < 3:
            # the first launches compile/specialise: call 1 for the
            # init-state input layouts, call 2 for the layouts train_step
            # itself emits (both land in the persistent cache; warmed
            # re-runs skip straight to steady state), and call 3 drains
            # any queue effects of the background compile.  Block on each
            # so the sustained clock starts only once layouts are steady.
            jax.block_until_ready(metrics)
            t_sustained = (time.perf_counter(), i + 1)
            t_log = t_sustained
        if (i + 1) % args.log_every == 0 or i == launches - 1:
            jax.block_until_ready(metrics)
            now = time.perf_counter()
            n_launch = i + 1 - t_log[1]
            # during the i<3 warm-up t_log was just reset, so n_launch is
            # 0 and no rate is measurable yet — omit the field rather
            # than printing nan
            rate_s = (
                f"  env-steps/s "
                f"{steps_per_update * args.chain * n_launch / (now - t_log[0]):,.0f}"
                if n_launch
                else ""
            )
            t_log = (now, i + 1)
            print(
                f"update {i * args.chain:5d}  "
                f"reward/step {float(metrics['mean_reward']):+.4f}  "
                f"loss {float(metrics['loss']):+.4f}" + rate_s,
                flush=True,
            )
        if (
            args.save and args.save_every
            and ((i + 1) * args.chain) % args.save_every == 0
        ):
            # a literal "{i}" in --save writes indexed snapshots (select the
            # best one by offline eval instead of keeping only the last)
            checkpoint.save(
                args.save.replace("{i}", str((i + 1) * args.chain)),
                {"params": state.params, "obs_norm": state.obs_norm},
            )
    if t_sustained is not None and launches > t_sustained[1]:
        jax.block_until_ready(state.params)
        wall = time.perf_counter() - t_sustained[0]
        n = (launches - t_sustained[1]) * args.chain * steps_per_update
        print(
            f"sustained: {n / wall / 1e6:.2f}M env-steps/s over "
            f"{launches - t_sustained[1]} post-compile launches "
            f"({wall:.1f}s wall)",
            flush=True,
        )

    if args.save:
        # the obs normaliser is part of the policy: evaluating the params
        # without it feeds the network unnormalised observations
        final = args.save.replace("{i}", str(args.updates))
        checkpoint.save(
            final, {"params": state.params, "obs_norm": state.obs_norm}
        )
        print(f"saved params+obs_norm to {final}")


if __name__ == "__main__":
    main()
