"""Train a SAC agent on any registered env, fully on-device.

    python examples/train_sac_vss.py [--envs 256] [--iters 2000]
    python examples/train_sac_vss.py --env-id SSLContestedPossession-v0 \
        --reward-scale 10 --iters 20000 --log /tmp/sac_cp.jsonl

With ``--log`` every logged iteration appends one JSON line
{iter, env_steps, wall_s, mean_reward, q_loss, alpha} and every
``--eval-every`` iterations a deterministic-policy evaluation line
{iter, env_steps, wall_s, eval: {episodes, success_rate, ...}} —
the convergence curve artifact (plot env_steps vs success_rate).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from rsoccer_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.eval import make_eval_fn, success_criterion
from rsoccer_tpu.models.sac import SACConfig, SACTrainer
from rsoccer_tpu.utils import checkpoint


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--save", default="")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--target-entropy-scale", type=float, default=1.0)
    p.add_argument("--n-step", type=int, default=1,
                   help="n-step Q targets (sparse-terminal-reward fix)")
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 actor/critic matmuls (f32 params+heads); "
                   "measured learning parity on SD")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--grad-steps", type=int, default=2,
                   help="gradient steps per iteration (UTD knob)")
    p.add_argument("--env-steps-per-iter", type=int, default=1,
                   help="batched env steps collected per iteration; raising "
                   "it lowers the update:data ratio (throughput knob)")
    p.add_argument("--buffer-size", type=int, default=1 << 18,
                   help="replay capacity; scale with --envs to keep the "
                   "ring's history length (capacity/envs iterations) "
                   "constant — too-short history destabilises Q learning")
    p.add_argument("--init-alpha", type=float, default=0.1,
                   help="initial SAC temperature (exploration)")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=50,
                   help="iterations of uniform-random actions before "
                   "policy collection (replay seeding)")
    p.add_argument("--env-kwargs", default="{}",
                   help="JSON kwargs for the TRAINING env (e.g. curriculum);"
                   " evaluation always runs the default reference-exact env")
    p.add_argument("--init", default="",
                   help="warm-start the ACTOR from an {actor_params} "
                   "checkpoint (tools/bc_warmstart.py --target sac); "
                   "critics/temperature start fresh — pair with "
                   "--actor-freeze so they catch up first")
    p.add_argument("--actor-freeze", type=int, default=0,
                   help="freeze actor+temperature updates for the first N "
                   "iters (critics keep learning)")
    p.add_argument("--state-save", default="",
                   help="save the FULL SACState (replay buffer included) at"
                   " every eval point; crash insurance for long runs")
    p.add_argument("--resume", action="store_true",
                   help="continue from --state-save if its meta file exists")
    p.add_argument("--seed", type=int, default=0,
                   help="base seed: init key = PRNGKey(seed), per-iter keys "
                   "fold_in from PRNGKey(seed+1)")
    p.add_argument("--chain", type=int, default=1,
                   help="fuse K iterations into one jitted lax.scan launch "
                   "(per-iter device work is sub-ms, so per-launch "
                   "overhead can dominate an unchained run); the "
                   "fold_in-by-iter key stream is IDENTICAL to the "
                   "unchained one, so --resume composes")
    p.add_argument("--log", default="", help="append JSONL curve points here")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--eval-every", type=int, default=0,
                   help="deterministic eval every N iters (0 = off)")
    p.add_argument("--eval-envs", type=int, default=128)
    args = p.parse_args()

    env = rsoccer_tpu.make(args.env_id, **json.loads(args.env_kwargs))
    benv = BatchedEnv(env, args.envs)
    trainer = SACTrainer(
        benv,
        SACConfig(
            buffer_size=args.buffer_size,
            batch_size=args.batch_size, warmup_steps=args.warmup,
            grad_steps_per_iter=args.grad_steps,
            env_steps_per_iter=args.env_steps_per_iter,
            init_alpha=args.init_alpha,
            lr=args.lr,
            reward_scale=args.reward_scale,
            target_entropy_scale=args.target_entropy_scale,
            n_step=args.n_step, gamma=args.gamma,
            compute_dtype=jnp.bfloat16 if args.bf16 else jnp.float32,
            actor_freeze_iters=args.actor_freeze,
        ),
    )
    state = trainer.init(jax.random.PRNGKey(args.seed))
    if args.init:
        like = {"actor_params": state.actor_params}
        ck = jax.tree.map(jnp.asarray, checkpoint.restore(args.init, like=like))
        state = state._replace(actor_params=ck["actor_params"])
        print(f"warm-started actor from {args.init}")
    step = jax.jit(trainer.train_step, donate_argnums=0)
    if args.chain > 1:
        if args.iters % args.chain:
            p.error("--iters must be divisible by --chain")
        if args.eval_every % args.chain:
            p.error("--eval-every must be a multiple of --chain (or 0)")

    evaluate = None
    if args.eval_every:
        # default-constructed env: success is always reported on the
        # reference-exact task even when training uses curriculum kwargs
        eval_env = rsoccer_tpu.make(args.env_id)
        eval_benv = BatchedEnv(eval_env, args.eval_envs)
        # fresh-reset rollout long enough for every lane to finish >=1 episode
        eval_steps = eval_env.max_episode_steps + eval_env.max_episode_steps // 4

        # params enter as a jit argument so one compiled program serves
        # every evaluation point along the curve
        def _eval_fn(key, params):
            policy = trainer.make_policy(params, deterministic=True)
            fn = make_eval_fn(
                eval_benv, eval_steps, policy, success_criterion(args.env_id)
            )
            return fn(key)

        evaluate = jax.jit(_eval_fn)

    log_f = open(args.log, "a") if args.log else None

    def emit(rec):
        if log_f:
            log_f.write(json.dumps(rec) + "\n")
            log_f.flush()

    base_key = jax.random.PRNGKey(args.seed + 1)
    base_ekey = jax.random.PRNGKey(args.seed + 2)
    start = 0
    if args.resume and args.state_save:
        import os as _os

        if _os.path.exists(args.state_save + ".meta.json"):
            with open(args.state_save + ".meta.json") as f:
                start = json.load(f)["iter"] + 1
            state = jax.tree.map(
                jax.numpy.asarray, checkpoint.restore(args.state_save, like=state)
            )
            print(f"resumed full SAC state from {args.state_save} @ iter {start}")
    t0 = time.perf_counter()
    spi = args.envs * trainer.cfg.env_steps_per_iter

    if args.chain > 1:
        # one launch = --chain iterations; keys are fold_in(base_key, i)
        # exactly as in the unchained loop, so a --resume'd run (state
        # saves land on eval points, which are chain-aligned) consumes the
        # same key stream either way
        def chained(state, i0):
            def body(st, i):
                return trainer.train_step(st, jax.random.fold_in(base_key, i))

            state, ms = jax.lax.scan(
                body, state, i0 + jnp.arange(args.chain, dtype=jnp.int32)
            )
            return state, jax.tree.map(lambda m: m[-1], ms)

        chain_step = jax.jit(chained, donate_argnums=0)
        if start % args.chain:
            # saves land on eval boundaries (multiples of --chain); a
            # foreign meta file is misaligned — re-running the partial
            # block on the RESTORED (already-advanced) state would break
            # the identical-key-stream invariant and mislabel snapshots,
            # so refuse, mirroring the other divisibility checks
            p.error(
                f"resume iter {start} is not a multiple of --chain "
                f"{args.chain}; restore a chain-aligned state or rerun "
                "with --chain 1"
            )

    i = start
    while i < args.iters:
        if args.chain > 1:
            state, m = chain_step(state, jnp.asarray(i, jnp.int32))
            i += args.chain - 1  # logging below indexes the LAST iter run
        else:
            # fold_in by iter index: a resumed run consumes the same key
            # stream an uninterrupted one would (tools/elastic_train.py)
            k = jax.random.fold_in(base_key, i)
            state, m = step(state, k)
        last = i == args.iters - 1
        # under --chain the loop only ever visits i = k*chain - 1, so an
        # exact `i % every == 0` check essentially never fires; instead
        # emit whenever this launch's block [i-chain+1, i] CROSSED a
        # boundary (reduces to `(i+1) % every == 0` at --chain 1)
        block = max(args.chain, 1)

        def crossed(every):
            return (i + 1) // every > (i + 1 - block) // every

        if crossed(max(1, args.iters // 10)) or last:
            print(
                f"iter {i:5d}  reward/step {float(m['mean_reward']):+.4f}  "
                f"q_loss {float(m['q_loss']):.4f}  alpha {float(m['alpha']):.3f}"
            )
        if log_f and (crossed(args.log_every) or last):
            emit({
                "iter": i, "env_steps": (i + 1) * spi,
                "wall_s": round(time.perf_counter() - t0, 1),
                "mean_reward": float(m["mean_reward"]),
                "q_loss": float(m["q_loss"]),
                "alpha": float(m["alpha"]),
            })
        if evaluate is not None and ((i + 1) % args.eval_every == 0 or last):
            sub = jax.random.fold_in(base_ekey, i)
            ms = evaluate(sub, state.actor_params)
            rec = {
                "iter": i, "env_steps": (i + 1) * spi,
                "wall_s": round(time.perf_counter() - t0, 1),
                "eval": ms.summary(),
            }
            print(f"eval @ iter {i}: {rec['eval']}")
            emit(rec)
            if args.save:
                # a literal "{i}" writes indexed snapshots at eval points
                # (offline best-checkpoint selection)
                checkpoint.save(
                    args.save.replace("{i}", str(i + 1)), state.actor_params
                )
            if args.state_save:
                # full TrainState (replay buffer included): --resume
                # continues a cut run from here
                jax.block_until_ready(state.total_steps)
                checkpoint.save(args.state_save, state)
                with open(args.state_save + ".meta.json", "w") as f:
                    json.dump({"iter": i}, f)
        i += 1
    steps = args.iters * spi
    print(f"{steps/1e6:.2f}M env-steps in {time.perf_counter()-t0:.0f}s")

    if args.save:
        final = args.save.replace("{i}", str(args.iters))
        checkpoint.save(final, state.actor_params)
        print(f"saved actor params to {final}")
    if log_f:
        log_f.close()


if __name__ == "__main__":
    main()
