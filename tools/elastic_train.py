"""Elastic training: crash-and-resume demonstration for the on-device learner.

The reference cannot recover from anything — env state lives inside a C++
simulator and a crash loses the episode (SURVEY §5).  Here the ENTIRE
training state (params, optimiser state, env state, obs normaliser, PRNG
position) is one pytree, so failure recovery is structural: checkpoint the
pytree every K updates, and on restart restore it and continue.  Per-update
keys are derived as ``fold_in(base_key, update_index)`` so the resumed run
consumes the identical randomness stream — a crashed-and-resumed run is
bit-identical to an uninterrupted one (asserted by
tests/test_elastic.py).

Usage (single host; multi-host runs the same flow per process after
``jax.distributed.initialize`` — see docs/distributed.md):

    python tools/elastic_train.py --updates 12 --ckpt /tmp/ck --every 4
    python tools/elastic_train.py --updates 12 --ckpt /tmp/ck --crash-at 6
    python tools/elastic_train.py --updates 12 --ckpt /tmp/ck --resume

Prints one JSON line: {"update", "digest", "mean_reward"}.
"""

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import rsoccer_tpu
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu.utils import checkpoint


def state_digest(state) -> str:
    """Order-stable hash over every leaf of the training state."""
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(state):
        h.update(np.ascontiguousarray(np.asarray(leaf)).tobytes())
    return h.hexdigest()[:16]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--envs", type=int, default=32)
    p.add_argument("--updates", type=int, default=12)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--every", type=int, default=4)
    p.add_argument(
        "--crash-at", type=int, default=0,
        help="simulate failure: exit(1) before this update runs",
    )
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--algo", default="ppo", choices=["ppo", "sac"],
        help="either learner: both TrainStates are pure pytrees and both "
        "train_steps are pure functions of (state, fold_in key), so the "
        "same snapshot/restore flow is bit-identical for both",
    )
    args = p.parse_args()

    env = rsoccer_tpu.make(args.env_id)
    benv = BatchedEnv(env, args.envs)
    if args.algo == "sac":
        from rsoccer_tpu.models.sac import SACConfig, SACTrainer

        trainer = SACTrainer(
            benv,
            SACConfig(
                buffer_size=1 << 10, batch_size=32, warmup_steps=2,
                n_step=3,
            ),
        )
    else:
        cfg = PPOConfig(rollout_steps=8, num_epochs=1, num_minibatches=2)
        trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(args.seed))

    start = 0
    if args.resume:
        meta_path = args.ckpt + ".meta.json"
        with open(meta_path) as f:
            start = json.load(f)["update"]
        state = checkpoint.restore(args.ckpt, like=state)
        state = jax.tree.map(jax.numpy.asarray, state)

    step = jax.jit(trainer.train_step, donate_argnums=0)
    base_key = jax.random.PRNGKey(args.seed + 1)
    metrics = None
    for i in range(start, args.updates):
        if args.crash_at and i == args.crash_at:
            print(f"simulated crash before update {i}", file=sys.stderr)
            sys.exit(1)
        state, metrics = step(state, jax.random.fold_in(base_key, i))
        done = i + 1
        if done % args.every == 0 or done == args.updates:
            jax.block_until_ready(metrics)
            checkpoint.save(args.ckpt, state)
            with open(args.ckpt + ".meta.json", "w") as f:
                json.dump({"update": done}, f)

    print(
        json.dumps(
            {
                "update": args.updates,
                "digest": state_digest(state),
                "mean_reward": float(metrics["mean_reward"]),
            }
        )
    )


if __name__ == "__main__":
    main()
