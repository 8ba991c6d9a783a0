"""Frozen-past self-play on VSSSelfPlay-v0 (3v3, both teams policy-driven).

The learner drives the blue team; the yellow team is driven by a frozen
snapshot of the learner from SWAP_EVERY updates ago, playing through the
mirrored view (one network plays both sides — see envs/vss_selfplay.py).
At every swap the current policy is evaluated against the frozen opponent
and the blue-vs-frozen-past goal rate is printed: the curve that shows the
learner beating its own past.

    python examples/selfplay_vss.py --envs 2048 --updates 120 --swap-every 20
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from rsoccer_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()
import jax.numpy as jnp

import rsoccer_tpu
from rsoccer_tpu import eval as E
from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.networks import ActorCritic
from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer
from rsoccer_tpu.models.selfplay import SelfPlayBatchedEnv


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=2048)
    p.add_argument("--updates", type=int, default=120)
    p.add_argument("--swap-every", type=int, default=20)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--eval-steps", type=int, default=1200)
    p.add_argument("--eval-envs", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", default="")
    p.add_argument(
        "--minibatch-mode", default="shuffle", choices=["shuffle", "time"],
        help="'time' = ~3x faster updates at measured parity (docs/training.md)",
    )
    p.add_argument(
        "--ou-frac", type=float, default=0.0,
        help="fraction of env lanes whose yellow team is driven by the "
        "reference OU process instead of the frozen policy — keeps "
        "training anchored on the distribution tools/vss_anchor_eval.py "
        "measures (fixes the round-4 self-play drift)",
    )
    p.add_argument(
        "--anchor-gate", action="store_true",
        help="evaluate on the VSSMultiAgent-v0 OU anchor at every swap; "
        "promote the snapshot to opponent ONLY if its anchor goal-rate "
        "did not regress (--anchor-margin), and --save writes the "
        "best-anchor params instead of the last",
    )
    p.add_argument("--anchor-envs", type=int, default=512)
    p.add_argument("--anchor-steps", type=int, default=1500)
    p.add_argument(
        "--anchor-margin", type=float, default=0.02,
        help="tolerated anchor regression when promoting an opponent",
    )
    args = p.parse_args()

    env = rsoccer_tpu.make("VSSSelfPlay-v0")
    net = ActorCritic(action_size=env.action_size // 2)
    init_params = net.init(
        jax.random.PRNGKey(args.seed), jnp.zeros((1, env.obs_size))
    )
    sp_env = SelfPlayBatchedEnv(
        env, args.envs, net, init_params,
        ou_lanes=int(round(args.ou_frac * args.envs)),
    )
    trainer = PPOTrainer(
        sp_env,
        PPOConfig(
            rollout_steps=args.rollout_steps,
            minibatch_mode=args.minibatch_mode,
        ),
    )
    state = trainer.init(jax.random.PRNGKey(args.seed))
    train = jax.jit(trainer.train_step, donate_argnums=0)

    eval_env = SelfPlayBatchedEnv(env, args.eval_envs, net, init_params)
    success = E.success_criterion("VSSSelfPlay-v0")

    # ONE jitted evaluator taking params/payload as arguments — rebuilding
    # make_eval_fn per swap would recompile the whole eval scan each time
    @jax.jit
    def run_eval(params, obs_norm, payload, key):
        """Deterministic learner vs the given frozen opponent payload."""
        policy = trainer.make_policy(params, obs_norm=obs_norm)
        swap = lambda c: c._replace(state=(c.state[0], payload))
        ev = E.make_eval_fn(
            eval_env, args.eval_steps, policy, success, carry_init=swap
        )
        return ev(key)

    run_anchor = None
    if args.anchor_gate:
        # absolute anchor: 3 policy blues vs the reference's OU-driven
        # yellows (the distribution tools/vss_anchor_eval.py measures)
        anchor_env = rsoccer_tpu.make("VSSMultiAgent-v0")
        anchor_benv = BatchedEnv(anchor_env, args.anchor_envs)
        anchor_success = E.success_criterion("VSSMultiAgent-v0")

        @jax.jit
        def run_anchor(params, obs_norm, key):
            policy = trainer.make_policy(params, obs_norm=obs_norm)
            ev = E.make_eval_fn(
                anchor_benv, args.anchor_steps, policy, anchor_success
            )
            return ev(key)

    history = []
    opp_payload = eval_env.payload_from(init_params)
    best_anchor, best_params, best_norm = -1.0, None, None
    promoted_anchor = -1.0
    t0 = time.time()
    for u in range(1, args.updates + 1):
        state, metrics = train(state, jax.random.PRNGKey(1000 + u))
        if u % args.swap_every == 0:
            ms = run_eval(
                state.params, state.obs_norm, opp_payload,
                jax.random.PRNGKey(10_000 + u),
            )
            wr = float(ms.success_rate)  # goal rate vs the frozen opponent
            rec = {
                "update": u, "goalrate_vs_frozen": wr,
                "mean_reward": float(metrics["mean_reward"]),
            }
            promote = True
            if run_anchor is not None:
                ams = run_anchor(
                    state.params, state.obs_norm, jax.random.PRNGKey(20_000 + u)
                )
                anchor = float(ams.success_rate)
                rec["anchor_goal_rate"] = anchor
                rec["anchor_episodes"] = int(ams.episodes)
                if anchor > best_anchor:
                    best_anchor = anchor
                    best_params = jax.tree.map(
                        lambda x: jnp.array(x, copy=True), state.params
                    )
                    best_norm = jax.tree.map(
                        lambda x: jnp.array(x, copy=True), state.obs_norm
                    )
                # gate: a generation that regressed on the absolute anchor
                # does not become the next opponent (drift brake)
                promote = anchor >= promoted_anchor - args.anchor_margin
                rec["promoted"] = bool(promote)
            print(
                f"update {u:4d}  reward/step={float(metrics['mean_reward']):+.4f}  "
                f"episodes={int(ms.episodes)}  goalrate_vs_frozen={wr:.3f}"
                + (
                    f"  anchor={rec['anchor_goal_rate']:.3f}"
                    f"{'' if promote else '  (not promoted)'}"
                    if run_anchor is not None else ""
                )
                + f"  ({time.time() - t0:.0f}s)",
                flush=True,
            )
            history.append(rec)
            if promote:
                # the current learner becomes the next frozen opponent —
                # pure data swap inside the env state, no retrace
                opp_payload = eval_env.payload_from(state.params, state.obs_norm)
                state = SelfPlayBatchedEnv.swap_opponent(state, opp_payload)
                if run_anchor is not None:
                    promoted_anchor = max(promoted_anchor, rec["anchor_goal_rate"])

    print(json.dumps(history))
    if args.save:
        from rsoccer_tpu.utils import checkpoint

        # save the obs normaliser with the params — evaluating params
        # alone silently feeds the network unnormalised observations
        if args.anchor_gate and best_params is not None:
            checkpoint.save(
                args.save, {"params": best_params, "obs_norm": best_norm}
            )
            print(
                f"saved BEST-anchor {{params, obs_norm}} "
                f"(anchor={best_anchor:.3f}) to {args.save}"
            )
        else:
            checkpoint.save(
                args.save, {"params": state.params, "obs_norm": state.obs_norm}
            )
            print(f"saved {{params, obs_norm}} to {args.save}")


if __name__ == "__main__":
    main()
