"""Roofline / MFU accounting for one jitted train step (PPO or SAC).

Captures a device trace of the chained train step and combines the GPU's
busy time from the trace (utils/profiling.device_activity) with XLA's cost
analysis of the compiled step (floating-point operations, bytes accessed):

- device time per iteration, idle share and kernel count
- achieved FLOP/s vs the card's peak at the compute dtype
- achieved bytes/s vs peak device-memory bandwidth
- the top kernels by device time

This answers "how far is the update phase from the roofline, and what
bound sets the ceiling" with measured numbers instead of guesses.

    python tools/roofline.py --learner ppo --envs 4096 --chain 50 \
        --num-epochs 2 --minibatch-mode time --rollout-unroll 4
    python tools/roofline.py --learner sac --envs 512 --chain 200 --dtype tf32

Peaks come from :data:`PEAKS`, keyed by the device's ``device_kind``; a
device that is not in the table is refused unless both --peak-tflops and
--peak-gbs are given.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# Published dense peaks (no sparsity) at the full power limit, keyed by
# jax's device_kind: TFLOP/s per compute dtype, and device-memory GB/s.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5, PCIe, NVL columns).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5
        "tflops": {"bf16": 989.4, "tf32": 494.7, "f32": 66.9}, "gbs": 3350.0,
    },
    "NVIDIA H100 PCIe": {
        "tflops": {"bf16": 756.0, "tf32": 378.0, "f32": 51.2}, "gbs": 2000.0,
    },
    "NVIDIA H100 NVL": {
        "tflops": {"bf16": 835.0, "tf32": 417.5, "f32": 60.0}, "gbs": 3900.0,
    },
}


def resolve_peaks(device_kind, dtype, peak_tflops=None, peak_gbs=None):
    """(TFLOP/s, GB/s) for ``device_kind`` at compute ``dtype``; explicit
    values win.  Raises ValueError for a device the table does not know
    when either explicit value is missing — never assumes a peak."""
    if peak_tflops is not None and peak_gbs is not None:
        return peak_tflops, peak_gbs
    if device_kind not in PEAKS:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; pass "
            "--peak-tflops and --peak-gbs"
        )
    row = PEAKS[device_kind]
    return (
        peak_tflops if peak_tflops is not None else row["tflops"][dtype],
        peak_gbs if peak_gbs is not None else row["gbs"],
    )


def build_step(args):
    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv

    env = rsoccer_tpu.make(args.env_id)
    benv = BatchedEnv(env, args.envs)
    if args.learner == "ppo":
        from rsoccer_tpu.models.ppo import PPOConfig, PPOTrainer

        trainer = PPOTrainer(
            benv,
            PPOConfig(
                rollout_steps=args.rollout_steps,
                minibatch_mode=args.minibatch_mode,
                num_minibatches=args.num_minibatches,
                num_epochs=args.num_epochs,
                rollout_unroll=args.rollout_unroll,
            ),
        )
        steps_per_iter = args.rollout_steps * args.envs
    else:
        from rsoccer_tpu.models.sac import SACConfig, SACTrainer

        trainer = SACTrainer(
            benv,
            SACConfig(
                batch_size=args.batch_size, warmup_steps=50,
                grad_steps_per_iter=2, n_step=args.n_step,
                reward_scale=10.0,
            ),
        )
        steps_per_iter = args.envs
    state = trainer.init(jax.random.PRNGKey(0))

    def chained(state, key):
        state, ms = jax.lax.scan(
            trainer.train_step, state, jax.random.split(key, args.chain)
        )
        return state, jax.tree.map(lambda m: m[-1], ms)

    return jax.jit(chained, donate_argnums=0), state, steps_per_iter


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--learner", choices=["ppo", "sac"], default="ppo")
    p.add_argument("--env-id", default="SSLStaticDefenders-v0")
    p.add_argument("--envs", type=int, default=4096)
    p.add_argument("--chain", type=int, default=50)
    p.add_argument("--rollout-steps", type=int, default=128)
    p.add_argument("--minibatch-mode", default="time")
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--num-epochs", type=int, default=2)
    p.add_argument("--rollout-unroll", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=512)  # sac
    p.add_argument("--n-step", type=int, default=8)  # sac
    p.add_argument("--dtype", default="bf16", choices=["bf16", "tf32", "f32"],
                   help="compute dtype whose peak the MFU is taken against")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="override the table's dense TFLOP/s")
    p.add_argument("--peak-gbs", type=float, default=None,
                   help="override the table's device-memory GB/s")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--out", default="traces/roofline")
    p.add_argument("--json", default="", help="also write the summary here")
    args = p.parse_args()
    try:
        args.peak_tflops, args.peak_gbs = resolve_peaks(
            jax.devices()[0].device_kind, args.dtype,
            args.peak_tflops, args.peak_gbs,
        )
    except ValueError as e:
        p.error(str(e))

    from rsoccer_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    step, state, steps_per_iter = build_step(args)
    state, ms = step(state, jax.random.PRNGKey(1))
    jax.block_until_ready(state)
    state, ms = step(state, jax.random.PRNGKey(2))
    jax.block_until_ready(state)

    from rsoccer_tpu.utils.profiling import device_activity, load_profile, trace

    # XLA's own count of the step's floating-point operations and bytes
    cost = step.lower(state, jax.random.PRNGKey(99)).compile().cost_analysis()
    if isinstance(cost, list):  # one entry per device on older jax
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    bytes_ = float(cost.get("bytes accessed", 0.0))
    with trace(args.out):
        state, ms = step(state, jax.random.PRNGKey(99))
        jax.block_until_ready(state)
    act = device_activity(load_profile(args.out), top=args.top)

    busy_s = act["busy_ns"] / 1e9
    iters = args.chain
    tflops = flops / busy_s / 1e12
    gbs = bytes_ / busy_s / 1e9
    print(
        f"device busy: {busy_s * 1e3:.2f} ms for {iters} iters "
        f"({busy_s / iters * 1e6:.0f} us/iter; "
        f"{steps_per_iter * iters / busy_s / 1e6:.1f}M env-steps/s device "
        f"rate; idle share {act['idle_share']:.3f}; {act['n_kernels']} kernels)"
    )
    print(
        f"XLA cost analysis: {flops / 1e9:.2f} GFLOP -> {tflops:.2f} TFLOP/s "
        f"= {100 * tflops / args.peak_tflops:.1f}% of {args.peak_tflops:.0f} "
        f"TFLOP/s ({args.dtype} peak)"
    )
    print(
        f"bytes accessed: {bytes_ / 1e9:.2f} GB -> {gbs:.0f} GB/s = "
        f"{100 * gbs / args.peak_gbs:.1f}% of {args.peak_gbs:.0f} GB/s"
    )
    print(f"\ntop {args.top} kernels by device time:")
    for name, ns, count in act["top"]:
        print(f"{ns / 1e6:9.2f} ms  x{count:6d}  {name[:110]}")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {
                    "learner": args.learner,
                    "envs": args.envs,
                    "chain": args.chain,
                    "device_kind": jax.devices()[0].device_kind,
                    "us_per_iter": busy_s / iters * 1e6,
                    "env_steps_per_s": steps_per_iter * iters / busy_s,
                    "idle_share": act["idle_share"],
                    "achieved_tflops": tflops,
                    "flops_pct_of_peak": 100 * tflops / args.peak_tflops,
                    "achieved_gbs": gbs,
                    "bw_pct_of_peak": 100 * gbs / args.peak_gbs,
                },
                f, indent=1,
            )
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
