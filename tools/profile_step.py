"""Profile the batched env rollout on the GPU.

Captures a jax.profiler trace of the random-policy rollout that bench.py
times and prints what the device did per env step: device time, kernel
count, idle share (gaps between kernels) and the costliest kernels.

    python tools/profile_step.py [--env-id VSS-v0] [--envs 8192] [--steps 100]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import bench
from rsoccer_tpu.utils.cache import enable_persistent_cache


def profile_rollout(env_id, n_envs, n_steps, out, calls=3):
    """Trace ``calls`` warm rollout calls; returns the device_activity
    summary with per-step figures added."""
    from rsoccer_tpu.batch import rollout as R
    from rsoccer_tpu.utils.profiling import device_activity, load_profile, trace

    benv, roll = bench.build(env_id, n_envs, n_steps)
    carry = R.init_carry(benv, jax.random.key(0, impl=bench.RNG_IMPL))
    for _ in range(2):  # compile, then the retrace-free second call
        carry, ms = roll(carry)
        jax.block_until_ready(ms)
    with trace(out):
        for _ in range(calls):
            carry, ms = roll(carry)
        jax.block_until_ready((carry, ms))
    act = device_activity(load_profile(out))
    steps = calls * n_steps
    act["device_us_per_step"] = act["busy_ns"] / steps / 1e3
    act["kernels_per_step"] = act["n_kernels"] / steps
    return act


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--out", default="traces/step")
    args = p.parse_args()
    enable_persistent_cache()

    act = profile_rollout(args.env_id, args.envs, args.steps, args.out)
    print(
        f"{args.env_id} @ {args.envs} envs: "
        f"{act['device_us_per_step']:.2f} us device time per env step, "
        f"{act['kernels_per_step']:.2f} kernels per step, "
        f"idle share {act['idle_share']:.4f}"
    )
    for name, ns, count in act["top"]:
        print(f"{ns / 1e6:10.3f} ms  x{count:6d}  {name[:100]}")


if __name__ == "__main__":
    main()
