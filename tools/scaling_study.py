"""Batch-size scaling study: env-steps/s vs number of parallel envs.

    python tools/scaling_study.py [--env-id VSS-v0] [--sizes 2048,8192,32768]

Prints one line per batch size, timed as bench.py times its one point.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

import bench
from rsoccer_tpu.utils.cache import enable_persistent_cache


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="VSS-v0")
    p.add_argument("--sizes", default="2048,8192,32768,131072")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--rng-impl", default=bench.RNG_IMPL)
    args = p.parse_args()
    enable_persistent_cache()

    from rsoccer_tpu.batch import rollout as R

    for b in (int(s) for s in args.sizes.split(",")):
        benv, roll = bench.build(args.env_id, b, args.steps)
        carry = R.init_carry(benv, jax.random.key(0, impl=args.rng_impl))
        sec, _, _ = bench.time_rollout(roll, carry)
        print(
            f"B={b:7d}: {args.steps * b / sec / 1e6:8.1f}M env-steps/s "
            f"({sec / args.steps * 1e6:7.1f} us/step-batch)",
            flush=True,
        )


if __name__ == "__main__":
    main()
