"""Benchmark: VSS-v0 env-steps/s at 8192 parallel envs on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, with the device
as JAX reports it.  Refuses to run without a GPU: a CPU number is not the
device metric.

Env overrides: RSOCCER_BENCH_ENVS, RSOCCER_BENCH_STEPS, RSOCCER_BENCH_ITERS,
RSOCCER_BENCH_UNROLL, RSOCCER_BENCH_ENV_ID, RSOCCER_BENCH_RNG (key impl).
"""

import json
import os
import sys
import time

import jax

from rsoccer_tpu.utils.cache import enable_persistent_cache

# env-noise key implementation: the faster of the two on the H100 for the
# VSS-v0 engine rollout at 8192 envs (PERF.md, "threefry vs rbg")
RNG_IMPL = "threefry2x32"
# scan unroll of the engine rollout.  On the H100 unroll 4 matches unroll
# 16 on VSS-v0 (49.1M vs 49.3M env-steps/s at 8192 envs) and compiles in
# 28 s instead of 153 s (SSLStaticDefenders: 45 s instead of 193 s, for
# 11% less rate); unroll 1 is 17% slower on VSS-v0 (PERF.md).
UNROLL = 4


def build(env_id: str, n_envs: int, n_steps: int, unroll: int = UNROLL):
    """(BatchedEnv, jitted donated rollout of ``n_steps`` random-policy
    steps) — the program this benchmark times."""
    import rsoccer_tpu
    from rsoccer_tpu.batch import rollout as R
    from rsoccer_tpu.batch.vecenv import BatchedEnv

    benv = BatchedEnv(rsoccer_tpu.make(env_id), n_envs)
    roll = jax.jit(
        R.make_rollout_fn(benv, n_steps, unroll=unroll), donate_argnums=0
    )
    return benv, roll


def time_rollout(roll, carry, n_iters: int = 5, min_seconds: float = 2.0):
    """Steady-state seconds per ``roll`` call.  Two warm-up calls (compile,
    then the call whose input types come from the first call's outputs),
    then an iteration count grown until the window lasts ``min_seconds``.
    Returns (seconds per call, carry, last metrics)."""
    for _ in range(2):
        carry, ms = roll(carry)
        jax.block_until_ready(ms)
    while True:
        t0 = time.perf_counter()
        for _ in range(n_iters):
            carry, ms = roll(carry)
        jax.block_until_ready((carry, ms))
        dt = time.perf_counter() - t0
        if dt >= min_seconds or n_iters >= 2000:
            return dt / n_iters, carry, ms
        n_iters = min(2000, max(n_iters * 2, int(n_iters * 1.25 * min_seconds / max(dt, 1e-3))))


def main():
    if jax.default_backend() != "gpu":
        print("bench.py measures the GPU, and JAX found none", file=sys.stderr)
        sys.exit(1)
    enable_persistent_cache()
    from rsoccer_tpu.batch import rollout as R

    n_envs = int(os.environ.get("RSOCCER_BENCH_ENVS", 8192))
    n_steps = int(os.environ.get("RSOCCER_BENCH_STEPS", 100))
    n_iters = int(os.environ.get("RSOCCER_BENCH_ITERS", 5))
    unroll = int(os.environ.get("RSOCCER_BENCH_UNROLL", UNROLL))
    env_id = os.environ.get("RSOCCER_BENCH_ENV_ID", "VSS-v0")
    rng_impl = os.environ.get("RSOCCER_BENCH_RNG", RNG_IMPL)

    benv, roll = build(env_id, n_envs, n_steps, unroll)
    carry = R.init_carry(benv, jax.random.key(0, impl=rng_impl))
    sec, carry, ms = time_rollout(roll, carry, n_iters)
    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": f"env-steps/s @ {n_envs} parallel {env_id} envs",
                "value": round(n_envs * n_steps / sec),
                "unit": "env-steps/s",
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    # context for humans, on stderr so the JSON line stays clean
    print(
        f"# {n_steps} steps x {n_envs} envs in {sec * 1e3:.3f} ms per call "
        f"(key impl {rng_impl}, unroll {unroll}); last-call "
        f"episodes={int(ms.episodes)} total_reward={float(ms.total_reward):.1f}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
