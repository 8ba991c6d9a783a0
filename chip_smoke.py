"""Smoke test of the main path on one GPU, through the user entry points.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --chips 4   # four GPUs: only the sharded phases

Phases (one GPU):

- device: JAX must find a GPU; prints the card's name and power limit.
- engine: every registered task, ``make`` -> ``BatchedEnv`` -> the rollout
  bench.py times, at 8192 envs: finite state, obs within +-1.2, two runs
  from one key bitwise equal, env-steps/s per task; VSS-v0 timed under both
  key implementations.
- reference: one batched step of each reference task on the GPU against the
  same state, action and noise stepped by the CPU backend; the golden
  trajectories of tests/golden replayed on the GPU.
- ppo: three ``PPOTrainer`` steps on the SSLStaticDefenders recipe, and the
  bf16 policy forward against the CPU's float32 forward.
- sac: ``SACTrainer`` iterations past warm-up on the 512-env SD recipe, the
  precision its float32 matmuls run at, and its forward against the CPU's.
- checkpoint: shipped SAC and PPO policies restored, their actions on the
  GPU against the CPU's.

Every phase raises on failure; the script then exits non-zero and prints no
result line.  The last line of a passing run is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the CPU backend is the reference: keep it next to the GPU when the
# environment names platforms (the GPU stays the default backend)
_plat = os.environ.get("JAX_PLATFORMS", "")
if _plat and "cpu" not in _plat.split(","):
    os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N_ENVS = 8192
REFERENCE_IDS = (
    "VSS-v0",
    "SSLStaticDefenders-v0",
    "SSLDribbling-v0",
    "SSLContestedPossession-v0",
    "SSLPassEndurance-v0",
)

# Tolerances (absolute, after scaling where stated), and why:
# - one env step, GPU vs CPU backend, same inputs: the two backends'
#   transcendentals (sin, cos, atan2, sqrt, exp) differ by a few ulps and
#   XLA fuses differently; rewards scale potential differences by
#   3 / time_step = 120, so they get the looser bound.
STEP_OBS_ATOL = 1e-4
STEP_REWARD_ATOL = 1e-3
# - golden trajectories: the CPU test's own bound (tests/test_golden.py).
GOLDEN_ATOL = 1e-4
# - bf16 PPO forward vs float32 CPU: bf16 keeps 8 bits of mantissa
#   (relative rounding 2^-9 per value) through two 256-wide tanh layers;
#   bound = 4% of the reference output's largest magnitude.
BF16_REL = 4e-2
# - float32 forward with default GPU matmul precision vs CPU "highest": if
#   the GPU rounds matmul inputs to TF32 (10-bit mantissa, 2^-11 relative)
#   the error after three layers stays well under 1% of the output scale.
F32_REL = 1e-2
# - shipped checkpoints, float32 'highest' on both backends: only summation
#   order and transcendentals differ.  Trained weights push pre-clip PPO
#   means to ~900, where float32 vs float64 already differ by ~6e-5 in the
#   clipped action; the bound leaves 16x room over that.
CKPT_ATOL = 1e-3
# - sharded rollout vs the same program on one card: the per-lane
#   arithmetic is the same and the noise bits are too (threefry is
#   partitionable), so equality is expected; XLA may still fuse the
#   per-card shape differently (last-ulp differences), which ten steps of
#   collisions cannot grow past this bound.
SHARD_ATOL = 1e-4


def _log(msg):
    print(msg, flush=True)


def _finite(tree, what):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and not np.all(np.isfinite(a)):
            raise AssertionError(f"{what}: non-finite values in {path}")


def _close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max |diff| {err:.3e} > {atol:.3e}")
    return err


def _rel_close(got, want, rel, what):
    scale = float(np.max(np.abs(np.asarray(want)))) or 1.0
    err = _close(got, want, rel * scale, what)
    return err / scale


def _cpu():
    return jax.devices("cpu")[0]


def _on_cpu(fn, *args):
    """``fn(*args)`` jitted on the CPU backend at full float32 precision."""
    args = jax.device_put(args, _cpu())
    with jax.default_matmul_precision("highest"):
        return jax.jit(fn)(*args)


def _on_gpu(fn, *args):
    return jax.jit(fn)(*jax.device_put(args, jax.devices()[0]))


# ---------------------------------------------------------------- phases
def phase_device(chips):
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (backend {backend!r})")
    devs = jax.devices()
    if len(devs) != chips:
        raise SystemExit(f"chip_smoke: expected {chips} GPU(s), JAX found {len(devs)}")
    _log(f"device_kind: {devs[0].device_kind}")
    _log(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        _log(f"nvidia-smi: {line.strip()}")


def phase_engine(ids, n_envs=N_ENVS, n_steps=100, min_seconds=1.0):
    import bench
    from rsoccer_tpu.batch import rollout as R

    for env_id in ids:
        impls = (
            ("threefry2x32", "rbg") if env_id == "VSS-v0" else (bench.RNG_IMPL,)
        )
        benv, roll = bench.build(env_id, n_envs, n_steps)
        for impl in impls:
            key = jax.random.key(0, impl=impl)
            runs, t0 = [], time.perf_counter()
            for _ in range(2):
                carry = R.init_carry(benv, key)
                carry, _ = roll(carry)
                carry, ms = roll(carry)
                runs.append(jax.device_get((carry.state, carry.obs, ms)))
                if len(runs) == 1:
                    t_first = time.perf_counter() - t0
            (state, obs, ms), (state_b, obs_b, ms_b) = runs
            _finite(state, f"{env_id} state")
            _finite(obs, f"{env_id} obs")
            if np.max(np.abs(obs)) > 1.2:
                raise AssertionError(f"{env_id}: obs outside +-1.2")
            _bitwise_equal((state, obs, ms), (state_b, obs_b, ms_b), env_id)
            t0 = time.perf_counter()
            sec, _, _ = bench.time_rollout(
                roll, R.init_carry(benv, key), min_seconds=min_seconds
            )
            _log(
                f"engine {env_id} @ {n_envs} envs, key {impl}: "
                f"{n_envs * n_steps / sec:.0f} env-steps/s ({sec * 1e3:.3f} ms per "
                f"{n_steps}-step call; {int(ms.episodes)} episode ends in the "
                f"second call; first run incl. compile {t_first:.1f} s, "
                f"timing {time.perf_counter() - t0:.1f} s)"
            )


def _bitwise_equal(a, b, what):
    for (path, x), y in zip(
        jax.tree_util.tree_leaves_with_path(a), jax.tree.leaves(b)
    ):
        x, y = np.asarray(x), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
            diff = np.max(np.abs(x.astype(np.float64) - y.astype(np.float64)))
            raise AssertionError(
                f"{what}: two runs from one key differ at {path} "
                f"(max |diff| {diff:.3e})"
            )


def phase_reference(ids=REFERENCE_IDS, n_envs=N_ENVS):
    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.envs.base import draw_noise

    for env_id in ids:
        env = rsoccer_tpu.make(env_id)
        benv = BatchedEnv(env, n_envs)
        with jax.default_device(_cpu()):
            k_reset, k_t, k_r, k_a = jax.random.split(jax.random.PRNGKey(7), 4)
            state, _ = jax.jit(benv.reset)(k_reset)
            inputs = jax.device_get((
                state,
                jax.random.uniform(
                    k_a, (env.action_size, n_envs), minval=-1.0, maxval=1.0
                ),
                draw_noise(k_t, env.transition_noise_spec(), batch=n_envs),
                draw_noise(k_r, env.reset_noise_spec(), batch=n_envs),
            ))
        step = jax.vmap(env.step_with_noise, in_axes=-1, out_axes=-1)
        _, o_g, r_g, te_g, tr_g, _ = jax.device_get(_on_gpu(step, *inputs))
        _, o_c, r_c, te_c, tr_c, _ = jax.device_get(_on_cpu(step, *inputs))
        e_o = _close(o_g, o_c, STEP_OBS_ATOL, f"{env_id} step obs")
        e_r = _close(r_g, r_c, STEP_REWARD_ATOL, f"{env_id} step reward")
        for name, g, c in (("terminated", te_g, te_c), ("truncated", tr_g, tr_c)):
            if not np.array_equal(g, c):
                raise AssertionError(
                    f"{env_id} step {name}: {int(np.sum(g != c))} lanes differ"
                )
        _log(
            f"reference {env_id} @ {n_envs} envs: GPU vs CPU step max |diff| "
            f"obs {e_o:.3e} (tol {STEP_OBS_ATOL}), reward {e_r:.3e} "
            f"(tol {STEP_REWARD_ATOL}), flags equal"
        )
    _golden(ids)


def _golden(ids):
    import rsoccer_tpu
    from tests.golden.record import N_STEPS, scripted_action

    fixtures = np.load(os.path.join(REPO, "tests", "golden", "fixtures.npz"))
    for env_id in ids:
        key = env_id.replace("-", "_")
        want_obs = fixtures[f"{key}_obs"]
        want_rew = fixtures[f"{key}_rew"]
        want_done = fixtures[f"{key}_done"]
        env = rsoccer_tpu.make(env_id)
        step = jax.jit(env.step)
        state, obs = jax.jit(env.reset)(jax.random.PRNGKey(123))
        e_o = _close(obs, want_obs[0], GOLDEN_ATOL, f"{env_id} golden reset")
        e_r = 0.0
        for t in range(N_STEPS):
            a = scripted_action(env_id, t, env.action_size)
            state, obs, r, term, trunc, _ = step(
                state, a, jax.random.PRNGKey(1000 + t)
            )
            e_o = max(e_o, _close(
                obs, want_obs[t + 1], GOLDEN_ATOL, f"{env_id} golden obs, step {t}"
            ))
            e_r = max(e_r, _close(
                r, want_rew[t], GOLDEN_ATOL, f"{env_id} golden reward, step {t}"
            ))
            if (bool(term) or bool(trunc)) != bool(want_done[t]):
                raise AssertionError(f"{env_id} golden done flag, step {t}")
        _log(
            f"golden {env_id}: {N_STEPS} steps on the GPU, max |diff| obs "
            f"{e_o:.3e}, reward {e_r:.3e} (tol {GOLDEN_ATOL})"
        )


def _obs_batch(env_id, n, seed=11):
    """``(n, obs_size)`` observations of freshly reset envs, made on the CPU."""
    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv

    benv = BatchedEnv(rsoccer_tpu.make(env_id), n)
    with jax.default_device(_cpu()):
        _, obs = jax.jit(benv.reset)(jax.random.PRNGKey(seed))
    return np.asarray(obs).T


def ppo_recipe():
    """SSLStaticDefenders PPO recipe (docs/training.md): 4096 envs x 128
    steps, (256, 256) bf16 towers, 2 epochs of time minibatches."""
    from rsoccer_tpu.models.ppo import PPOConfig

    return PPOConfig(
        rollout_steps=128, num_epochs=2, num_minibatches=8,
        minibatch_mode="time", rollout_unroll=4, gamma=0.995,
        anneal_updates=6000, hidden=(256, 256),
    )


def phase_ppo(n_envs=4096, cfg=None, n_updates=3):
    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.models.networks import ActorCritic
    from rsoccer_tpu.models.ppo import PPOTrainer

    cfg = cfg or ppo_recipe()
    benv = BatchedEnv(rsoccer_tpu.make("SSLStaticDefenders-v0"), n_envs)
    trainer = PPOTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))
    step = jax.jit(trainer.train_step, donate_argnums=0)
    for i in range(n_updates):
        t0 = time.perf_counter()
        state, m = step(state, jax.random.PRNGKey(1 + i))
        m = jax.device_get(m)
        _finite(m, f"ppo metrics, update {i}")
        _log(
            f"ppo update {i}: {time.perf_counter() - t0:.3f} s host clock "
            f"(first includes compile); "
            + ", ".join(f"{k} {float(v):.4g}" for k, v in sorted(m.items()))
        )
    _finite(state.params, "ppo params")
    obs = np.asarray(state.obs_norm.normalize(_obs_batch(
        "SSLStaticDefenders-v0", n_envs
    )))
    params = jax.device_get(state.params)
    ref = ActorCritic(benv.action_size, cfg.hidden, jnp.float32)
    got = _on_gpu(trainer.net.apply, params, obs)
    want = _on_cpu(ref.apply, params, obs)
    e_m = _rel_close(got[0], want[0], BF16_REL, "ppo bf16 forward, mean")
    e_v = _rel_close(got[2], want[2], BF16_REL, "ppo bf16 forward, value")
    _log(
        f"ppo forward on {n_envs} rows, bf16 GPU vs float32 CPU: max |diff| / "
        f"max |ref| mean {e_m:.3e}, value {e_v:.3e} (tol {BF16_REL})"
    )


def sac_recipe():
    """StaticDefenders SAC recipe (docs/training.md): batch 512, 2 grad
    steps, n-step 8, reward scale 10, gamma 0.995, 50 warm-up iterations."""
    from rsoccer_tpu.models.sac import SACConfig

    return SACConfig(
        buffer_size=1 << 18, batch_size=512, grad_steps_per_iter=2, n_step=8,
        gamma=0.995, reward_scale=10.0, target_entropy_scale=0.5,
        warmup_steps=50,
    )


def phase_sac(n_envs=512, cfg=None, n_iters=60, probe=512):
    import rsoccer_tpu
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.models.sac import SACTrainer

    cfg = cfg or sac_recipe()
    benv = BatchedEnv(rsoccer_tpu.make("SSLStaticDefenders-v0"), n_envs)
    trainer = SACTrainer(benv, cfg)
    state = trainer.init(jax.random.PRNGKey(0))

    def chained(state, key):
        state, ms = jax.lax.scan(
            trainer.train_step, state, jax.random.split(key, n_iters)
        )
        return state, jax.tree.map(lambda m: m[-1], ms)

    t0 = time.perf_counter()
    state, m = jax.jit(chained, donate_argnums=0)(state, jax.random.PRNGKey(1))
    m = jax.device_get(m)
    _finite(m, "sac metrics")
    _finite((state.actor_params, state.qs_params), "sac params")
    if int(state.total_steps) != n_iters or n_iters <= cfg.warmup_steps:
        raise AssertionError("sac: did not run past warm-up")
    _log(
        f"sac {n_iters} iterations ({cfg.warmup_steps} warm-up) at {n_envs} "
        f"envs in {time.perf_counter() - t0:.1f} s host clock incl. compile; "
        + ", ".join(f"{k} {float(v):.4g}" for k, v in sorted(m.items()))
    )
    _log(f"sac float32 matmuls on the GPU: {_matmul_precision(probe)}")
    obs = _obs_batch("SSLStaticDefenders-v0", n_envs)
    params = jax.device_get(state.actor_params)
    got = _on_gpu(trainer.actor.apply, params, obs)
    want = _on_cpu(trainer.actor.apply, params, obs)
    e = max(
        _rel_close(got[0], want[0], F32_REL, "sac forward, mean"),
        _rel_close(got[1], want[1], F32_REL, "sac forward, log_std"),
    )
    _log(
        f"sac forward on {n_envs} rows, GPU default precision vs CPU highest: "
        f"max |diff| / max |ref| {e:.3e} (tol {F32_REL})"
    )


def _matmul_precision(n):
    """What a default-precision float32 matmul of SAC's shape does on the
    GPU, judged by its error against the 'highest'-precision product."""
    ka, kb = jax.random.split(jax.random.PRNGKey(5))
    a = jax.random.normal(ka, (n, 256), jnp.float32)
    b = jax.random.normal(kb, (256, 256), jnp.float32)
    default = jax.jit(jnp.matmul)(a, b)
    with jax.default_matmul_precision("highest"):
        exact = jax.jit(jnp.matmul)(a, b)
    rel = float(jnp.max(jnp.abs(default - exact)) / jnp.max(jnp.abs(exact)))
    # TF32 keeps 10 mantissa bits: errors ~1e-3 relative; full float32 ~1e-6
    kind = "TF32 (inputs rounded to 10-bit mantissa)" if rel > 1e-5 else "full float32"
    return f"{kind}; default vs highest max rel diff {rel:.2e}"


def phase_checkpoint(n_rows=4096):
    from rsoccer_tpu.models.networks import ActorCritic
    from rsoccer_tpu.models.sac import SquashedGaussianActor
    from rsoccer_tpu.utils import checkpoint

    obs = _obs_batch("SSLStaticDefenders-v0", n_rows)
    sac = checkpoint.restore(os.path.join(REPO, "artifacts", "sac_sd_best2.ckpt"))
    ppo = checkpoint.restore(os.path.join(REPO, "artifacts", "sd_ppo_time.ckpt"))
    norm = np.asarray(ppo["obs_norm"].normalize(obs))
    actor = SquashedGaussianActor(action_size=5)
    sac_act = lambda p, o: jnp.tanh(actor.apply(p, o)[0])  # deterministic eval

    def ppo_act(net):
        return lambda p, o: jnp.clip(net.apply(p, o)[0], -1.0, 1.0)

    f32_net = ActorCritic(action_size=5, compute_dtype=jnp.float32)
    cases = (
        ("sac_sd_best2", sac_act, sac, obs),
        ("sd_ppo_time", ppo_act(f32_net), ppo["params"], norm),
    )
    for name, fn, params, x in cases:
        want = _on_cpu(fn, params, x)
        with jax.default_matmul_precision("highest"):
            got = _on_gpu(fn, params, x)
        e = _close(got, want, CKPT_ATOL, f"{name} actions")
        _log(
            f"checkpoint {name}: actions on {n_rows} SD obs, GPU vs CPU, both "
            f"float32 'highest': max |diff| {e:.3e} (tol {CKPT_ATOL})"
        )
    # what the trainers' own precision does to the shipped policies
    # (informational: SAC float32 at default matmul precision, PPO bf16)
    want = _on_cpu(ppo_act(f32_net), ppo["params"], norm)
    dev = np.abs(np.asarray(_on_gpu(
        ppo_act(ActorCritic(action_size=5)), ppo["params"], norm
    )) - np.asarray(want))
    s_dev = np.abs(np.asarray(_on_gpu(sac_act, sac, obs)) - np.asarray(
        _on_cpu(sac_act, sac, obs)
    ))
    _log(
        f"checkpoint actions at the trainers' precision vs CPU float32: "
        f"sd_ppo_time bf16 max {dev.max():.3e} mean {dev.mean():.3e}; "
        f"sac_sd_best2 default precision max {s_dev.max():.3e} "
        f"mean {s_dev.mean():.3e}"
    )


# ------------------------------------------------------- four-card phases
def phase_sharded(n_per_card=N_ENVS, n_steps=10, ppo_envs=4096, ppo_cfg=None):
    import bench
    import rsoccer_tpu
    from jax.sharding import NamedSharding, PartitionSpec as P
    from rsoccer_tpu.batch import rollout as R
    from rsoccer_tpu.batch.vecenv import BatchedEnv
    from rsoccer_tpu.models.ppo import PPOTrainer
    from rsoccer_tpu.models.sac import SACConfig
    from rsoccer_tpu.parallel.mesh import make_env_mesh, shard_batched_tree
    from rsoccer_tpu.parallel.rollout import (
        make_shard_map_rollout,
        make_sharded_rollout,
        shard_carry,
    )
    from rsoccer_tpu.parallel.sac import make_sharded_sac

    devs = jax.devices()
    n_dev = len(devs)
    mesh = make_env_mesh(n_dev)
    one = devs[0]
    key = jax.random.key(0, impl=bench.RNG_IMPL)

    # jit-partitioned rollout vs the same global program on one card (scan
    # unroll 1: these programs are compiled once each, for a check)
    env = rsoccer_tpu.make("VSS-v0")
    benv = BatchedEnv(env, n_per_card * n_dev)
    roll, init = make_sharded_rollout(benv, mesh, n_steps, unroll=1)
    t0 = time.perf_counter()
    carry, ms = roll(init(key))
    sharded = jax.device_get((carry.state, carry.obs, ms))
    single = jax.device_get(jax.jit(
        R.make_rollout_fn(benv, n_steps, unroll=1)
    )(jax.device_put(R.init_carry(benv, key), one)))
    single = (single[0].state, single[0].obs, single[1])
    e = _close_trees(
        sharded[:2], single[:2], SHARD_ATOL, "sharded rollout state/obs"
    )
    e_m = max(
        _rel_close(a, b, 1e-5, "sharded rollout metrics")
        for a, b in zip(sharded[2], single[2])
    )
    _log(
        f"sharded rollout, {n_dev} x {n_per_card} envs x {n_steps} steps "
        f"({time.perf_counter() - t0:.1f} s incl. compile): state/obs max "
        f"|diff| vs one card {e:.3e} (tol {SHARD_ATOL}), "
        f"metric sums rel diff {e_m:.3e} (tol 1e-5: summation order)"
    )

    sm = make_shard_map_rollout(benv, mesh, n_steps, unroll=1)
    carry, ms = jax.jit(sm)(shard_carry(R.init_carry(benv, key), mesh))
    _finite(jax.device_get((carry.state, carry.obs, ms)), "shard_map rollout")
    _log(f"shard_map rollout: finite, {int(ms.episodes)} episode ends")

    # one PPO step, env batch sharded and params replicated, vs one card
    cfg = ppo_cfg or ppo_recipe()
    pbenv = BatchedEnv(rsoccer_tpu.make("SSLStaticDefenders-v0"), ppo_envs)
    trainer = PPOTrainer(pbenv, cfg)
    state = jax.device_get(trainer.init(jax.random.PRNGKey(0)))
    rep = NamedSharding(mesh, P())
    s_sh = state._replace(
        params=jax.device_put(state.params, rep),
        opt_state=jax.device_put(state.opt_state, rep),
        env_state=shard_batched_tree(state.env_state, mesh, batch_axis=-1),
        obs=shard_batched_tree(state.obs, mesh, batch_axis=-1),
        env_key=jax.device_put(state.env_key, rep),
        obs_norm=jax.device_put(state.obs_norm, rep),
        update_step=jax.device_put(state.update_step, rep),
    )
    k = jax.random.PRNGKey(1)
    p_sh = jax.device_get(jax.jit(trainer.train_step)(s_sh, k)[0].params)
    p_one = jax.device_get(
        jax.jit(trainer.train_step)(jax.device_put(state, one), k)[0].params
    )
    # Adam moves each weight by at most ~lr per optimizer step, so two runs
    # whose gradients differ only in summation order stay within
    # 2 * lr * steps of each other
    n_opt = cfg.num_epochs * cfg.num_minibatches
    tol = 2 * cfg.lr * n_opt
    e = _close_trees(p_sh, p_one, tol, "sharded ppo params")
    _log(
        f"sharded ppo step, {ppo_envs} envs over {n_dev} cards: params max "
        f"|diff| vs one card {e:.3e} (tol {tol:.1e} = 2 lr x {n_opt} Adam steps)"
    )

    # one sharded SAC iteration: replicated params bitwise equal everywhere
    scfg = SACConfig(
        buffer_size=512 * n_dev * 16, batch_size=512, grad_steps_per_iter=2,
        n_step=8, gamma=0.995, reward_scale=10.0, target_entropy_scale=0.5,
        warmup_steps=0,
    )
    sbenv = BatchedEnv(rsoccer_tpu.make("SSLStaticDefenders-v0"), 512 * n_dev)
    _, s_init, s_step = make_sharded_sac(sbenv, scfg, mesh)
    s_state, m = jax.jit(s_step, donate_argnums=0)(
        s_init(jax.random.PRNGKey(3)), jax.random.PRNGKey(4)
    )
    _finite(jax.device_get(m), "sharded sac metrics")
    for leaf in jax.tree.leaves(s_state.actor_params):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        if len(shards) != n_dev or any(
            s.tobytes() != shards[0].tobytes() for s in shards[1:]
        ):
            raise AssertionError("sharded sac: replicas of the params differ")
    _log(f"sharded sac iteration: actor params bitwise equal on {n_dev} cards")


def _close_trees(a, b, atol, what):
    err = 0.0
    for (path, x), y in zip(
        jax.tree_util.tree_leaves_with_path(a), jax.tree.leaves(b)
    ):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.floating) or np.issubdtype(x.dtype, np.integer):
            err = max(err, _close(x, y, atol, f"{what} {path}"))
        elif not np.array_equal(x, np.asarray(y)):
            raise AssertionError(f"{what}: {path} differs")
    return err


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chips", type=int, default=1, choices=(1, 4),
                   help="4: run only the sharded phases, on four GPUs")
    args = p.parse_args(argv)

    phase_device(args.chips)
    sys.path.insert(0, REPO)
    from rsoccer_tpu.utils.cache import enable_persistent_cache

    _log(f"compile cache: {enable_persistent_cache()}")
    phases = (
        [("sharded", phase_sharded)] if args.chips == 4 else [
            ("engine", lambda: phase_engine(_registered_ids())),
            ("reference", phase_reference),
            ("ppo", phase_ppo),
            ("sac", phase_sac),
            ("checkpoint", phase_checkpoint),
        ]
    )
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        _log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))


def _registered_ids():
    import rsoccer_tpu

    return rsoccer_tpu.registered_ids()


if __name__ == "__main__":
    main()
