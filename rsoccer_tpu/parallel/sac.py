"""Sharded SAC: the off-policy learner over a device mesh.

The reference has no learner at all (SURVEY §2: env framework only), and
PPO already scales by sharding the env batch and letting the batch-mean
losses induce the gradient collective (parallel/rollout.py,
tools/distributed_smoke.py --impl ppo).  SAC adds one genuinely stateful
piece — the replay buffer — and the answer here is to keep it OUT of the
collectives entirely:

- **per-shard circular rings**: the replay arrays are sharded on the
  capacity axis, so each device owns a private ring of ``C / n_dev`` slots
  fed by its own ``B / n_dev`` envs.  Insertion stride (= local env count)
  and the strided n-step chains of ``models/sac.Buffer.sample_nstep`` stay
  entirely device-local — zero communication in collect and sampling.
- **replicated params/targets/temperature**: each device samples its own
  ``batch / n_dev`` minibatch, computes gradients locally, and a single
  ``pmean`` per gradient (models/sac.SACTrainer(axis_name=...)) makes the
  applied update the gradient of the global-batch mean loss.  Replicated
  params therefore stay bit-identical across devices — the only
  collectives in the whole iteration are 4 gradient pmeans + the metric
  means.

Because the program is a single global SPMD function over the mesh, a
2-process ``jax.distributed`` launch runs the SAME program as a 1-process
run on the same device count and produces identical metrics and parameter
checksums (tests/test_distributed.py).

Semantic note: scalar ring bookkeeping (``buffer.ptr``/``filled``,
``total_steps``) is per-shard but identical on every shard, so the
replicated scalars read back from a sharded state count LOCAL slots — the
global transition count is ``filled * n_dev``.
"""

from __future__ import annotations

from functools import partial

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from rsoccer_tpu.batch.vecenv import BatchedEnv
from rsoccer_tpu.models.sac import Buffer, SACConfig, SACState, SACTrainer
from rsoccer_tpu.parallel.mesh import ENV_AXIS, Mesh


def _state_specs(state_like) -> SACState:
    """Per-leaf PartitionSpecs for a SACState: replay sharded on the
    capacity axis, env state/obs on the batch axis, everything else
    replicated.  ``state_like`` may be a concrete state or the
    ``jax.eval_shape`` of one."""
    rep = lambda tree: jax.tree.map(lambda _: P(), tree)
    blast = lambda tree: jax.tree.map(
        lambda l: P(*([None] * (l.ndim - 1) + [ENV_AXIS])), tree
    )
    buffer_spec = Buffer(
        obs=P(ENV_AXIS, None),
        action=P(ENV_AXIS, None),
        rdb=P(ENV_AXIS, None),
        next_obs=P(ENV_AXIS, None),
        ptr=P(),
        filled=P(),
    )
    return SACState(
        actor_params=rep(state_like.actor_params),
        qs_params=rep(state_like.qs_params),
        qs_target=rep(state_like.qs_target),
        log_alpha=P(),
        opt_actor=rep(state_like.opt_actor),
        opt_qs=rep(state_like.opt_qs),
        opt_alpha=rep(state_like.opt_alpha),
        buffer=buffer_spec,
        env_state=blast(state_like.env_state),
        obs=P(None, ENV_AXIS),
        env_key=P(),
        total_steps=P(),
    )


def shard_sac_state(state: SACState, mesh: Mesh) -> SACState:
    """Place a SACState on the mesh per :func:`_state_specs`."""
    specs = _state_specs(state)
    return jax.tree.map(
        lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
        state,
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def make_sharded_sac(benv: BatchedEnv, cfg: SACConfig, mesh: Mesh):
    """Build the data-parallel SAC training step over ``mesh``.

    Returns ``(local_trainer, init, step)``:

    - ``local_trainer`` — the per-device SACTrainer (``n_envs / n_dev``
      envs, ``buffer_size / n_dev`` ring, ``batch_size / n_dev``
      minibatch, gradients pmean'd over the mesh axis).  Use it for
      ``make_policy``.
    - ``init(key) -> SACState`` — global init placed on the mesh.
    - ``step(state, key) -> (state, metrics)`` — one SAC iteration as a
      shard_map'd SPMD program; jit it (donate the state) or chain it
      under ``lax.scan``.  The key is replicated; each device folds in its
      mesh index, so shards draw independent env noise and replay samples
      while the pmean'd updates keep params replicated.
    """
    n_dev = mesh.devices.size
    for name, val in (
        ("n_envs", benv.n_envs),
        ("buffer_size", cfg.buffer_size),
        ("batch_size", cfg.batch_size),
    ):
        if val % n_dev:
            raise ValueError(
                f"{name}={val} not divisible by mesh size {n_dev}"
            )
    local_benv = BatchedEnv(benv.env, benv.n_envs // n_dev)
    local_cfg = cfg._replace(
        buffer_size=cfg.buffer_size // n_dev,
        batch_size=cfg.batch_size // n_dev,
    )
    local_trainer = SACTrainer(local_benv, local_cfg, axis_name=ENV_AXIS)
    global_trainer = SACTrainer(benv, cfg)

    specs = _state_specs(
        jax.eval_shape(global_trainer.init, jax.random.PRNGKey(0))
    )

    def init(key) -> SACState:
        return shard_sac_state(global_trainer.init(key), mesh)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(specs, P()),
        out_specs=(specs, P()),
        check_vma=False,
    )
    def step(state, key):
        idx = jax.lax.axis_index(ENV_AXIS)
        state, metrics = local_trainer.train_step(
            state, jax.random.fold_in(key, idx)
        )
        # per-shard scalars -> replicated global means
        metrics = jax.tree.map(
            lambda m: jax.lax.pmean(m, ENV_AXIS), metrics
        )
        return state, metrics

    return local_trainer, init, step
