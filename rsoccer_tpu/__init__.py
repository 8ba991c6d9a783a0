"""rsoccer_tpu — batched robot-soccer environment engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of robocin/rSoccer
(Gymnasium environments for IEEE VSS and RoboCup SSL robot soccer): the C++
rSim physics backend becomes a pure-functional, branch-free world step that
vmaps over thousands of env instances, task logic (observations, rewards,
terminations, resets) is expressed as jittable functions, rollouts run as a
single ``lax.scan`` program on-device, and the env batch shards over device
meshes for multi-host scaling.
"""

from rsoccer_tpu.registry import make, registered_ids

__version__ = "0.1.0"


def make_vec(env_id: str, n_envs: int, **kwargs):
    """Create a :class:`~rsoccer_tpu.batch.vecenv.BatchedEnv` directly."""
    from rsoccer_tpu.batch.vecenv import BatchedEnv

    return BatchedEnv(make(env_id, **kwargs), n_envs)


__all__ = ["make", "make_vec", "registered_ids", "__version__"]
