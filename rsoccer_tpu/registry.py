"""Environment registry.

Mirrors the reference's gymnasium registrations (rsoccer_gym/__init__.py:3-30)
— same ids, same ``max_episode_steps``, same constructor kwargs — but returns
functional JAX envs.  The gymnasium-compatible class wrappers live in
``rsoccer_tpu.gym_compat``.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(env_id: str, factory: Callable):
    _REGISTRY[env_id] = factory


def make(env_id: str, **kwargs):
    """Create a functional env by reference id (e.g. ``"VSS-v0"``)."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"Unknown env id {env_id!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[env_id](**kwargs)


def registered_ids():
    return sorted(_REGISTRY)


def _populate():
    # Reference rsoccer_gym/__init__.py:3-30 — ids, kwargs and step limits.
    from rsoccer_tpu.envs.vss import VSSEnv

    register("VSS-v0", VSSEnv)

    from rsoccer_tpu.envs.ssl_static_defenders import SSLStaticDefendersEnv
    from rsoccer_tpu.envs.ssl_dribbling import SSLDribblingEnv
    from rsoccer_tpu.envs.ssl_contested_possession import (
        SSLContestedPossessionEnv,
    )
    from rsoccer_tpu.envs.ssl_pass_endurance import SSLPassEnduranceEnv

    register(
        "SSLStaticDefenders-v0",
        lambda **kw: SSLStaticDefendersEnv(**{"field_type": 2, **kw}),
    )
    register("SSLDribbling-v0", SSLDribblingEnv)
    register("SSLContestedPossession-v0", SSLContestedPossessionEnv)
    register("SSLPassEndurance-v0", SSLPassEnduranceEnv)

    # extensions beyond the reference surface
    from rsoccer_tpu.envs.vss_multiagent import VSSMultiAgentEnv
    from rsoccer_tpu.envs.vss_selfplay import VSSSelfPlayEnv

    register("VSSMultiAgent-v0", VSSMultiAgentEnv)
    register("VSSSelfPlay-v0", VSSSelfPlayEnv)


_populate()
