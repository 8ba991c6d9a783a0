"""Actor-critic networks for the on-device RL stack.

The reference is env-only ("optimized for RL experiments", README.md:10-28,
but ships no agents); a complete framework pairs the batched envs with a
learner.  Networks are plain-JAX MLPs with an ``init(key, *inputs)`` /
``apply(params, *inputs)`` interface; compute dtype is configurable
(bfloat16 by default, fp32 params).

Parameter trees keep the layout of flax ``linen`` modules —
``{"params": {layer: {"kernel", "bias"}, ...}}`` — and :func:`dense_init`
derives each parameter's key the way ``linen`` does, so the shipped
checkpoints restore unchanged and a given init key gives the same weights.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp

Initializer = Callable[..., jnp.ndarray]
lecun_normal = jax.nn.initializers.lecun_normal()


def _param_key(key, *path) -> jnp.ndarray:
    """``key`` folded with the SHA-1 of a parameter's scope path (layer
    name, then the parameter's creation index within the layer)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big"))
    )


def dense_init(
    key, name: str, n_in: int, n_out: int, kernel_init: Initializer = lecun_normal
) -> dict:
    """``{"kernel": (n_in, n_out), "bias": (n_out,)}`` float32 params of the
    dense layer ``name`` (kernel is the layer's first parameter, bias its
    second, initialised to zeros)."""
    return {
        "kernel": kernel_init(_param_key(key, name, 1), (n_in, n_out), jnp.float32),
        "bias": jnp.zeros((n_out,), jnp.float32),
    }


def dense(p: dict, x, dtype=None):
    """``x @ kernel + bias`` with inputs and params cast to ``dtype``
    (default: their promoted type)."""
    dtype = dtype or jnp.result_type(x, p["kernel"], p["bias"])
    y = jax.lax.dot_general(
        x.astype(dtype),
        p["kernel"].astype(dtype),
        (((x.ndim - 1,), (0,)), ((), ())),
    )
    return y + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class ActorCritic:
    """Gaussian-policy actor + value critic with separate torsos."""

    action_size: int
    hidden: Sequence[int] = (256, 256)
    compute_dtype: Any = jnp.bfloat16

    def init(self, key, obs) -> dict:
        # orthogonal init, sqrt(2) hidden / 0.01 policy head / 1.0 value
        # head — the standard PPO continuous-control recipe (small initial
        # policy outputs keep early updates near the shaping gradient)
        orth = jax.nn.initializers.orthogonal
        p = {}
        for tower, head_out, head_scale in (
            ("actor", self.action_size, 0.01),
            ("critic", 1, 1.0),
        ):
            n_in = obs.shape[-1]
            for i, h in enumerate(self.hidden):
                p[f"{tower}_{i}"] = dense_init(
                    key, f"{tower}_{i}", n_in, h, orth(jnp.sqrt(2.0))
                )
                n_in = h
            p[f"{tower}_out"] = dense_init(
                key, f"{tower}_out", n_in, head_out, orth(head_scale)
            )
        p["log_std"] = jnp.zeros((self.action_size,), jnp.float32)
        return {"params": p}

    def apply(self, params, obs):
        """obs (B, O) -> (mean (B, A), log_std (A,), value (B,))."""
        p = params["params"]
        x = obs.astype(self.compute_dtype)
        a = x
        for i in range(len(self.hidden)):
            a = jnp.tanh(dense(p[f"actor_{i}"], a, self.compute_dtype))
        mean = dense(p["actor_out"], a.astype(jnp.float32), jnp.float32)
        v = x
        for i in range(len(self.hidden)):
            v = jnp.tanh(dense(p[f"critic_{i}"], v, self.compute_dtype))
        value = dense(p["critic_out"], v.astype(jnp.float32), jnp.float32)
        return mean, p["log_std"], value[..., 0]


def sample_action(key, mean, log_std):
    """Gaussian sample + log-prob. Shapes: mean (B, A) -> action (B, A)."""
    std = jnp.exp(log_std)
    noise = jax.random.normal(key, mean.shape)
    action = mean + std * noise
    logp = gaussian_logp(action, mean, log_std)
    return action, logp


def gaussian_logp(action, mean, log_std):
    std = jnp.exp(log_std)
    z = (action - mean) / std
    return jnp.sum(
        -0.5 * z * z - log_std - 0.5 * jnp.log(2.0 * jnp.pi), axis=-1
    )


def gaussian_entropy(log_std):
    return jnp.sum(log_std + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e))
