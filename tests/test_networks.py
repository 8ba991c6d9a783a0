"""The plain-JAX policy networks against float64 numpy and against flax.

Every shipped checkpoint must restore into the networks of
``models/networks.py`` / ``models/sac.py`` and give the forward pass a
float64 numpy implementation of the same weights gives.  The networks
replaced flax ``linen`` modules; where flax is importable, the same
checkpoints and the same init keys must also give flax's outputs and
parameters.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rsoccer_tpu.models.networks import ActorCritic
from rsoccer_tpu.models.sac import QCritic, SquashedGaussianActor
from rsoccer_tpu.utils import checkpoint

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = sorted(glob.glob(os.path.join(_REPO, "artifacts", "*.ckpt.npz")))

# float32 forward (conftest sets 'highest' matmul precision) vs float64:
# only rounding of float32 sums differs.  Trained PPO weights push means to
# ~900, so the bound is relative to each output's largest magnitude.
REL_TOL = 1e-5


def _policy_params(tree):
    """(kind, {"params": ...}) of any shipped checkpoint layout."""
    if "actor_params" in tree:
        tree = tree["actor_params"]
    elif "obs_norm" in tree:
        tree = tree["params"]
    kind = "ppo" if "actor_0" in tree["params"] else "sac"
    return kind, tree


def _hidden(kind, p):
    """Names of the hidden layers of one tower, in order."""
    prefix = "actor_" if kind == "ppo" else "fc"
    n = sum(1 for k in p if k.startswith(prefix) and k[len(prefix):].isdigit())
    return [f"{prefix}{i}" for i in range(n)]


def _np_forward(kind, p, obs):
    """float64 reference: tanh towers for PPO, relu tower for SAC."""
    f64 = lambda a: np.asarray(a, np.float64)

    def dense(name, x):
        return x @ f64(p[name]["kernel"]) + f64(p[name]["bias"])

    if kind == "ppo":
        a = v = obs
        for name in _hidden(kind, p):
            a = np.tanh(dense(name, a))
            v = np.tanh(dense(name.replace("actor", "critic"), v))
        return dense("actor_out", a), f64(p["log_std"]), dense("critic_out", v)[:, 0]
    x = obs
    for name in _hidden(kind, p):
        x = np.maximum(dense(name, x), 0.0)
    return dense("mean", x), np.clip(dense("log_std", x), -5.0, 2.0)


def _module(kind, params, use_flax=False):
    p = params["params"]
    hidden = tuple(p[name]["kernel"].shape[1] for name in _hidden(kind, p))
    n_act = p["actor_out" if kind == "ppo" else "mean"]["kernel"].shape[1]
    if use_flax:
        cls = _flax_modules()["ppo" if kind == "ppo" else "actor"]
        return cls(n_act, hidden, jnp.float32)
    if kind == "ppo":
        return ActorCritic(n_act, hidden, jnp.float32)
    return SquashedGaussianActor(n_act, hidden, jnp.float32)


@pytest.mark.parametrize("path", CKPTS, ids=[os.path.basename(p) for p in CKPTS])
def test_checkpoint_forward_matches_float64(path):
    kind, params = _policy_params(checkpoint.restore(path))
    params = jax.tree.map(jnp.asarray, params)
    n_obs = params["params"]["actor_0" if kind == "ppo" else "fc0"]["kernel"].shape[0]
    obs = np.random.default_rng(0).normal(size=(64, n_obs)).astype(np.float32)
    got = _module(kind, params).apply(params, obs)
    want = _np_forward(kind, params["params"], np.asarray(obs, np.float64))
    for g, w in zip(got, want):
        scale = max(1.0, float(np.max(np.abs(w))))
        np.testing.assert_allclose(np.asarray(g, np.float64), w, atol=REL_TOL * scale, rtol=0)
    if _flax_modules():
        ref = _module(kind, params, use_flax=True).apply(params, obs)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_all_shipped_checkpoints_found():
    assert len(CKPTS) == 43


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["ppo", "actor", "critic"])
def test_init_and_apply_match_flax(kind, dtype):
    """Same key -> bit-identical params and outputs as the flax modules."""
    flax = _flax_modules()
    if not flax:
        pytest.skip("flax is not installed")
    obs = jax.random.normal(jax.random.PRNGKey(1), (7, 24))
    act = jax.random.normal(jax.random.PRNGKey(2), (7, 5))
    key = jax.random.PRNGKey(3)
    ours = {
        "ppo": ActorCritic(5, (64, 32), dtype),
        "actor": SquashedGaussianActor(5, (64, 32), dtype),
        "critic": QCritic((64, 32), dtype),
    }[kind]
    theirs = flax[kind](*(() if kind == "critic" else (5,)), (64, 32), dtype)
    args = (obs, act) if kind == "critic" else (obs,)
    p_ours = ours.init(key, *(a[:1] for a in args))
    p_theirs = theirs.init(key, *(a[:1] for a in args))
    assert jax.tree.structure(p_ours) == jax.tree.structure(p_theirs)
    for a, b in zip(jax.tree.leaves(p_ours), jax.tree.leaves(p_theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(
        jax.tree.leaves(ours.apply(p_ours, *args)),
        jax.tree.leaves(theirs.apply(p_theirs, *args)),
    ):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _flax_modules():
    """The flax linen modules these networks replaced, or {} without flax."""
    try:
        import flax.linen as nn
    except ImportError:
        return {}

    class FlaxActorCritic(nn.Module):
        action_size: int
        hidden: tuple = (256, 256)
        compute_dtype: object = jnp.bfloat16

        @nn.compact
        def __call__(self, obs):
            hidden_init = nn.initializers.orthogonal(jnp.sqrt(2.0))
            x = obs.astype(self.compute_dtype)
            a = x
            for i, h in enumerate(self.hidden):
                a = nn.tanh(nn.Dense(
                    h, name=f"actor_{i}", dtype=self.compute_dtype,
                    kernel_init=hidden_init,
                )(a))
            mean = nn.Dense(
                self.action_size, name="actor_out", dtype=jnp.float32,
                kernel_init=nn.initializers.orthogonal(0.01),
            )(a.astype(jnp.float32))
            log_std = self.param(
                "log_std", nn.initializers.zeros, (self.action_size,)
            )
            v = x
            for i, h in enumerate(self.hidden):
                v = nn.tanh(nn.Dense(
                    h, name=f"critic_{i}", dtype=self.compute_dtype,
                    kernel_init=hidden_init,
                )(v))
            value = nn.Dense(
                1, name="critic_out", dtype=jnp.float32,
                kernel_init=nn.initializers.orthogonal(1.0),
            )(v.astype(jnp.float32))[..., 0]
            return mean, log_std, value

    class FlaxActor(nn.Module):
        action_size: int
        hidden: tuple = (256, 256)
        compute_dtype: object = jnp.float32

        @nn.compact
        def __call__(self, obs):
            x = obs.astype(self.compute_dtype)
            for i, h in enumerate(self.hidden):
                x = nn.relu(nn.Dense(h, name=f"fc{i}", dtype=self.compute_dtype)(x))
            x = x.astype(jnp.float32)
            mean = nn.Dense(self.action_size, name="mean")(x)
            log_std = nn.Dense(self.action_size, name="log_std")(x)
            return mean, jnp.clip(log_std, -5.0, 2.0)

    class FlaxCritic(nn.Module):
        hidden: tuple = (256, 256)
        compute_dtype: object = jnp.float32

        @nn.compact
        def __call__(self, obs, action):
            x = jnp.concatenate([obs, action], axis=-1).astype(self.compute_dtype)
            for i, h in enumerate(self.hidden):
                x = nn.relu(nn.Dense(h, name=f"fc{i}", dtype=self.compute_dtype)(x))
            return nn.Dense(1, name="q")(x.astype(jnp.float32))[..., 0]

    return {"ppo": FlaxActorCritic, "actor": FlaxActor, "critic": FlaxCritic}
