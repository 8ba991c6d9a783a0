"""Golden-trajectory regression tests.

Replays scripted trajectories recorded by ``tests/golden/record.py`` and
asserts the current implementation reproduces them.  Guards physics/task
refactors against silent behavior drift.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rsoccer_tpu

FIXTURES = os.path.join(os.path.dirname(__file__), "golden", "fixtures.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(FIXTURES), reason="no golden fixtures recorded"
)


@pytest.mark.parametrize("env_id", [
    "VSS-v0",
    "SSLStaticDefenders-v0",
    "SSLDribbling-v0",
    "SSLContestedPossession-v0",
    "SSLPassEndurance-v0",
])
def test_trajectory_matches_golden(env_id):
    from tests.golden.record import N_STEPS, scripted_action

    fixtures = np.load(FIXTURES)
    key = env_id.replace("-", "_")
    want_obs = fixtures[f"{key}_obs"]
    want_rew = fixtures[f"{key}_rew"]
    want_done = fixtures[f"{key}_done"]

    env = rsoccer_tpu.make(env_id)
    state, obs = env.reset(jax.random.PRNGKey(123))
    np.testing.assert_allclose(np.asarray(obs), want_obs[0], atol=1e-5)
    for t in range(N_STEPS):
        a = scripted_action(env_id, t, env.action_size)
        state, obs, r, term, trunc, info = env.step(
            state, a, jax.random.PRNGKey(1000 + t)
        )
        np.testing.assert_allclose(
            np.asarray(obs), want_obs[t + 1], atol=1e-4,
            err_msg=f"{env_id} obs diverged at step {t}",
        )
        np.testing.assert_allclose(
            float(r), want_rew[t], atol=1e-4,
            err_msg=f"{env_id} reward diverged at step {t}",
        )
        assert (bool(term) or bool(trunc)) == bool(want_done[t])
