"""Behavioral spec tests for the four SSL hardware-challenge tasks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rsoccer_tpu
from rsoccer_tpu.core.field import ssl_field

FIELD = ssl_field(2)
MAX_POS = 5.5


def place_ball(state, x, y, vx=0.0, vy=0.0):
    w = state.world
    return state._replace(
        world=w._replace(
            ball=w.ball._replace(
                x=jnp.asarray(float(x)), y=jnp.asarray(float(y)),
                v_x=jnp.asarray(float(vx)), v_y=jnp.asarray(float(vy)),
            )
        )
    )


def place_robot(state, i, x, y):
    w = state.world
    rb = w.robots
    return state._replace(
        world=w._replace(
            robots=rb._replace(
                x=rb.x.at[i].set(x), y=rb.y.at[i].set(y)
            )
        )
    )


# --------------------------------------------------------------------------
# StaticDefenders
# --------------------------------------------------------------------------


class TestStaticDefenders:
    @pytest.fixture(scope="class")
    def env(self):
        return rsoccer_tpu.make("SSLStaticDefenders-v0")

    def test_spaces(self, env):
        assert env.obs_size == 24
        assert env.action_size == 5
        assert env.max_episode_steps == 1000

    def test_reset_layout(self, env):
        state, obs = env.reset(jax.random.PRNGKey(0))
        w = state.world
        # blue at origin theta=0
        assert float(w.robots.x[0]) == 0.0 and float(w.robots.y[0]) == 0.0
        # ball on the attack half outside GK area
        bx, by = float(w.ball.x), float(w.ball.y)
        assert 0.2 <= bx <= FIELD.half_length - 0.1
        in_gk = bx > FIELD.half_length - FIELD.penalty_length and abs(by) < 1.0
        assert not in_gk
        # 6 yellows separated by >= 0.2 from everything
        pts = np.stack(
            [
                np.concatenate([[bx, 0.0], np.asarray(w.robots.x[1:])]),
                np.concatenate([[by, 0.0], np.asarray(w.robots.y[1:])]),
            ],
            axis=-1,
        )
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        np.fill_diagonal(d, np.inf)
        assert d.min() >= 0.2 - 1e-6
        assert obs.shape == (24,)

    def test_obs_layout(self, env):
        state, obs = env.reset(jax.random.PRNGKey(1))
        w = state.world
        obs = np.asarray(obs)
        np.testing.assert_allclose(obs[0], np.clip(w.ball.x / MAX_POS, -1.2, 1.2), rtol=1e-5)
        np.testing.assert_allclose(obs[4], 0.0, atol=1e-6)  # blue x = 0
        np.testing.assert_allclose(obs[6], 0.0, atol=1e-6)  # sin(0)
        np.testing.assert_allclose(obs[7], 1.0, atol=1e-6)  # cos(0)
        assert obs[11] == 0.0  # infrared off -> 0
        for i in range(6):
            np.testing.assert_allclose(
                obs[12 + 2 * i],
                np.clip(np.asarray(w.robots.x[1 + i]) / MAX_POS, -1.2, 1.2),
                rtol=1e-5,
            )

    def test_goal_gives_5(self, env):
        state, _ = env.reset(jax.random.PRNGKey(2))
        state = place_ball(state, FIELD.half_length - 0.01, 0.0, 3.0, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(3))
        assert bool(done) and float(r) == 5.0
        assert float(info["goal"]) == 1.0

    def test_miss_right_gives_0(self, env):
        state, _ = env.reset(jax.random.PRNGKey(4))
        state = place_ball(state, FIELD.half_length - 0.01, 2.0, 3.0, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(5))
        assert bool(done) and float(r) == 0.0
        assert float(info["done_ball_out_right"]) == 1.0

    def test_ball_out_left(self, env):
        state, _ = env.reset(jax.random.PRNGKey(6))
        # away from the blue robot at the origin (a ball inside its disc
        # would be collision-bounced back to +x)
        state = place_ball(state, 0.01, 1.5, -2.0, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(7))
        assert bool(done)
        assert float(info["done_ball_out"]) == 1.0

    def test_robot_out_priority(self, env):
        # robot out AND ball out -> only done_rbt_out increments (elif chain)
        state, _ = env.reset(jax.random.PRNGKey(8))
        state = place_ball(state, -0.5, 0.0)
        state = place_robot(state, 0, -0.5, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(9))
        assert bool(done)
        assert float(info["done_rbt_out"]) == 1.0
        assert float(info["done_ball_out"]) == 0.0

    def test_robot_in_gk_area(self, env):
        state, _ = env.reset(jax.random.PRNGKey(10))
        state = place_ball(state, 1.0, 2.0)
        state = place_robot(state, 0, FIELD.half_length - 0.3, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(11))
        assert bool(done)
        assert float(info["rbt_in_gk_area"]) == 1.0

    def test_shaping_composition(self, env):
        state, _ = env.reset(jax.random.PRNGKey(12))
        ns, obs, r, done, info = env.step_env(
            state, jnp.asarray([0.5, 0.0, 0.0, -1.0, -1.0]), jax.random.PRNGKey(13)
        )
        assert not bool(done)
        total = float(info["ball_dist"]) + float(info["ball_grad"]) + float(info["energy"])
        np.testing.assert_allclose(float(r), total, rtol=1e-4, atol=1e-7)


# --------------------------------------------------------------------------
# Dribbling
# --------------------------------------------------------------------------


class TestDribbling:
    @pytest.fixture(scope="class")
    def env(self):
        return rsoccer_tpu.make("SSLDribbling-v0")

    def test_spaces(self, env):
        assert env.obs_size == 21
        assert env.action_size == 4
        assert env.max_episode_steps == 4800

    def test_deterministic_reset(self, env):
        s1, o1 = env.reset(jax.random.PRNGKey(0))
        s2, o2 = env.reset(jax.random.PRNGKey(999))
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
        w = s1.world
        np.testing.assert_allclose(np.asarray(w.robots.x), [0.0, -0.5, -1.0, -1.5, -2.0])
        np.testing.assert_allclose(float(w.ball.x), -0.1)
        np.testing.assert_allclose(np.asarray(w.robots.theta), np.full(5, np.pi))
        # obs head: checkpoint scalar (0/6)*2-1 = -1
        assert float(o1[0]) == -1.0
        # infrared channel reports -1 when off (dribbling quirk)
        assert float(o1[12]) == -1.0

    def test_checkpoint_crossing_gate0(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        # ball inside gate 0 window (-1, -0.5), crossing y from >=0 to <0
        state = place_ball(state, -0.75, 0.005, 0.0, -2.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        assert float(r) == 1.0
        assert int(ns.checkpoints) == 1
        assert not bool(done)
        # progress scalar moved to (1/6)*2-1
        np.testing.assert_allclose(float(obs[0]), (1 / 6) * 2 - 1, rtol=1e-6)

    def test_no_reward_outside_gate_window(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        state = place_ball(state, -1.2, 0.005, 0.0, -2.0)  # between gates 1-2
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        assert float(r) == 0.0
        assert int(ns.checkpoints) == 0

    def test_gate1_requires_upward_crossing(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        state = state._replace(checkpoints=jnp.asarray(1, jnp.int32))
        state = place_ball(state, -1.25, -0.005, 0.0, 2.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        assert float(r) == 1.0
        assert int(ns.checkpoints) == 2

    def test_reverse_crossing_last_gate_ends(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        state = state._replace(checkpoints=jnp.asarray(2, jnp.int32))
        # upward crossing in (-2, -1.5) while count even -> reverse -> done
        state = place_ball(state, -1.75, -0.005, 0.0, 2.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        assert bool(done)
        assert float(r) == 0.0

    def test_course_completion_on_seventh(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        state = state._replace(checkpoints=jnp.asarray(6, jnp.int32))
        state = place_ball(state, -1.75, 0.005, 0.0, -2.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        assert float(r) == 1.0
        assert int(ns.checkpoints) == 7
        assert bool(done)

    def test_robot_out_of_course_ends(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        w = state.world
        state = state._replace(
            world=w._replace(robots=w.robots._replace(x=w.robots.x.at[0].set(0.99)))
        )
        # drive hard +x so the robot exits the margin box
        for t in range(30):
            state, obs, r, done, trunc, info = env.step(
                state, jnp.asarray([1.0, 0.0, 0.0, 0.0]), jax.random.PRNGKey(t)
            )
            if bool(done):
                break
        assert bool(done)

    def test_collision_with_gate_robot_ends(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        # yellow robot 1 (index 1 overall) given velocity -> collision flag
        w = state.world
        state = state._replace(
            world=w._replace(
                robots=w.robots._replace(v_x=w.robots.v_x.at[1].set(0.2))
            )
        )
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(4), jax.random.PRNGKey(1))
        # velocity decays but the post-step speed must still trip the 0.05
        # threshold on this first step
        assert bool(done)


# --------------------------------------------------------------------------
# ContestedPossession
# --------------------------------------------------------------------------


class TestDribblingCurriculum:
    """Training-time curriculum extension (envs/ssl_dribbling.py, kwarg
    ``curriculum=True``) — NOT reference behavior; the default env keeps the
    reference's deterministic reset (covered above)."""

    @pytest.fixture(scope="class")
    def env(self):
        return rsoccer_tpu.make("SSLDribbling-v0", curriculum=True)

    def test_stage_consistent_spawns(self, env):
        from rsoccer_tpu.envs.ssl_dribbling import NODES

        seen = set()
        for seed in range(64):
            state, obs = env.reset(jax.random.PRNGKey(seed))
            s = int(state.checkpoints)
            seen.add(s)
            assert 0 <= s <= 6
            # obs head encodes the stage: (s/6)*2 - 1
            np.testing.assert_allclose(float(obs[0]), (s / 6) * 2 - 1, atol=1e-6)
            bx, by = float(state.world.ball.x), float(state.world.ball.y)
            if s == 0:
                np.testing.assert_allclose([bx, by], [-0.1, 0.0], atol=1e-6)
                continue
            # ball y-side must match the NEXT expected crossing direction:
            # odd count -> must cross upward next (ball below axis), even ->
            # downward (above axis)
            assert (by < 0) == (s % 2 == 1), (s, by)
            # spawns never overlap the on-axis yellows (sum of radii 0.18)
            for node in NODES:
                rx = float(state.world.robots.x[0])
                ry = float(state.world.robots.y[0])
                assert (rx - node) ** 2 + ry**2 > 0.18**2
        assert seen == set(range(7)), f"stages not all sampled: {seen}"

    def test_stage_spawn_can_cross_next_gate(self, env):
        # from an odd stage, pushing the ball straight up crosses the gate
        for seed in range(40):
            state, _ = env.reset(jax.random.PRNGKey(seed))
            s = int(state.checkpoints)
            if s % 2 == 0 or s < 2:
                continue
            state = place_ball(
                state, float(state.world.ball.x), float(state.world.ball.y), 0.0, 2.0
            )
            got = 0.0
            for t in range(40):
                state, _, r, term, trunc, _ = env.step(
                    state, jnp.zeros(env.action_size), jax.random.PRNGKey(t)
                )
                # the crossing step pays the +1 (plus curriculum shaping
                # bounded by 0.5 * v_max * dt ~ 0.03)
                got = max(got, float(r))
                if float(term) or float(trunc):
                    break
            if -2.0 > float(state.world.ball.x) > -3.0:
                assert got >= 0.9
            return
        raise AssertionError("no odd stage sampled in 40 seeds")


class TestContestedPossession:
    @pytest.fixture(scope="class")
    def env(self):
        return rsoccer_tpu.make("SSLContestedPossession-v0")

    def test_spaces(self, env):
        assert env.obs_size == 14
        assert env.action_size == 5
        assert env.max_episode_steps == 1200

    def test_reset_geometry(self, env):
        for seed in range(5):
            state, _ = env.reset(jax.random.PRNGKey(seed))
            w = state.world
            ex, ey = float(w.robots.x[1]), float(w.robots.y[1])
            assert FIELD.penalty_length <= ex <= FIELD.half_length - FIELD.penalty_length
            assert abs(ey) <= FIELD.penalty_width / 2
            np.testing.assert_allclose(float(w.ball.x), ex - 0.1, rtol=1e-5)
            np.testing.assert_allclose(float(w.ball.y), ey, rtol=1e-5)
            assert float(w.robots.theta[1]) == pytest.approx(np.pi)
            assert float(w.robots.x[0]) == 0.0

    def test_collision_ends_episode_with_shaping(self, env):
        state, _ = env.reset(jax.random.PRNGKey(1))
        w = state.world
        state = state._replace(
            world=w._replace(robots=w.robots._replace(v_x=w.robots.v_x.at[1].set(0.5)))
        )
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(2))
        assert bool(done)
        assert float(info["collision"]) == 1.0
        # shaping still paid on the collision step (reference quirk)
        total = float(info["ball_dist"]) + float(info["ball_grad"]) + float(info["energy"])
        np.testing.assert_allclose(float(r), total, rtol=1e-4, atol=1e-7)

    def test_goal(self, env):
        state, _ = env.reset(jax.random.PRNGKey(3))
        state = place_ball(state, FIELD.half_length - 0.01, 0.0, 3.0, 0.0)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(5), jax.random.PRNGKey(4))
        assert bool(done) and float(r) == 5.0
        assert float(info["goal"]) == 1.0


# --------------------------------------------------------------------------
# PassEndurance
# --------------------------------------------------------------------------


class TestPassEndurance:
    @pytest.fixture(scope="class")
    def env(self):
        return rsoccer_tpu.make("SSLPassEndurance-v0")

    def test_spaces(self, env):
        # Box(16) per the code (READMEs claim 18; code wins)
        assert env.obs_size == 16
        assert env.action_size == 3
        assert env.max_episode_steps == 1200

    def test_reset_geometry(self, env):
        for seed in range(8):
            state, _ = env.reset(jax.random.PRNGKey(seed))
            w = state.world
            bx, by = float(w.ball.x), float(w.ball.y)
            sx, sy = float(w.robots.x[0]), float(w.robots.y[0])
            rx, ry = float(w.robots.x[1]), float(w.robots.y[1])
            assert sx == pytest.approx(bx)
            assert sy == pytest.approx(by + 0.115 * np.sign(by))
            assert ry == pytest.approx(-by)
            assert abs(rx - bx) >= 1.0
            # shooter faces the ball: theta -pi/2 if ball below shooter
            expect_theta = -np.pi / 2 if by >= 0 else np.pi / 2
            assert float(w.robots.theta[0]) == pytest.approx(expect_theta)

    def test_stopped_ball_ends_wrong_after_21(self, env):
        state, _ = env.reset(jax.random.PRNGKey(0))
        done = False
        for t in range(25):
            state, obs, r, done, info = env.step_env(
                state, jnp.zeros(3), jax.random.PRNGKey(t)
            )
            if bool(done):
                break
        assert bool(done)
        assert float(r) <= -1.0 + 1e-5  # wrong-pass -1 (plus ~0 ball_grad)
        assert 20 <= t <= 23

    def test_receiver_infrared_completes_pass(self, env):
        state, _ = env.reset(jax.random.PRNGKey(1))
        w = state.world
        rx, ry = float(w.robots.x[1]), float(w.robots.y[1])
        theta = float(w.robots.theta[1])
        face = FIELD.rbt_distance_center_kicker + FIELD.ball_radius - 0.003
        state = place_ball(state, rx + face * np.cos(theta), ry + face * np.sin(theta))
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(3), jax.random.PRNGKey(2))
        assert bool(done)
        assert float(r) >= 1.0 - 1e-5

    def test_ball_leaving_bbox_is_wrong(self, env):
        state, _ = env.reset(jax.random.PRNGKey(2))
        # put the ball far outside the shooter-receiver box
        state = place_ball(state, 4.0, 2.9)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(3), jax.random.PRNGKey(3))
        assert bool(done)
        assert float(r) < 0

    def test_reversed_dist_written_on_done(self, env):
        state, _ = env.reset(jax.random.PRNGKey(3))
        state = place_ball(state, 4.0, 2.9)
        ns, obs, r, done, info = env.step_env(state, jnp.zeros(3), jax.random.PRNGKey(4))
        w = ns.world
        dist_robs = np.hypot(
            float(w.robots.x[1] - w.robots.x[0]), float(w.robots.y[1] - w.robots.y[0])
        )
        dist_ball = np.hypot(
            float(w.robots.x[1] - w.ball.x), float(w.robots.y[1] - w.ball.y)
        )
        np.testing.assert_allclose(
            float(info["reversed_dist"]), (dist_robs - dist_ball) / dist_robs,
            rtol=1e-4,
        )

    def test_kick_deadzone(self, env):
        state, _ = env.reset(jax.random.PRNGKey(4))
        # |a1| = 0.4 < 0.5 -> no kick even with ball on the shooter's face
        w = state.world
        sx, sy, st = (
            float(w.robots.x[0]), float(w.robots.y[0]), float(w.robots.theta[0])
        )
        face = FIELD.rbt_distance_center_kicker + FIELD.ball_radius - 0.003
        state = place_ball(state, sx + face * np.cos(st), sy + face * np.sin(st))
        ns, obs, r, done, info = env.step_env(
            state, jnp.asarray([0.0, 0.4, 1.0]), jax.random.PRNGKey(5)
        )
        v = float(jnp.hypot(ns.world.ball.v_x, ns.world.ball.v_y))
        assert v < 0.5  # not kicked (dribbler pull may move it slightly)


# --------------------------------------------------------------------------
# cross-task: all envs jit + vmap cleanly
# --------------------------------------------------------------------------


@pytest.mark.parametrize("env_id", [
    "SSLStaticDefenders-v0",
    "SSLDribbling-v0",
    "SSLContestedPossession-v0",
    "SSLPassEndurance-v0",
])
def test_jit_and_vmap(env_id):
    from rsoccer_tpu.batch.vecenv import BatchedEnv

    env = rsoccer_tpu.make(env_id)
    benv = BatchedEnv(env, 8)
    state, obs = benv.reset(jax.random.PRNGKey(0))
    assert obs.shape == (env.obs_size, 8)
    acts = jnp.zeros((env.action_size, 8))
    step = jax.jit(benv.step)
    ns, obs2, r, term, trunc, info = step(state, acts, jax.random.PRNGKey(1))
    assert r.shape == (8,)
    assert bool(jnp.isfinite(obs2).all())


# --------------------------------------------------------------------------
# exact observation layouts (element order per reference docstrings/code)
# --------------------------------------------------------------------------


def _norm(v, scale):
    return np.clip(np.asarray(v) / scale, -1.2, 1.2)


class TestPassEnduranceCurriculum:
    """Training-time distance curriculum (envs/ssl_pass_endurance.py kwarg
    ``curriculum=True``); the default env keeps the reference's >= 1 m
    receiver rejection (covered in TestPassEndurance)."""

    def test_distance_distribution(self):
        env = rsoccer_tpu.make("SSLPassEndurance-v0", curriculum=True)
        dists = []
        for seed in range(64):
            state, _ = env.reset(jax.random.PRNGKey(seed))
            w = state.world
            dists.append(abs(float(w.robots.x[1]) - float(w.ball.x)))
            # receiver stays in the reset region and mirrored in y
            assert -1.5 <= float(w.robots.x[1]) <= 1.5
            np.testing.assert_allclose(
                float(w.robots.y[1]), -float(w.ball.y), atol=1e-5
            )
        dists = np.asarray(dists)
        assert dists.min() >= 0.25 - 1e-6
        assert (dists < 1.0).any(), "curriculum never sampled a short pass"
        assert (dists > 1.5).any(), "curriculum never sampled a long pass"

    def test_default_env_keeps_reference_min_distance(self):
        env = rsoccer_tpu.make("SSLPassEndurance-v0")
        for seed in range(32):
            state, _ = env.reset(jax.random.PRNGKey(seed))
            w = state.world
            assert abs(float(w.robots.x[1]) - float(w.ball.x)) >= 1.0 - 1e-6


def test_dribbling_obs_layout_exact():
    env = rsoccer_tpu.make("SSLDribbling-v0")
    state, obs = env.reset(jax.random.PRNGKey(0))
    state = state._replace(checkpoints=jnp.asarray(3, jnp.int32))
    obs = np.asarray(env.observe(state))
    w = state.world
    assert obs[0] == pytest.approx((3 / 6) * 2 - 1)
    np.testing.assert_allclose(obs[1], _norm(w.ball.x, 5.5), rtol=1e-5)
    np.testing.assert_allclose(obs[3], _norm(w.ball.v_x, 2.5), rtol=1e-5)
    # blue block at 5..12
    np.testing.assert_allclose(obs[5], _norm(w.robots.x[0], 5.5), rtol=1e-5)
    np.testing.assert_allclose(obs[7], np.sin(float(w.robots.theta[0])), rtol=1e-5)
    np.testing.assert_allclose(obs[8], np.cos(float(w.robots.theta[0])), rtol=1e-5)
    assert obs[12] == -1.0  # infrared off -> -1 (dribbling quirk)
    # yellow (x, y) pairs at 13..20
    for i in range(4):
        np.testing.assert_allclose(
            obs[13 + 2 * i], _norm(w.robots.x[1 + i], 5.5), rtol=1e-5
        )


def test_contested_possession_obs_layout_exact():
    env = rsoccer_tpu.make("SSLContestedPossession-v0")
    state, obs = env.reset(jax.random.PRNGKey(1))
    obs = np.asarray(obs)
    w = state.world
    np.testing.assert_allclose(obs[0], _norm(w.ball.x, 5.5), rtol=1e-5)
    np.testing.assert_allclose(obs[4], _norm(w.robots.x[0], 5.5), atol=1e-6)
    np.testing.assert_allclose(obs[6], np.sin(float(w.robots.theta[0])), atol=1e-6)
    assert obs[11] in (0.0, 1.0)  # infrared in {0,1}
    np.testing.assert_allclose(obs[12], _norm(w.robots.x[1], 5.5), rtol=1e-5)
    np.testing.assert_allclose(obs[13], _norm(w.robots.y[1], 5.5), rtol=1e-4)


def test_pass_endurance_obs_layout_exact():
    env = rsoccer_tpu.make("SSLPassEndurance-v0")
    state, obs = env.reset(jax.random.PRNGKey(2))
    obs = np.asarray(obs)
    w = state.world
    # per blue: x, y, sin, cos, norm_w(v_theta), infrared — NO v_x/v_y
    for i in range(2):
        base = 4 + 6 * i
        np.testing.assert_allclose(obs[base], _norm(w.robots.x[i], 5.5), rtol=1e-4)
        np.testing.assert_allclose(
            obs[base + 2], np.sin(float(w.robots.theta[i])), atol=1e-5
        )
        np.testing.assert_allclose(
            obs[base + 3], np.cos(float(w.robots.theta[i])), atol=1e-5
        )
        assert obs[base + 5] in (0.0, 1.0)
    # v_theta normaliser is deg2rad(10) rad/s (the reference divides deg/s
    # by 10 — SURVEY unit quirk)
    state2 = state._replace(
        world=w._replace(
            robots=w.robots._replace(v_theta=w.robots.v_theta.at[0].set(0.1))
        )
    )
    obs2 = np.asarray(env.observe(state2))
    np.testing.assert_allclose(obs2[8], 0.1 / np.deg2rad(10.0), rtol=1e-4)


def test_pe_catch_scale_widens_received_window():
    """catch_scale (training-time kwarg) widens the pass-received test; at
    scale 1 it must be OFF (reference semantics: physical infrared)."""
    import rsoccer_tpu

    env1 = rsoccer_tpu.make("SSLPassEndurance-v0")
    env4 = rsoccer_tpu.make("SSLPassEndurance-v0", catch_scale=4.0)
    assert env1.catch_scale == 1.0
    s, _ = env4.reset(jax.random.PRNGKey(0))
    f = env4.field
    # place the ball just outside the reference kicker width but inside
    # the widened window, at face depth, in the receiver's frame
    rx, ry = s.world.robots.x[1], s.world.robots.y[1]
    th = s.world.robots.theta[1]
    lx = float(f.rbt_distance_center_kicker)
    ly = float(f.rbt_kicker_width / 2) * 1.5  # outside 1x, inside 4x
    bx = rx + lx * jnp.cos(th) - ly * jnp.sin(th)
    by = ry + lx * jnp.sin(th) + ly * jnp.cos(th)
    w = s.world
    w = w._replace(ball=w.ball._replace(x=bx, y=by))
    assert bool(env4._widened_catch(w))
    # the same geometry at scale 1.0001-ish must reject: rebuild with
    # near-reference scale to confirm the window actually narrows
    env1p = rsoccer_tpu.make("SSLPassEndurance-v0", catch_scale=1.0001)
    assert not bool(env1p._widened_catch(w))
