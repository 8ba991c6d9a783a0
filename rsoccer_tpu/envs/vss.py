"""VSS-v0: 3v3 differential-drive match, agent controls blue robot 0.

Task-for-task port of the reference's behavioral spec (vss/env_vss/
vss_gym.py) re-expressed as pure branch-free functions:

  - Obs Box(40): ball [x,y,vx,vy] + 3 blues x [x,y,sin,cos,vx,vy,vtheta] +
    3 yellows x [x,y,vx,vy,vtheta], all normalised and clipped to +-1.2
    (vss_gym.py:93-117, norms at vss_gym_base.py:213-220).
  - Action Box(2): wheel-speed fractions; scaled by max_v, clipped, 0.05 m/s
    deadzone, divided by wheel radius (vss_gym.py:235-254).
  - Other 5 robots driven by Ornstein-Uhlenbeck noise (vss_gym.py:127-140).
  - Reward: goal +-10 terminal, else 0.2*move + 0.8*ball_grad + 2e-4*energy
    (vss_gym.py:144-192); potential/move/energy formulas at
    vss_gym.py:256-311.
  - Reset: uniform spawns with 0.1 m separation (vss_gym.py:194-233).
  - 1200-step TimeLimit (rsoccer_gym/__init__.py:4).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from rsoccer_tpu.core.field import vss_field
from rsoccer_tpu.core.state import BallState, RobotsState, VSSCommands, WorldState
from rsoccer_tpu.envs import ou, spawn
from rsoccer_tpu.envs.base import Env
from rsoccer_tpu.physics.config import VSS_PHYSICS
from rsoccer_tpu.physics.vss import HALF_AXLE, make_vss_step

_SHAPING_KEYS = (
    "goal_score",
    "move",
    "ball_grad",
    "energy",
    "goals_blue",
    "goals_yellow",
)


class VSSState(NamedTuple):
    world: WorldState
    steps: jnp.ndarray  # int32
    ou_x: jnp.ndarray  # (6, 2) OU process state, index 0 unused (agent)
    ball_potential: jnp.ndarray  # f32 — previous potential
    has_potential: jnp.ndarray  # bool — False right after reset (None in ref)
    shaping: jnp.ndarray  # (6,) accumulators, order _SHAPING_KEYS


class VSSEnv(Env):
    """VSS-v0 (reference vss/env_vss/vss_gym.py:13-311)."""

    obs_size = 40
    action_size = 2
    max_episode_steps = 1200  # reference rsoccer_gym/__init__.py:4
    league = "vss"

    def __init__(
        self,
        field_type: int = 0,
        n_robots_blue: int = 3,
        n_robots_yellow: int = 3,
        time_step: float = 0.025,
    ):
        self.field = vss_field(field_type)
        self.n_blue = n_robots_blue
        self.n_yellow = n_robots_yellow
        self.n_robots = n_robots_blue + n_robots_yellow
        self.time_step = time_step
        self.obs_size = 4 + 7 * n_robots_blue + 5 * n_robots_yellow

        f = self.field
        # derived normalisation constants (reference vss_gym_base.py:52-58)
        self.max_pos = f.max_pos
        self.max_v = f.max_v
        self.max_w_rad = self.max_v / HALF_AXLE  # rad/s (ref stores deg/s)
        self.norm_bounds = 1.2  # reference vss_gym_base.py:26
        self.v_wheel_deadzone = 0.05  # reference vss_gym.py:73

        self.physics_cfg = VSS_PHYSICS
        self._physics = make_vss_step(f, VSS_PHYSICS, time_step)

    # ------------------------------------------------------------------ obs
    def _norm_pos(self, v):
        return jnp.clip(v / self.max_pos, -self.norm_bounds, self.norm_bounds)

    def _norm_v(self, v):
        return jnp.clip(v / self.max_v, -self.norm_bounds, self.norm_bounds)

    def _norm_w(self, w):
        return jnp.clip(w / self.max_w_rad, -self.norm_bounds, self.norm_bounds)

    def _observe(self, world: WorldState) -> jnp.ndarray:
        """Reference obs layout vss_gym.py:93-117."""
        b = world.ball
        rb = world.robots
        nb = self.n_blue
        blue = jnp.stack(
            [
                self._norm_pos(rb.x[:nb]),
                self._norm_pos(rb.y[:nb]),
                jnp.sin(rb.theta[:nb]),
                jnp.cos(rb.theta[:nb]),
                self._norm_v(rb.v_x[:nb]),
                self._norm_v(rb.v_y[:nb]),
                self._norm_w(rb.v_theta[:nb]),
            ],
            axis=-1,
        )  # (nb, 7)
        yellow = jnp.stack(
            [
                self._norm_pos(rb.x[nb:]),
                self._norm_pos(rb.y[nb:]),
                self._norm_v(rb.v_x[nb:]),
                self._norm_v(rb.v_y[nb:]),
                self._norm_w(rb.v_theta[nb:]),
            ],
            axis=-1,
        )  # (ny, 5)
        head = jnp.stack(
            [
                self._norm_pos(b.x),
                self._norm_pos(b.y),
                self._norm_v(b.v_x),
                self._norm_v(b.v_y),
            ]
        )
        return jnp.concatenate(
            [head, blue.reshape(-1), yellow.reshape(-1)]
        ).astype(jnp.float32)

    # -------------------------------------------------------------- actions
    def _actions_to_wheels(self, actions):
        """Reference vss_gym.py:235-254. actions (..., 2) fractions ->
        (left, right) wheel rad/s."""
        v = jnp.clip(actions * self.max_v, -self.max_v, self.max_v)
        dead = jnp.abs(v) < self.v_wheel_deadzone
        v = jnp.where(dead, 0.0, v)
        w = v / self.field.rbt_wheel_radius
        return w[..., 0], w[..., 1]

    def observe(self, state) -> jnp.ndarray:
        return self._observe(state.world)

    # ---------------------------------------------------------------- noise
    def transition_noise_spec(self):
        return {"ou": ((self.n_robots, 2), "normal")}

    def reset_noise_spec(self):
        return {
            "spawn": ((1 + self.n_robots, 2, spawn.N_CANDIDATES), "uniform"),
            "theta": ((self.n_robots,), "uniform"),
        }

    # ---------------------------------------------------------------- reset
    def reset_state(self, noise):
        f = self.field
        xs, ys = spawn.place_separated(
            noise["spawn"],
            x_lo=-f.half_length + 0.1,
            x_hi=f.half_length - 0.1,
            y_lo=-f.half_width + 0.1,
            y_hi=f.half_width - 0.1,
            min_dist=0.1,  # reference vss_gym.py:212
        )
        thetas = spawn.angles_from_uniform(noise["theta"])
        zn = jnp.zeros((self.n_robots,))
        world = WorldState(
            ball=BallState(
                x=xs[0], y=ys[0], z=jnp.asarray(f.ball_radius),
                v_x=jnp.zeros(()), v_y=jnp.zeros(()), v_z=jnp.zeros(()),
            ),
            robots=RobotsState(
                x=xs[1:],
                y=ys[1:],
                theta=thetas,
                v_x=zn,
                v_y=zn,
                v_theta=zn,
                infrared=jnp.zeros((self.n_robots,), bool),
                v_wheel=jnp.zeros((self.n_robots, 4)),
            ),
        )
        state = VSSState(
            world=world,
            steps=jnp.zeros((), jnp.int32),
            ou_x=ou.ou_reset((self.n_robots, 2)),
            ball_potential=jnp.zeros(()),
            has_potential=jnp.zeros((), bool),
            shaping=jnp.zeros((len(_SHAPING_KEYS),)),
        )
        return state

    # ----------------------------------------------------------------- step
    def pre_physics(self, state: VSSState, action, noise):
        """Commands from state+action+noise (reference vss_gym.py:119-142;
        OU index 0 exists but is never sampled for the agent).  Split out so
        the multi-agent and self-play variants override only the command
        conversion."""
        ou_x = ou.ou_update(state.ou_x, noise["ou"], self.time_step)
        all_actions = ou_x.at[0].set(action)
        wl, wr = self._actions_to_wheels(all_actions)
        commands = VSSCommands(v_wheel0=wl, v_wheel1=wr)
        return commands, (ou_x, wl, wr)

    def transition(self, state: VSSState, action, noise):
        commands, aux = self.pre_physics(state, action, noise)
        world = self._physics(state.world, commands)
        return self.post_physics(state, world, aux)

    def post_physics(self, state: VSSState, world, aux):
        f = self.field
        ou_x, wl, wr = aux

        # --- reward & done (reference vss_gym.py:144-192)
        b = world.ball
        goal_blue = b.x > f.half_length
        goal_yellow = b.x < -f.half_length
        goal = goal_blue | goal_yellow

        # ball potential (reference vss_gym.py:256-283)
        half_l = f.half_length + f.goal_depth
        dx_d = (half_l + b.x) * 100.0
        dx_a = (half_l - b.x) * 100.0
        dy = b.y * 100.0
        dist_1 = -jnp.sqrt(dx_a * dx_a + 2.0 * dy * dy)
        dist_2 = jnp.sqrt(dx_d * dx_d + 2.0 * dy * dy)
        potential = ((dist_1 + dist_2) / (f.length * 100.0) - 1.0) / 2.0
        grad = jnp.where(
            state.has_potential,
            jnp.clip(
                (potential - state.ball_potential) * 3.0 / self.time_step, -5.0, 5.0
            ),
            0.0,
        )

        # move-to-ball (reference vss_gym.py:285-303)
        r0x, r0y = world.robots.x[0], world.robots.y[0]
        rbx, rby = b.x - r0x, b.y - r0y
        rb_norm = jnp.sqrt(rbx * rbx + rby * rby)
        rbx, rby = rbx / jnp.maximum(rb_norm, 1e-8), rby / jnp.maximum(rb_norm, 1e-8)
        move = rbx * world.robots.v_x[0] + rby * world.robots.v_y[0]
        move = jnp.clip(move / 0.4, -5.0, 5.0)

        # energy penalty on the agent's *sent* wheel commands in rad/s
        # (reference vss_gym.py:305-311)
        energy = -(jnp.abs(wl[0]) + jnp.abs(wr[0]))

        w_move, w_grad, w_energy = 0.2, 0.8, 2e-4  # vss_gym.py:147-149
        shaped = w_move * move + w_grad * grad + w_energy * energy
        reward = jnp.where(goal_blue, 10.0, jnp.where(goal_yellow, -10.0, shaped))

        shaping = state.shaping + jnp.where(
            goal,
            jnp.stack(
                [
                    jnp.where(goal_blue, 1.0, -1.0),  # goal_score
                    0.0,
                    0.0,
                    0.0,
                    jnp.where(goal_blue, 1.0, 0.0),  # goals_blue
                    jnp.where(goal_yellow, 1.0, 0.0),  # goals_yellow
                ]
            ),
            jnp.stack(
                [
                    jnp.zeros(()),
                    w_move * move,
                    w_grad * grad,
                    w_energy * energy,
                    jnp.zeros(()),
                    jnp.zeros(()),
                ]
            ),
        )

        ns = VSSState(
            world=world,
            steps=state.steps + 1,
            ou_x=ou_x,
            # on a goal step the reference never recomputes the potential;
            # the episode ends so the value is irrelevant — keep it simple
            # and always store the fresh one.
            ball_potential=potential,
            has_potential=jnp.ones((), bool),
            shaping=shaping,
        )
        info = {k: shaping[i] for i, k in enumerate(_SHAPING_KEYS)}
        return ns, reward, goal, info
