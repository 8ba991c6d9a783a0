"""VSS differential-drive world step.

JAX replacement for the dynamics the reference gets from
``robosim.VSS.step`` (Simulators/rsim.py:91-102: a dense ``(n, 2)`` buffer of
``[v_wheel0, v_wheel1]`` targets in rad/s, blues first then yellows).

Drive model: commanded wheel speeds map to a target forward/angular velocity
via the differential-drive kinematics; the body tracks the target under
acceleration clamps (motor torque limit) while lateral slip decays
exponentially (wheel side friction).  The half-axle length is 0.04 m — the
same constant the reference uses to derive ``max_w``
(vss/vss_gym_base.py:57-58: "0.04 = robot radius (0.0375) + wheel thickness
(0.0025)").

The whole step is branch-free jnp on (N,) leaves; envs vmap it over a
trailing batch axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from rsoccer_tpu.core.field import FieldParams
from rsoccer_tpu.core.state import BallState, RobotsState, VSSCommands, WorldState
from rsoccer_tpu.physics import common
from rsoccer_tpu.physics.config import PhysicsConfig

HALF_AXLE = 0.04  # m — reference vss/vss_gym_base.py:57-58


def make_vss_step(field: FieldParams, cfg: PhysicsConfig, dt: float):
    """Build ``step(world, commands) -> world`` with all constants folded."""

    dts = dt / cfg.n_substeps
    # jnp.exp so coefficients may be traced values (the calibration harness
    # differentiates the step w.r.t. the PhysicsConfig entries); with plain
    # floats XLA constant-folds it anyway
    lat_keep = jnp.exp(-cfg.lateral_decay * dts)
    max_wheel = field.max_wheel_rad_s
    wheel_r = field.rbt_wheel_radius
    a_lin = cfg.robot_accel * dts
    a_ang = cfg.robot_alpha * dts

    def substep(world: WorldState, targets) -> WorldState:
        v_tgt, w_tgt = targets
        rb = world.robots
        ball = world.ball

        # --- robot drive: track (forward, angular) targets under accel clamp
        cos_t = jnp.cos(rb.theta)
        sin_t = jnp.sin(rb.theta)
        u = rb.v_x * cos_t + rb.v_y * sin_t  # forward speed
        s = -rb.v_x * sin_t + rb.v_y * cos_t  # lateral slip
        u = u + jnp.clip(v_tgt - u, -a_lin, a_lin)
        s = s * lat_keep
        w = rb.v_theta + jnp.clip(w_tgt - rb.v_theta, -a_ang, a_ang)

        theta = common.wrap_angle(rb.theta + w * dts)
        cos_n = jnp.cos(theta)
        sin_n = jnp.sin(theta)
        v_x = u * cos_n - s * sin_n
        v_y = u * sin_n + s * cos_n
        x = rb.x + v_x * dts
        y = rb.y + v_y * dts

        # --- collisions
        x, y, v_x, v_y = common.resolve_robot_robot(
            x, y, v_x, v_y, field.rbt_radius, cfg.rest_robot_robot
        )
        x, y, v_x, v_y = common.clamp_robots_walls_vss(
            x, y, v_x, v_y, field.half_length, field.half_width, field.rbt_radius
        )

        # --- ball.  Rolling friction only while grounded; the vertical axis
        # (reference Entities/Frame.py:21 carries ball z) is inert for a VSS
        # ball resting at z = ball_radius but kept for state-contract parity.
        on_ground = common.ball_on_ground(ball.z, field.ball_radius)
        fvx, fvy = common.apply_ball_friction(
            ball.v_x, ball.v_y, cfg.ball_friction_decel, dts
        )
        bvx = jnp.where(on_ground, fvx, ball.v_x)
        bvy = jnp.where(on_ground, fvy, ball.v_y)
        bz, bvz = common.step_ball_vertical(
            ball.z, ball.v_z, field.ball_radius,
            cfg.gravity, cfg.rest_ball_ground, cfg.ball_bounce_min_v, dts,
        )
        bx = ball.x + bvx * dts
        by = ball.y + bvy * dts
        below_top = (bz - field.ball_radius) < cfg.rbt_height
        bx, by, bvx, bvy = common.resolve_ball_robots(
            bx, by, bvx, bvy, x, y, v_x, v_y,
            field.rbt_radius, field.ball_radius, cfg.rest_ball_robot,
            active=below_top,
        )
        bx, by, bvx, bvy = common.reflect_ball_walls_vss(
            bx, by, bvx, bvy,
            field.half_length, field.half_width,
            field.goal_width / 2, field.goal_depth,
            field.ball_radius, cfg.rest_ball_wall,
        )

        return WorldState(
            ball=BallState(x=bx, y=by, z=bz, v_x=bvx, v_y=bvy, v_z=bvz),
            robots=RobotsState(
                x=x, y=y, theta=theta, v_x=v_x, v_y=v_y, v_theta=w,
                infrared=rb.infrared, v_wheel=rb.v_wheel,
            ),
        )

    def step(world: WorldState, commands: VSSCommands) -> WorldState:
        wl = jnp.clip(commands.v_wheel0, -max_wheel, max_wheel)
        wr = jnp.clip(commands.v_wheel1, -max_wheel, max_wheel)
        v_tgt = wheel_r * (wl + wr) / 2.0
        w_tgt = wheel_r * (wr - wl) / (2.0 * HALF_AXLE)
        for _ in range(cfg.n_substeps):
            world = substep(world, (v_tgt, w_tgt))
        # report achieved wheel speeds (forward kinematics of actual body vel)
        rb = world.robots
        u = rb.v_x * jnp.cos(rb.theta) + rb.v_y * jnp.sin(rb.theta)
        w0 = (u - rb.v_theta * HALF_AXLE) / wheel_r
        w1 = (u + rb.v_theta * HALF_AXLE) / wheel_r
        v_wheel = jnp.stack(
            [w0, w1, jnp.zeros_like(w0), jnp.zeros_like(w0)], axis=-1
        )
        return world._replace(robots=rb._replace(v_wheel=v_wheel))

    return step
