"""SSL omnidirectional world step: 4-omni drive, kicker, dribbler, infrared.

JAX replacement for the dynamics the reference gets from
``robosim.SSL.step``.  The binding contract matches Simulators/rsim.py:128-155
exactly: per-robot commands are either four wheel-speed targets (rad/s) or a
local-frame velocity target, selected by the ``wheel_speed`` flag, plus
``kick_v_x``/``kick_v_z``/``dribbler`` channels; the reported state adds the
infrared ball-contact bit and achieved wheel speeds (Entities/Frame.py:52-93).

Drive model: the local-frame velocity target (from either command mode) is
tracked under acceleration clamps.  Wheel-speed commands map to a body
velocity via the least-squares inverse of the wheel jacobian (the standard
omni-drive kinematics for the mount angles in FieldParams); achieved wheel
speeds are reported through the forward jacobian.

Kicker: when the ball touches the kicker face (infrared) and ``kick_v_x > 0``
the ball's velocity along the robot heading is set to ``kick_v_x``; a
``kick_v_z > 0`` additionally launches the ball vertically (chip kick,
Simulators/rsim.py:147).  A chipped ball follows ballistic flight with
floor bounces (physics/common.step_ball_vertical) and passes over robots
while above ``rbt_height``; kicker contact itself requires the ball low
enough for the kicker plate (``kicker_height``).

Dribbler: a spring-damper pull toward the kicker face while in the capture
zone — ball remains stealable by impulse, matching the contested-possession
task's premise.

SSL fields have no physical walls in play (episodes end on out-of-bounds in
every reference SSL task before walls could matter), so the ball and robots
move freely beyond the lines.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from rsoccer_tpu.core.field import FieldParams
from rsoccer_tpu.core.state import BallState, RobotsState, SSLCommands, WorldState
from rsoccer_tpu.physics import common
from rsoccer_tpu.physics.config import PhysicsConfig


def wheel_jacobian(field: FieldParams):
    """(4, 3) map from local (vx, vy, w) to wheel surface speeds (m/s).

    Wheel i mounted at angle phi_i from the heading, rolling along the
    tangent direction: surface speed = -sin(phi)*vx + cos(phi)*vy + R*w.
    """
    phis = [
        math.radians(field.rbt_wheel0_angle),
        math.radians(field.rbt_wheel1_angle),
        math.radians(field.rbt_wheel2_angle),
        math.radians(field.rbt_wheel3_angle),
    ]
    rows = [[-math.sin(p), math.cos(p), field.rbt_radius] for p in phis]
    import numpy as np

    return np.asarray(rows, dtype=np.float32)


def make_ssl_step(field: FieldParams, cfg: PhysicsConfig, dt: float):
    """Build ``step(world, commands) -> world`` with all constants folded."""
    import numpy as np

    dts = dt / cfg.n_substeps
    a_lin = cfg.robot_accel * dts
    a_ang = cfg.robot_alpha * dts
    max_wheel = field.max_wheel_rad_s
    wheel_r = field.rbt_wheel_radius

    J = wheel_jacobian(field)  # (4,3) local vel -> wheel m/s
    J_pinv = np.linalg.pinv(J)  # (3,4) wheel m/s -> local vel (least squares)

    # kicker face geometry
    face_dist = field.rbt_distance_center_kicker  # center -> face
    half_kick_w = field.rbt_kicker_width / 2
    contact_lo = face_dist - field.rbt_kicker_thickness - field.ball_radius
    contact_hi = face_dist + field.ball_radius + cfg.kicker_depth_slack

    def local_targets(commands: SSLCommands):
        """Resolve the 8-slot command contract into local velocity targets
        (reference slot semantics: Simulators/rsim.py:137-153)."""
        vw = jnp.clip(commands.v_wheel, -max_wheel, max_wheel)  # (N,4)
        wheel_ms = vw * wheel_r  # wheel surface speeds
        from_wheels = wheel_ms @ J_pinv.T  # (N,3) local (vx, vy, w)
        direct = jnp.stack([commands.v_x, commands.v_y, commands.v_theta], -1)
        return jnp.where(commands.wheel_speed[:, None], from_wheels, direct)

    def _face_zone(rb_x, rb_y, rb_theta, bx, by, bz, hi):
        cos_t = jnp.cos(rb_theta)
        sin_t = jnp.sin(rb_theta)
        dx = bx - rb_x
        dy = by - rb_y
        lx = dx * cos_t + dy * sin_t  # along heading
        ly = -dx * sin_t + dy * cos_t  # lateral
        low = (bz - field.ball_radius) <= cfg.kicker_height
        return (
            (lx >= contact_lo)
            & (lx <= hi)
            & (jnp.abs(ly) <= half_kick_w)
            & low
        )

    def ball_contact(rb_x, rb_y, rb_theta, bx, by, bz):
        """Infrared predicate: ball center inside the kicker face zone and
        low enough for the kicker plate (a chipped ball in flight does not
        trigger infrared)."""
        return _face_zone(rb_x, rb_y, rb_theta, bx, by, bz, contact_hi)

    def ball_in_reach(rb_x, rb_y, rb_theta, bx, by, bz):
        """Dribbler attraction zone: extends ``dribbler_reach`` beyond the
        kicker contact zone — the spinning bar pulls a nearby ball in (a
        received pass settles a few mm past the collision shell; without
        reach it would rest outside both spring and infrared)."""
        return _face_zone(
            rb_x, rb_y, rb_theta, bx, by, bz, contact_hi + cfg.dribbler_reach
        )

    def substep(world: WorldState, tgt, commands: SSLCommands) -> WorldState:
        rb = world.robots
        ball = world.ball
        cos_t = jnp.cos(rb.theta)
        sin_t = jnp.sin(rb.theta)

        # --- drive: track local-frame target under accel clamps
        u = rb.v_x * cos_t + rb.v_y * sin_t
        s = -rb.v_x * sin_t + rb.v_y * cos_t
        u = u + jnp.clip(tgt[:, 0] - u, -a_lin, a_lin)
        s = s + jnp.clip(tgt[:, 1] - s, -a_lin, a_lin)
        w = rb.v_theta + jnp.clip(tgt[:, 2] - rb.v_theta, -a_ang, a_ang)

        theta = common.wrap_angle(rb.theta + w * dts)
        cos_n = jnp.cos(theta)
        sin_n = jnp.sin(theta)
        v_x = u * cos_n - s * sin_n
        v_y = u * sin_n + s * cos_n
        x = rb.x + v_x * dts
        y = rb.y + v_y * dts

        x, y, v_x, v_y = common.resolve_robot_robot(
            x, y, v_x, v_y, field.rbt_radius, cfg.rest_robot_robot
        )

        # --- ball: friction (grounded only), dribbler pull, integrate,
        # collide, kick.  Vertical axis: gravity + floor bounce.
        on_ground = common.ball_on_ground(ball.z, field.ball_radius)
        fvx, fvy = common.apply_ball_friction(
            ball.v_x, ball.v_y, cfg.ball_friction_decel, dts
        )
        bvx = jnp.where(on_ground, fvx, ball.v_x)
        bvy = jnp.where(on_ground, fvy, ball.v_y)

        contact = ball_in_reach(x, y, theta, ball.x, ball.y, ball.z)
        held = contact & commands.dribbler
        # spring-damper toward each holding robot's face point (at most one
        # robot can satisfy the contact predicate for a single ball in
        # practice; contributions sum).  The damping is relative to the
        # FACE POINT's velocity — including the omega x r term from body
        # rotation — so a turning robot carries the ball around with it
        # (the physical dribbler grips the ball against the face; both
        # hardware-challenge tasks presume turn-while-carrying).
        face_x = x + face_dist * cos_n
        face_y = y + face_dist * sin_n
        face_vx = v_x - w * face_dist * sin_n
        face_vy = v_y + w * face_dist * cos_n
        rel_vx = bvx - face_vx
        rel_vy = bvy - face_vy
        rel_speed = jnp.sqrt(rel_vx**2 + rel_vy**2)
        can_hold = held & (rel_speed < cfg.dribbler_capture_speed)
        pull_x = jnp.sum(
            jnp.where(
                can_hold,
                cfg.dribbler_pull_accel * (face_x - ball.x)
                - cfg.dribbler_damping * rel_vx,
                0.0,
            )
        )
        pull_y = jnp.sum(
            jnp.where(
                can_hold,
                cfg.dribbler_pull_accel * (face_y - ball.y)
                - cfg.dribbler_damping * rel_vy,
                0.0,
            )
        )
        bvx = bvx + pull_x * dts
        bvy = bvy + pull_y * dts

        bz, bvz = common.step_ball_vertical(
            ball.z, ball.v_z, field.ball_radius,
            cfg.gravity, cfg.rest_ball_ground, cfg.ball_bounce_min_v, dts,
        )
        bx = ball.x + bvx * dts
        by = ball.y + bvy * dts
        below_top = (bz - field.ball_radius) < cfg.rbt_height
        # a ball striking the kicker-face sector of a dribbling robot is
        # absorbed by the bar (rest_dribbler) instead of bouncing off the
        # body shell — evaluated at the pre-resolve ball position
        face_in = ball_contact(x, y, theta, bx, by, bz)
        rest = jnp.where(
            face_in & commands.dribbler, cfg.rest_dribbler, cfg.rest_ball_robot
        )
        bx, by, bvx, bvy = common.resolve_ball_robots(
            bx, by, bvx, bvy, x, y, v_x, v_y,
            field.rbt_radius, field.ball_radius, rest,
            active=below_top,
        )

        # kick: replace the heading-aligned velocity component; a positive
        # kick_v_z launches the ball vertically (chip kick, rsim.py:147)
        contact_after = ball_contact(x, y, theta, bx, by, bz)
        kicking = contact_after & (commands.kick_v_x > 0.0)
        kvx = jnp.sum(jnp.where(kicking, commands.kick_v_x * cos_n, 0.0))
        kvy = jnp.sum(jnp.where(kicking, commands.kick_v_x * sin_n, 0.0))
        kvz = jnp.sum(jnp.where(kicking, commands.kick_v_z, 0.0))
        any_kick = jnp.any(kicking)
        bvx = jnp.where(any_kick, kvx, bvx)
        bvy = jnp.where(any_kick, kvy, bvy)
        bvz = jnp.where(any_kick & (kvz > 0.0), kvz, bvz)

        return WorldState(
            ball=BallState(x=bx, y=by, z=bz, v_x=bvx, v_y=bvy, v_z=bvz),
            robots=RobotsState(
                x=x, y=y, theta=theta, v_x=v_x, v_y=v_y, v_theta=w,
                infrared=contact_after, v_wheel=rb.v_wheel,
            ),
        )

    def step(world: WorldState, commands: SSLCommands) -> WorldState:
        tgt = local_targets(commands)
        for _ in range(cfg.n_substeps):
            world = substep(world, tgt, commands)
        # achieved wheel speeds via forward jacobian of the actual body vel
        rb = world.robots
        cos_t = jnp.cos(rb.theta)
        sin_t = jnp.sin(rb.theta)
        u = rb.v_x * cos_t + rb.v_y * sin_t
        s = -rb.v_x * sin_t + rb.v_y * cos_t
        local = jnp.stack([u, s, rb.v_theta], -1)  # (N,3)
        v_wheel = (local @ J.T) / wheel_r  # (N,4) rad/s
        return world._replace(robots=rb._replace(v_wheel=v_wheel))

    return step
