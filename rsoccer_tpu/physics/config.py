"""Physics coefficients.

The reference delegates dynamics to the out-of-repo C++ rSim engine (ODE
rigid-body sim, bound at Simulators/rsim.py:2); its friction/restitution/motor
constants live in that engine's source.  This module is the *specification* of
our JAX 2D dynamics: a documented, tunable coefficient set.  The
binding contract (command layouts, state layout, units, field params) matches
the reference exactly; the integrator is our own design — fixed-substep
semi-implicit Euler with impulse-based circle collisions, written to be
branch-free and fused by XLA.

All values are plain Python floats, closed over before ``jit`` so XLA
constant-folds them into the compiled step.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    # integration
    n_substeps: int = 5  # substeps per control step (dt/n each)

    # robot drive response (first-order velocity tracking with accel clamps)
    robot_accel: float = 5.0  # m/s^2 — max linear accel toward target
    robot_alpha: float = 100.0  # rad/s^2 — max angular accel toward target
    lateral_decay: float = 40.0  # 1/s — diff-drive lateral slip decay (VSS)

    # ball
    ball_friction_decel: float = 0.5  # m/s^2 rolling deceleration
    ball_mass: float = 0.046
    robot_mass: float = 0.5

    # vertical axis (chip kicks / bounces).  The reference state carries
    # ball z (Entities/Frame.py:21) and SSL commands carry kick_v_z
    # (Simulators/rsim.py:147); rSim inherits grSim's ODE ball contact
    # parameters — gravity 9.8, BallBounce 0.5 and BallBounceVel 0.1 are
    # the grSim-lineage defaults (provenance table: docs/fidelity.md).
    gravity: float = 9.8  # m/s^2 — ODE world gravity in grSim/rSim
    rest_ball_ground: float = 0.5  # grSim BallBounce
    ball_bounce_min_v: float = 0.1  # grSim BallBounceVel — slower bounces settle
    rbt_height: float = 0.15  # m — ball passes over robots above this

    # restitution
    rest_ball_wall: float = 0.6
    rest_ball_robot: float = 0.5
    # A spinning dribbler bar absorbs an incoming ball instead of
    # reflecting it (the bar's backspin grips on contact — the mechanism
    # every SSL receiver relies on; grSim models it as an active contact
    # force).  Applied INSTEAD of rest_ball_robot when the ball strikes
    # the kicker-face sector of a robot whose dribbler is on.  At the
    # body restitution (0.5) a minimum-power 2.5 m/s pass rebounds at
    # ~1 m/s and escapes the 1 mm capture shell between substeps, making
    # SSLPassEndurance success luck-limited (measured: scripted aim-and-
    # kick 9%); at 0.1 the rebound is damped inside the shell and the
    # spring latches — receiving becomes deterministic physics.
    rest_dribbler: float = 0.1
    rest_robot_robot: float = 0.1

    # robots bounce off walls dead (clamped); ball uses rest_ball_wall
    # collision shape: robots approximated as discs of radius rbt_radius

    # SSL kicker/dribbler
    kicker_depth_slack: float = 0.01  # m — contact tolerance beyond kicker face
    kicker_height: float = 0.05  # m — max ball-bottom height for kicker contact
    # spring pull toward the kicker face.  Sized so a robot spinning at its
    # 10 rad/s command cap can carry the ball: the centripetal accel of the
    # face orbit is w^2 * r = 100 * 0.115 = 11.5 m/s^2, and the steady-state
    # spring lag 11.5 / 300 = 0.038 m stays inside the kicker face window
    # (half-width rbt_kicker_width/2).  Explicit-Euler stable at the 5 ms
    # substep (omega_n * dt = sqrt(300) * 0.005 = 0.09).
    dribbler_pull_accel: float = 300.0  # m/s^2
    dribbler_damping: float = 30.0  # 1/s — relative-velocity damping when held
    dribbler_capture_speed: float = 2.0  # m/s — max relative speed to hold
    # The spinning bar attracts a nearby ball from farther out than the
    # kicker-contact/infrared zone (which extends only kicker_depth_slack =
    # 1 mm past the ball-body collision shell).  Without this, a received
    # pass that comes to rest 1-6 mm beyond the shell (measured: every
    # near-miss in the scripted-pass study) sits outside both the spring's
    # reach and the infrared zone and the pass is lost.  Pull-only: the
    # infrared report and the kick trigger keep the tight zone.
    dribbler_reach: float = 0.03  # m beyond the kicker contact zone


VSS_PHYSICS = PhysicsConfig(
    robot_accel=6.0,
    robot_alpha=180.0,
    ball_friction_decel=0.6,
    robot_mass=0.25,
    rbt_height=0.075,  # VSS robots are 75 mm cubes
)

SSL_PHYSICS = PhysicsConfig(
    robot_accel=3.5,
    robot_alpha=50.0,
    ball_friction_decel=0.35,
    robot_mass=2.5,
    rbt_height=0.147,  # SSL rule-book max robot height
)
