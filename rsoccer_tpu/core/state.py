"""World-state pytrees (struct-of-arrays).

The reference keeps world state as Python object graphs — a ``Frame`` holding
a ``Ball`` and ``Dict[int, Robot]`` per team, rebuilt from a flat float vector
every step (reference Entities/Frame.py:18-93).  Here the state is a pytree of
arrays so the whole step stays on-chip and vmaps over the env batch.

Single-env leaf shapes: ball fields are scalars, robot fields are ``(N,)``
where ``N = n_blue + n_yellow`` (blues first, then yellows — the same ordering
as the reference's flat state vector, Entities/Frame.py:28-49).  Batched code
maps every leaf over a trailing batch axis ("batch-last"), which makes the env
index the contiguous axis of every per-entity array.

Units: meters, m/s, radians, rad/s — radians *internally*; the reference's
degree convention (Entities/Frame.py:8) is honoured only at the API edge
(``rsoccer_tpu.core.frame``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class BallState(NamedTuple):
    """Ball pose/velocity incl. the vertical axis.

    The reference's state vector carries ball z (Entities/Frame.py:21 parses
    ``ball.z`` for both leagues) and SSL commands carry a vertical kick
    component (Simulators/rsim.py:147).  ``z`` is the ball CENTER height —
    the ODE sphere-on-plane convention of the rSim engine — so its rest
    value is ``ball_radius``, not 0.
    """

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray  # center height, m; rest = ball_radius
    v_x: jnp.ndarray
    v_y: jnp.ndarray
    v_z: jnp.ndarray


class RobotsState(NamedTuple):
    """All robots of a world, blues first then yellows. Leaves are (N,)."""

    x: jnp.ndarray
    y: jnp.ndarray
    theta: jnp.ndarray  # radians, unwrapped to [-pi, pi)
    v_x: jnp.ndarray  # world-frame m/s
    v_y: jnp.ndarray
    v_theta: jnp.ndarray  # rad/s
    # SSL-only actuator/sensor channels; zero-filled for VSS worlds so the
    # pytree structure is uniform across leagues.
    infrared: jnp.ndarray  # bool — ball touching kicker face
    v_wheel: jnp.ndarray  # (N, 4) achieved wheel speeds rad/s


class WorldState(NamedTuple):
    ball: BallState
    robots: RobotsState


def make_world(
    n_robots: int, dtype=jnp.float32, ball_radius: float = 0.0215
) -> WorldState:
    """A zero-initialised single-env world with ``n_robots`` total robots.

    The ball rests on the ground: ``z = ball_radius`` (center height).
    """
    z = jnp.zeros((), dtype)
    zn = jnp.zeros((n_robots,), dtype)
    return WorldState(
        ball=BallState(
            x=z, y=z, z=jnp.asarray(ball_radius, dtype), v_x=z, v_y=z, v_z=z
        ),
        robots=RobotsState(
            x=zn,
            y=zn,
            theta=zn,
            v_x=zn,
            v_y=zn,
            v_theta=zn,
            infrared=jnp.zeros((n_robots,), jnp.bool_),
            v_wheel=jnp.zeros((n_robots, 4), dtype),
        ),
    )


class VSSCommands(NamedTuple):
    """Per-robot VSS wheel-speed targets, rad/s.

    Mirrors the dense ``(n, 2)`` command buffer the reference marshals into
    the simulator (Simulators/rsim.py:91-102).
    """

    v_wheel0: jnp.ndarray  # (N,) left wheel rad/s
    v_wheel1: jnp.ndarray  # (N,) right wheel rad/s


class SSLCommands(NamedTuple):
    """Per-robot SSL commands.

    Mirrors the reference's 8-slot command layout whose meaning switches on
    the ``wheel_speed`` flag (Simulators/rsim.py:128-155): either four wheel
    speed targets or a local-frame (v_x, v_y, v_theta) velocity target, plus
    kicker and dribbler channels in both modes.
    """

    wheel_speed: jnp.ndarray  # (N,) bool — True: wheel targets, False: velocity
    v_wheel: jnp.ndarray  # (N, 4) rad/s targets (wheel_speed mode)
    v_x: jnp.ndarray  # (N,) local-frame m/s (velocity mode)
    v_y: jnp.ndarray  # (N,)
    v_theta: jnp.ndarray  # (N,) rad/s
    kick_v_x: jnp.ndarray  # (N,) m/s kick speed along heading (<=0: no kick)
    kick_v_z: jnp.ndarray  # (N,) m/s vertical kick speed (chip kick)
    dribbler: jnp.ndarray  # (N,) bool


def zero_ssl_commands(n_robots: int, dtype=jnp.float32) -> SSLCommands:
    zn = jnp.zeros((n_robots,), dtype)
    return SSLCommands(
        wheel_speed=jnp.zeros((n_robots,), jnp.bool_),
        v_wheel=jnp.zeros((n_robots, 4), dtype),
        v_x=zn,
        v_y=zn,
        v_theta=zn,
        kick_v_x=zn,
        kick_v_z=zn,
        dribbler=jnp.zeros((n_robots,), jnp.bool_),
    )
