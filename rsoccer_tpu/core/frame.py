"""Host-side frame views — the reference's degree-based data model.

Drop-in equivalents of the reference's entity dataclasses (Entities/Ball.py,
Entities/Robot.py, Entities/Frame.py): plain Python objects in the reference's
units (meters, m/s, DEGREES, deg/s — Frame.py:8) built from a device-side
``WorldState``.  Used by the Gymnasium-compat wrapper and the renderer; the
batched hot path never touches these.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np


@dataclass
class Ball:
    """Reference Entities/Ball.py:3-10."""

    x: float = None
    y: float = None
    z: float = None
    v_x: float = 0.0
    v_y: float = 0.0
    v_z: float = 0.0


@dataclass
class Robot:
    """Reference Entities/Robot.py:4-23 — state and command in one type."""

    yellow: bool = None
    id: int = None
    x: float = None
    y: float = None
    z: float = None
    theta: float = None  # degrees
    v_x: float = 0.0
    v_y: float = 0.0
    v_theta: float = 0.0  # deg/s
    kick_v_x: float = 0.0
    kick_v_z: float = 0.0
    dribbler: bool = False
    infrared: bool = False
    wheel_speed: bool = False
    v_wheel0: float = 0.0  # rad/s
    v_wheel1: float = 0.0
    v_wheel2: float = 0.0
    v_wheel3: float = 0.0


@dataclass
class Frame:
    """Reference Entities/Frame.py:7-14."""

    ball: Ball = field(default_factory=Ball)
    robots_blue: Dict[int, Robot] = field(default_factory=dict)
    robots_yellow: Dict[int, Robot] = field(default_factory=dict)


def frame_from_world(world, n_blue: int, n_yellow: int) -> Frame:
    """Build a degree-based host Frame from a (single-env) WorldState.

    Equivalent role to FrameVSS/FrameSSL.parse (Entities/Frame.py:18-93),
    reading the struct-of-arrays state instead of a flat float vector.
    """
    b = world.ball
    frame = Frame(
        ball=Ball(
            x=float(b.x), y=float(b.y), z=float(b.z),
            v_x=float(b.v_x), v_y=float(b.v_y), v_z=float(b.v_z),
        )
    )
    rb = world.robots
    x = np.asarray(rb.x)
    y = np.asarray(rb.y)
    theta = np.degrees(np.asarray(rb.theta)) % 360.0
    v_x = np.asarray(rb.v_x)
    v_y = np.asarray(rb.v_y)
    v_theta = np.degrees(np.asarray(rb.v_theta))
    infrared = np.asarray(rb.infrared)
    v_wheel = np.asarray(rb.v_wheel)

    def mk(i, yellow, rid):
        return Robot(
            yellow=yellow, id=rid,
            x=float(x[i]), y=float(y[i]), z=0.0, theta=float(theta[i]),
            v_x=float(v_x[i]), v_y=float(v_y[i]), v_theta=float(v_theta[i]),
            infrared=bool(infrared[i]),
            v_wheel0=float(v_wheel[i, 0]), v_wheel1=float(v_wheel[i, 1]),
            v_wheel2=float(v_wheel[i, 2]), v_wheel3=float(v_wheel[i, 3]),
        )

    for i in range(n_blue):
        frame.robots_blue[i] = mk(i, False, i)
    for j in range(n_yellow):
        frame.robots_yellow[j] = mk(n_blue + j, True, j)
    return frame


def frame_from_batched(world, env_index: int, n_blue: int, n_yellow: int) -> Frame:
    """Frame view of env ``env_index`` of a lane-layout batched WorldState
    (every leaf carries a trailing batch axis)."""
    import jax

    single = jax.tree.map(lambda leaf: leaf[..., env_index], world)
    return frame_from_world(single, n_blue, n_yellow)
