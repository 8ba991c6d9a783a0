"""Spawn placement via fixed-shape masked rejection sampling.

The reference rejection-samples spawn positions with an unbounded Python
``while`` loop over a KD-tree nearest-neighbour query (vss/env_vss/
vss_gym.py:214-231, ssl_hw_challenge/static_defenders.py:243-252, KD-tree at
Utils/kdtree.py).  Under ``jit`` that becomes: draw a fixed block of K
candidates per entity, vectorise the min-distance test against all previously
placed entities, and take the first valid candidate.  With K=16 and the
reference's densities (<= 7 discs of separation 0.1-0.2 m on a field of
>= 1.3 m^2) the probability that no candidate is valid is negligible; if it
ever happens the first candidate is used (a one-off overlap the physics
separates on the next step).

The reference seeds spawns from Python's *global* ``random`` module, making
its seeding decorative (vss_gym.py:199-206 — documented in SURVEY §3.2).  We
use explicit PRNG keys instead: same distribution, actually reproducible.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Candidate budget per placed point.  Worst-case acceptance per candidate at
# reference densities is >= 0.84, so P(no valid candidate) <= 0.16^8 ~= 4e-7
# per point per reset — the fallback (first candidate, possibly overlapping;
# the physics separates discs next step) is effectively unreachable.
N_CANDIDATES = 8


def pick_first(ok, *arrays):
    """Select each array's value at the first True of ``ok`` (falling back
    to index 0 when none) WITHOUT integer indexing: a one-hot masked sum.

    ``array[argmax(ok)]`` with a traced index becomes a per-lane gather
    under vmap; the one-hot formulation is elementwise + reduction and
    fuses with its neighbours.
    """
    first = ok & (jnp.cumsum(ok) == 1)  # one-hot of the first True
    any_ok = jnp.any(ok)
    sel = first.astype(arrays[0].dtype)
    return tuple(jnp.where(any_ok, jnp.sum(a * sel), a[0]) for a in arrays)


def _first_valid_mask(cands_x, cands_y, placed_x, placed_y, placed_mask, min_dist):
    """Validity of each candidate against all placed points.
    Shapes: cands (K,), placed (M,) -> (K,) bool."""
    dx = cands_x[:, None] - placed_x[None, :]
    dy = cands_y[:, None] - placed_y[None, :]
    d2 = dx * dx + dy * dy
    ok_pair = (d2 >= min_dist * min_dist) | ~placed_mask[None, :]
    return jnp.all(ok_pair, axis=1)


def place_separated(
    u,
    x_lo: float,
    x_hi: float,
    y_lo: float,
    y_hi: float,
    min_dist: float,
    preplaced_x=None,
    preplaced_y=None,
):
    """Sequentially place points in a box, each at least ``min_dist`` from
    all previously placed ones (and from the optional preplaced points).

    ``u`` is a ``(n_points, 2, N_CANDIDATES)`` block of uniform [0, 1)
    samples — randomness is an *input*, so the caller chooses the PRNG
    (per-env keys single-env; one fused batch-level draw when batched).
    Returns ((n,), (n,)) arrays.

    Mirrors the reference's sequential KD-tree rejection loop
    (vss_gym.py:214-231) with a fixed candidate budget per point.
    """
    n_points = u.shape[0]
    n_pre = 0 if preplaced_x is None else len(preplaced_x)
    total = n_pre + n_points
    px = jnp.zeros((total,))
    py = jnp.zeros((total,))
    mask = jnp.zeros((total,), bool)
    if n_pre:
        px = px.at[:n_pre].set(jnp.asarray(preplaced_x))
        py = py.at[:n_pre].set(jnp.asarray(preplaced_y))
        mask = mask.at[:n_pre].set(True)

    for i in range(n_points):
        # slice the candidate block FIRST, scale after: each loop iteration
        # must touch only its own (2, K) slice — scaling the full block up
        # front makes every iteration's fusion re-read the whole candidate
        # tensor
        cx = x_lo + u[i, 0] * (x_hi - x_lo)
        cy = y_lo + u[i, 1] * (y_hi - y_lo)
        ok = _first_valid_mask(cx, cy, px, py, mask, min_dist)
        x_i, y_i = pick_first(ok, cx, cy)
        px = px.at[n_pre + i].set(x_i)
        py = py.at[n_pre + i].set(y_i)
        mask = mask.at[n_pre + i].set(True)
    return px[n_pre:], py[n_pre:]


def sample_separated(
    key,
    n_points: int,
    x_lo: float,
    x_hi: float,
    y_lo: float,
    y_hi: float,
    min_dist: float,
    preplaced_x=None,
    preplaced_y=None,
):
    """Key-based convenience wrapper over :func:`place_separated`."""
    u = jax.random.uniform(key, (n_points, 2, N_CANDIDATES))
    return place_separated(
        u, x_lo, x_hi, y_lo, y_hi, min_dist, preplaced_x, preplaced_y
    )


def angles_from_uniform(u):
    """Uniform [0,1) samples -> headings in radians (reference draws degrees
    in [0, 360), vss_gym.py:205-206 — identical distribution)."""
    return u * (2.0 * jnp.pi)


def uniform_angles(key, n: int):
    """Key-based convenience wrapper over :func:`angles_from_uniform`."""
    return angles_from_uniform(jax.random.uniform(key, (n,)))
