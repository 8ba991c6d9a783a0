"""Device meshes and batch-axis sharding.

The reference has no distribution of any kind (SURVEY §2: single env <->
single C++ sim, no comm backend).  Here scaling is pure data parallelism over
the env batch: a 1-D mesh over all devices (NVLink joins the GPUs of a host
all to all, so the mesh has no topology to follow; several hosts join via
``jax.distributed``), with every env-state leaf sharded on its trailing
batch axis.  The physics step is embarrassingly parallel — zero
cross-chip communication inside the rollout; collectives appear only for
metric reduction and learner gradients (``psum`` over the mesh axis).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ENV_AXIS = "env"


def make_env_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all) with axis name ``env``."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def batch_sharding(mesh: Mesh, ndim: int, batch_axis: int = -1) -> NamedSharding:
    """NamedSharding placing the batch axis of a rank-``ndim`` leaf on the
    env mesh axis (batch-last by default, matching the lane layout)."""
    spec = [None] * ndim
    spec[batch_axis] = ENV_AXIS
    return NamedSharding(mesh, P(*spec))


def shard_batched_tree(tree, mesh: Mesh, batch_axis: int = -1):
    """device_put every leaf with its batch axis sharded over the mesh.

    Works for any lane-layout tree (trailing batch axis on every leaf).
    """

    def put(leaf):
        return jax.device_put(leaf, batch_sharding(mesh, leaf.ndim, batch_axis))

    return jax.tree.map(put, tree)


def initialize_distributed(**kwargs):
    """Multi-host bring-up: ``jax.distributed.initialize`` passthrough.

    On several hosts call this once per process (one per host, seeing that
    host's GPUs) before building meshes; single-host usage never needs it.
    """
    jax.distributed.initialize(**kwargs)
