"""Checkpoint / resume for env and training state.

The reference has no serialization at all — env state lives inside the C++
simulator and a crash loses the episode (SURVEY §5).  Here every
piece of state is a pytree of arrays, so checkpointing is structural: save the
leaves, restore into the same treedef.  Orbax is used when available (async,
multi-host safe); a numpy ``.npz`` fallback keeps the API dependency-free.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import jax
import numpy as np


def save(path: str, tree: Any) -> None:
    """Save a pytree of arrays to ``path`` (.npz + pickled treedef)."""
    leaves, treedef = jax.tree.flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        **{f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)},
    )
    with open(_treedef_path(path), "wb") as f:
        pickle.dump(treedef, f)


def restore(path: str, like: Any = None) -> Any:
    """Restore a pytree saved with :func:`save`.

    If ``like`` is given its treedef is used (robust across code versions
    with identical structure); otherwise the pickled treedef is loaded.
    """
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves = [npz[f"leaf_{i}"] for i in range(len(npz.files))]
    if like is not None:
        treedef = jax.tree.structure(like)
    else:
        with open(_treedef_path(path), "rb") as f:
            treedef = pickle.load(f)
    return jax.tree.unflatten(treedef, leaves)


def _treedef_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".treedef.pkl"


def save_orbax(path: str, tree: Any) -> None:
    """Orbax variant (async-capable, multi-host)."""
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree, force=True)
    ckptr.wait_until_finished()


def restore_orbax(path: str, like: Any) -> Any:
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path), like)
