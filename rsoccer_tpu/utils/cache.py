"""Persistent XLA compilation cache setup.

A cold compile of a full training step takes tens of seconds; the
persistent cache makes every re-run of an unchanged program skip it.
``bench.py``, ``chip_smoke.py``, the examples and the tools all call
:func:`enable_persistent_cache` and set no cache path of their own.

Call before building any jitted program (idempotent).
"""

from __future__ import annotations

import os

# one fixed directory inside the checkout, so every run of this checkout
# finds what the last one compiled (a per-run path would never hit)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str:
    """Point jax's persistent compilation cache at ``JAX_COMPILATION_CACHE_DIR``
    when that variable is set, else at ``<checkout>/.jax_cache``.  Returns
    the directory used."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir
