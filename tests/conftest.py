"""Test configuration.

Tests run on a virtual multi-device CPU platform (8 host devices) so sharding
tests exercise real meshes without accelerators.  Env vars must be set before
jax initialises its backends, hence this sits at conftest import time.
"""

import os

# Force CPU for tests (overriding any JAX_PLATFORMS of the environment);
# export RSOCCER_TEST_PLATFORM=gpu to run them on a GPU, in one process
# (no xdist workers: each JAX process reserves most of the card's memory).
os.environ["JAX_PLATFORMS"] = os.environ.get("RSOCCER_TEST_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env setup)

jax.config.update("jax_default_matmul_precision", "highest")
