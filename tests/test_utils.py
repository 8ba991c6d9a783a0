"""Checkpoint + profiling utility tests."""

import os

import jax
import jax.numpy as jnp
import numpy as np

import rsoccer_tpu
from rsoccer_tpu.utils import checkpoint
from rsoccer_tpu.utils.profiling import Throughput


def test_checkpoint_roundtrip_env_state(tmp_path):
    env = rsoccer_tpu.make("VSS-v0")
    state, obs = env.reset(jax.random.PRNGKey(0))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, state)
    restored = checkpoint.restore(path)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_resume_continues_identically(tmp_path):
    env = rsoccer_tpu.make("VSS-v0")
    state, _ = env.reset(jax.random.PRNGKey(0))
    path = str(tmp_path / "mid")
    # advance 3 steps, checkpoint, advance 2 more
    for t in range(3):
        state, *_ = env.step(state, jnp.zeros(2), jax.random.PRNGKey(t))
    checkpoint.save(path, state)
    cont_a = state
    for t in range(3, 5):
        cont_a, _, ra, *_ = env.step(cont_a, jnp.zeros(2), jax.random.PRNGKey(t))
    # restore and replay the same keys
    cont_b = checkpoint.restore(path, like=state)
    cont_b = jax.tree.map(jnp.asarray, cont_b)
    for t in range(3, 5):
        cont_b, _, rb, *_ = env.step(cont_b, jnp.zeros(2), jax.random.PRNGKey(t))
    np.testing.assert_allclose(float(ra), float(rb), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(cont_a.world), jax.tree.leaves(cont_b.world)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_throughput_meter():
    with Throughput(1000) as t:
        pass
    assert t.steps_per_s > 0


def _cache_dir_set(monkeypatch):
    """Run enable_persistent_cache with jax.config.update recorded, not
    applied (the test process must not start writing a cache)."""
    from rsoccer_tpu.utils import cache

    calls = {}
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    used = cache.enable_persistent_cache()
    assert calls["jax_compilation_cache_dir"] == used
    return used


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert _cache_dir_set(monkeypatch) == str(tmp_path)


def test_compile_cache_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    used = _cache_dir_set(monkeypatch)
    assert used == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# a two-stream GPU plane: kernels on stream 7 overlap one on stream 9, a
# device-to-host copy ends the window; a host plane is ignored
_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 7 name: "Stream #7(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 3000000 duration_ps: 1000000 }
    events { metadata_id: 1 offset_ps: 6000000 duration_ps: 2000000 }
  }
  lines {
    id: 9 name: "Stream #9(Compute)" timestamp_ns: 1000
    events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2500000 }
    events { metadata_id: 3 offset_ps: 9000000 duration_ps: 1000000 }
  }
  lines {
    id: 2 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "gemm" } }
  event_metadata { key: 3 value { id: 3 name: "MemcpyD2H" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1 name: "python" timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "dispatch" } }
}
"""


def test_device_activity_reduces_gpu_stream_events():
    from rsoccer_tpu.utils.profiling import device_activity

    act = device_activity(jax.profiler.ProfileData.from_text_proto(_TRACE))
    # window 1000..11000 ns; busy = [1000,5000) + [7000,9000) + [10000,11000)
    assert act["window_ns"] == 10000
    assert act["busy_ns"] == 4000 + 2000 + 1000
    assert abs(act["idle_share"] - 0.3) < 1e-12
    assert act["n_kernels"] == 4  # the copy is not a kernel
    assert act["top"][0] == ("loop_fusion", 4000, 2)
    assert act["top"][1] == ("gemm", 3500, 2)


def test_device_activity_refuses_a_trace_without_gpu_streams():
    import pytest

    from rsoccer_tpu.utils.profiling import device_activity

    cpu_only = _TRACE[_TRACE.index("planes {\n  id: 2"):]
    with pytest.raises(ValueError, match="no GPU stream events"):
        device_activity(jax.profiler.ProfileData.from_text_proto(cpu_only))
