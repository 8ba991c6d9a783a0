"""CPU-side checks of the scripts that measure the GPU: they refuse to
run without one, and the roofline never assumes a peak."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline", os.path.join(_REPO, "tools", "roofline.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["bf16", "tf32", "f32"])
def test_roofline_resolves_a_known_device(dtype):
    rl = _roofline()
    for kind, row in rl.PEAKS.items():
        assert rl.resolve_peaks(kind, dtype) == (row["tflops"][dtype], row["gbs"])
    assert rl.resolve_peaks("NVIDIA H100 80GB HBM3", "bf16") == (989.4, 3350.0)


def test_roofline_refuses_an_unknown_device():
    rl = _roofline()
    with pytest.raises(ValueError, match="no published peaks"):
        rl.resolve_peaks("NVIDIA A100-SXM4-80GB", "bf16")
    with pytest.raises(ValueError, match="no published peaks"):
        rl.resolve_peaks("NVIDIA A100-SXM4-80GB", "bf16", peak_tflops=100.0)
    got = rl.resolve_peaks("NVIDIA A100-SXM4-80GB", "bf16", 312.0, 2039.0)
    assert got == (312.0, 2039.0)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_exit_nonzero_on_the_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(_REPO, script)],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "found no GPU" in out.stderr or "found none" in out.stderr
    # no result line
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
