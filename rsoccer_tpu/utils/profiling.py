"""Profiling and throughput instrumentation.

The reference's only observability is ad-hoc debug prints on reward spikes
(static_defenders.py:276-280).  Here: a ``jax.profiler`` trace context for
Perfetto/XProf captures of the step, the reduction of such a trace to the
GPU's busy time, idle share and kernel count, and a steps/s meter for
rollout loops.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str = "traces/step"):
    """Capture a device trace viewable in Perfetto / TensorBoard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def load_profile(log_dir: str):
    """The newest ``.xplane.pb`` under ``log_dir`` as a ``ProfileData``."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))


# stream-line events that move memory rather than run a kernel
_COPY_PREFIXES = ("Memcpy", "Memset")


def device_activity(profile, top: int = 10) -> dict:
    """Reduce the GPU planes of a trace to what the device did.

    Reads the events on every ``Stream ...`` line of every
    ``/device:GPU:*`` plane (the kernels and copies as the GPU ran them),
    over the window from the first event's start to the last one's end:

    - ``busy_ns``: length of the union of event intervals (all streams);
    - ``idle_share``: 1 - busy / window, the gaps between kernels;
    - ``n_kernels``: events that are not memory copies or sets;
    - ``top``: ``(name, total_ns, count)`` of the costliest kernels.
    """
    evs = []
    lines_seen = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.append(line.name)
            if line.name.startswith("Stream"):
                evs.extend(
                    (e.start_ns, e.start_ns + e.duration_ns, e.name)
                    for e in line.events
                )
    if not evs:
        raise ValueError(
            f"no GPU stream events in the trace (device lines: {lines_seen})"
        )
    evs.sort()
    busy = 0.0
    cur_s, cur_e = evs[0][0], evs[0][1]
    for s, e, _ in evs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in evs) - evs[0][0]
    per_name = collections.defaultdict(lambda: [0.0, 0])
    n_kernels = 0
    for s, e, name in evs:
        if not name.startswith(_COPY_PREFIXES):
            n_kernels += 1
            per_name[name][0] += e - s
            per_name[name][1] += 1
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "n_kernels": n_kernels,
        "top": [(n, t, c) for n, (t, c) in ranked],
    }


class Throughput:
    """Steps/s meter: ``with Throughput(n_steps) as t: ...; t.steps_per_s``."""

    def __init__(self, total_env_steps: int):
        self.total = total_env_steps
        self.steps_per_s = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self.steps_per_s = self.total / max(self.elapsed, 1e-9)
        return False
