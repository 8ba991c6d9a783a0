"""Run bench.py across all five reference envs (and optional batch sweep).

    python tools/bench_all.py [--envs 8192] [--out artifacts/bench_all.json]
    python tools/bench_all.py --sweep 2048,8192,32768,131072 --ids VSS-v0

Each point is a separate bench.py subprocess inheriting RSOCCER_BENCH_* env
overrides, run one after another: a JAX process reserves most of the GPU's
memory, so two at once on one card would fail.  Results collect into one
JSON file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_IDS = [
    "VSS-v0",
    "SSLStaticDefenders-v0",
    "SSLDribbling-v0",
    "SSLContestedPossession-v0",
    "SSLPassEndurance-v0",
]


def run_point(env_id: str, n_envs: int, timeout_s: int = 1800) -> dict:
    env = dict(os.environ)
    env["RSOCCER_BENCH_ENV_ID"] = env_id
    env["RSOCCER_BENCH_ENVS"] = str(n_envs)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=timeout_s,
        check=True,
    )
    line = out.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    rec["env_id"] = env_id
    rec["n_envs"] = n_envs
    print(
        f"{env_id:28s} @ {n_envs:6d}: "
        f"{rec['value'] / 1e6:8.1f}M steps/s"
    )
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=8192)
    p.add_argument("--ids", default=",".join(ALL_IDS))
    p.add_argument("--sweep", default="", help="comma list of batch sizes")
    p.add_argument("--out", default="artifacts/bench_all.json")
    args = p.parse_args()

    ids = [s for s in args.ids.split(",") if s]
    sizes = (
        [int(s) for s in args.sweep.split(",") if s] if args.sweep else [args.envs]
    )
    results = [run_point(i, n) for i in ids for n in sizes]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {args.out} ({len(results)} points)")


if __name__ == "__main__":
    main()
