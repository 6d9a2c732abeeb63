#!/usr/bin/env python3
"""Regime throughput sweep: runs bench.py once per scoring regime in
serial subprocesses (one process on the GPU at a time) and prints each
regime's JSON lines, device-stamped.

Run: python benchmarks/bench_regimes.py [--regimes a,b] [--steps N]
     [--ab]   (fast path vs exact gather in every regime, bench.py
               BENCH_AB=1)
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REGIMES = {
    # converged serving regime (conv cost field)
    "converged_conv": {},
    # spread cloud, tracked thetas (crop path, every rotation shift)
    "spread_tracked": {"BENCH_EXTENT": "0", "BENCH_THETA_SPREAD": "0"},
    # spread cloud, 40-way theta search (global init)
    "spread_init": {
        "BENCH_EXTENT": "0",
        "BENCH_THETA_SPREAD": "0",
        "BENCH_MODE": "init",
    },
    # exploration at coarse range resolution (mip crop)
    "mip4_coarse": {
        "BENCH_EXTENT": "0",
        "BENCH_THETA_SPREAD": "0",
        "BENCH_RES": "2.0",
    },
    # unknown scale, 10 hypotheses, theta search
    "multi_init": {"BENCH_MULTI": "1", "BENCH_MODE": "init"},
    # unknown scale, 10 hypotheses, tracked
    "multi_tracked": {"BENCH_MULTI": "1"},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--regimes", default=",".join(REGIMES))
    ap.add_argument("--steps", default=None)
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args()

    failed = []
    for name in args.regimes.split(","):
        env = dict(os.environ, **REGIMES[name])
        if args.steps:
            env["BENCH_STEPS"] = args.steps
        if args.ab:
            env["BENCH_AB"] = "1"
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench.py")],
            capture_output=True, text=True, env=env,
            timeout=args.timeout,
        )
        lines = [
            ln for ln in p.stdout.splitlines() if ln.startswith("{")
        ]
        if p.returncode != 0 or not lines:
            print(f"[regimes] {name} FAILED (rc {p.returncode}):\n"
                  f"{p.stdout[-4000:]}\n{p.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            failed.append(name)
            continue
        for ln in lines:
            print(json.dumps({"regime": name, "wall_s":
                              time.perf_counter() - t0,
                              **json.loads(ln)}), flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
