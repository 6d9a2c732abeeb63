"""Minimum-reliable-particle-count sweep.

Runs the closed-loop drive at descending particle counts per regime
(city, city_hard, unknown-scale) and records, per N: runs converged,
mean error, time-to-converge.  The floor for a regime is the smallest
N where every run converges with mean error within 2x of the 20k
reference.  Results -> benchmarks/min_particles.json (device-stamped).

The reference ships a 300-particle launch default
(/root/reference/launch/top_down_render.launch:22) against a 20,000
code default (top_down_render.cpp:53); this sweep documents where THIS
framework's floor sits on the same synthetic drives.

Run: python benchmarks/sweep_min_particles.py [--cpu] [--runs N]
     [--max-scans N] [--regimes city,city_hard,uscale]
     [--counts 512,1024,...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)
sys.path.insert(0, os.path.dirname(_here))
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument("--regimes", default="city,city_hard,uscale")
    ap.add_argument(
        "--counts", default="8192,4096,2048,1024,512"
    )
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from bench_loc import make_node_factory
    from top_down_renderer_tpu.io import Bag, benchmark_loc, replay

    counts = [int(x) for x in args.counts.split(",")]
    out_path = os.path.join(_here, "min_particles.json")
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    for regime in args.regimes.split(","):
        bag_name = {
            "city": "city", "city_hard": "city_hard", "uscale": "city",
        }[regime]
        unknown = regime == "uscale"
        bag = Bag.load(os.path.join(_here, "data", f"{bag_name}.npz"))
        prewarmed = False
        for n in counts:
            make_node, meta = make_node_factory(
                _here + "/data", n, name=bag_name,
                unknown_scale=unknown,
            )
            if not prewarmed and jax.default_backend() != "cpu":
                print(f"[sweep] {regime}: prewarm at n={n}",
                      flush=True)
                replay(make_node(999), bag, max_scans=args.max_scans)
                prewarmed = True
            t0 = time.perf_counter()
            loc = benchmark_loc(
                make_node, bag, runs=args.runs,
                max_scans=args.max_scans, verbose=False,
            )
            conv = [
                r["first_converged_stamp"] is not None
                and len(r["errors"]) > 0
                for r in loc["runs"]
            ]
            errs = [
                float(r["errors"].mean())
                for r in loc["runs"] if len(r["errors"])
            ]
            key = f"{regime}_n{n}" + (
                f"_{args.tag}" if args.tag else ""
            )
            entry = {
                "regime": regime,
                "particles": n,
                "runs": args.runs,
                "converged": int(sum(conv)),
                "mean_err_m": (
                    round(float(np.mean(errs)), 3) if errs else None
                ),
                "per_run_err_m": [round(e, 3) for e in errs],
                "device": str(jax.devices()[0]),
                "smoke": bool(args.cpu or args.max_scans),
                "wall_s": round(time.perf_counter() - t0, 1),
            }
            results[key] = entry
            print(json.dumps({key: entry}), flush=True)
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
                f.write("\n")
            if sum(conv) == 0:
                # below the floor: no point descending further
                break


if __name__ == "__main__":
    main()
