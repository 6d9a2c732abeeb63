#!/usr/bin/env python3
"""Closed-loop accuracy + convergence benchmark on the city drive.

The equivalent of the reference's benchmark_loc.py /
benchmark_conv.py runs (/root/reference/scripts/benchmark_loc.py:43-96,
benchmark_conv.py:52-83): drives the REAL TopDownRenderNode through the
recorded npz Bag (benchmarks/data/city.npz - regenerate with
city_bag.py), compares post-convergence pose_est against GPS, sweeps
start offsets for time/distance-to-converge, and merges the results
into benchmarks/loc_results.json.

Usage: python benchmarks/bench_loc.py [--runs 3] [--offsets 0,30,60]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


import numpy as np

from city_bag import CLASS_COLORS, CLASS_NAMES


def make_node_factory(data_dir, particle_count, seed_base=0,
                      name="city", unknown_scale=False):
    from top_down_renderer_tpu.config import (
        ClassConfig,
        MapConfig,
        RuntimeParams,
    )
    from top_down_renderer_tpu.runtime.node import TopDownRenderNode

    color_lut = np.full((256, 3), 255, np.uint8)
    for i, col in enumerate(CLASS_COLORS):
        color_lut[i] = col
    cc = ClassConfig(
        color_lut=color_lut,
        class_to_flattened=list(range(len(CLASS_NAMES))),
        flattened_to_class=list(range(len(CLASS_NAMES))),
        exclusivity=[True] * len(CLASS_NAMES),
        loc_weight=[0.1, 1.0, 2.5, 1.5, 2.0, 2.0],
    )
    with open(os.path.join(data_dir, f"{name}_meta.json")) as f:
        meta = json.load(f)
    mc = MapConfig(
        raster_path=os.path.join(data_dir, f"{name}.png"),
        resolution=float(meta["scale_px_m"]),
    )
    rt = RuntimeParams(
        particle_count=particle_count,
        use_motion_prior=True,
    )

    overrides = dict(
        regularization=0.02, pos_cov=0.1, force_on_map=True
    )
    if unknown_scale:
        # the reference's aerial-image mode: map resolution withheld,
        # the filter draws 10 discrete scale hypotheses per position
        # (particle_filter.cpp:19-25) and freezes on convergence -- this
        # drives the K-bucket multi-scale crop path end to end.
        # fixed_scale < 0 means unknown (particles.py:89).
        overrides["fixed_scale"] = -1.0

    def make_node(run_idx):
        return TopDownRenderNode(
            cc, mc, rt,
            filter_overrides=overrides,
            seed=seed_base + run_idx,
        )

    return make_node, meta


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "data"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--particles", type=int, default=20000)
    ap.add_argument("--offsets", default="0,30,60,90,120")
    ap.add_argument("--skip-conv", action="store_true")
    ap.add_argument("--max-scans", type=int, default=None,
                    help="cap scans per run (smoke mode)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke mode)")
    ap.add_argument("--no-prewarm", action="store_true",
                    help="skip the throwaway cache-warming run")
    ap.add_argument("--tag", default=None,
                    help="result key suffix (e.g. 'smoke')")
    ap.add_argument("--bag", default="city",
                    help="bag basename: city | city_hard (realism)")
    ap.add_argument("--unknown-scale", action="store_true",
                    help="withhold the map resolution: the filter "
                    "estimates scale from 10 hypotheses (the "
                    "reference's aerial-image mode; exercises the "
                    "multi-scale crop path)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        # the config update takes effect after import
        jax.config.update("jax_platforms", "cpu")

    from top_down_renderer_tpu.io import (
        Bag,
        benchmark_conv,
        benchmark_loc,
        replay,
    )

    bag = Bag.load(os.path.join(args.data, f"{args.bag}.npz"))
    make_node, meta = make_node_factory(
        args.data, args.particles, name=args.bag,
        unknown_scale=args.unknown_scale,
    )

    if not args.no_prewarm and jax.default_backend() != "cpu":
        # throwaway drive to fill the persistent compile cache: every
        # regime transition (mip-crop -> conv, region/window shrinking)
        # first-touches a jit variant that compiles; one cold pass makes
        # the measured runs warm
        t0 = time.perf_counter()
        print("[bench_loc] prewarm drive (cold compiles)...", flush=True)
        replay(make_node(999), bag, max_scans=args.max_scans)
        print(f"[bench_loc] prewarm done in "
              f"{time.perf_counter() - t0:.0f}s", flush=True)

    t0 = time.perf_counter()
    loc = benchmark_loc(
        make_node, bag, runs=args.runs, max_scans=args.max_scans,
        verbose=True,
    )
    loc_s = time.perf_counter() - t0
    conv_times = [
        r["first_converged_stamp"] - r["start_stamp"]
        for r in loc["runs"]
        if r["first_converged_stamp"] is not None
    ]
    # every persisted entry carries its provenance: the device it ran
    # on, the world generator, and whether it was a capped/CPU smoke
    # (never a measurement)
    smoke = bool(args.cpu or args.max_scans)
    summary = {
        "bag": args.bag,
        "unknown_scale": bool(args.unknown_scale),
        "smoke": smoke,
        "workload": f"{args.bag} drive "
        f"({meta['drive_len_m']:.0f} m, {meta['steps']} scans, "
        f"{meta['hw']}px map @ {meta['scale_px_m']} px/m)",
        "generator": meta.get("generator", "city_bag.py"),
        "particles": args.particles,
        "runs": args.runs,
        "device": str(jax.devices()[0]),
        "mean_error_m": round(loc["mean_error_m"], 3),
        "median_error_m": round(loc["median_error_m"], 3),
        "per_run_mean_error_m": [
            round(float(r["errors"].mean()), 3)
            for r in loc["runs"] if len(r["errors"])
        ],
        "time_to_converge_s": [round(t, 1) for t in conv_times],
        "wall_s": round(loc_s, 1),
    }
    if args.unknown_scale:
        true_scale = float(meta["scale_px_m"])
        finals = [
            float(r["scales"][-1]) if r["scales"]
            else float(r["final_scale"])
            for r in loc["runs"]
            if r["scales"] or r.get("final_scale") is not None
        ]
        summary["true_scale_px_m"] = true_scale
        summary["final_scale_px_m"] = [round(s_, 4) for s_ in finals]
        summary["scale_rel_err"] = [
            round(abs(s_ - true_scale) / true_scale, 4) for s_ in finals
        ]
    print(json.dumps({"benchmark_loc": summary}), flush=True)

    out = {"benchmark_loc": summary}
    if not args.skip_conv:
        offsets = [float(x) for x in args.offsets.split(",")]
        t0 = time.perf_counter()
        conv = benchmark_conv(
            make_node, bag, offsets=offsets, poses_after=120,
            max_scans=args.max_scans, verbose=True,
        )
        out["benchmark_conv"] = {
            "bag": args.bag,
            "smoke": smoke,
            "generator": meta.get("generator", "city_bag.py"),
            "particles": args.particles,
            "device": str(jax.devices()[0]),
            "offsets": offsets,
            "convergence_rate": conv["convergence_rate"],
            "mean_time_to_converge_s": round(
                conv["mean_time_to_converge_s"], 2
            ),
            "sweeps": [
                {
                    k: (round(v, 2) if isinstance(v, float) else v)
                    for k, v in s.items()
                }
                for s in conv["sweeps"]
            ],
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(json.dumps({"benchmark_conv": out["benchmark_conv"]}),
              flush=True)

    if args.unknown_scale:
        out = {f"{k}_uscale": v for k, v in out.items()}
    if args.tag:
        out = {f"{k}_{args.tag}": v for k, v in out.items()}
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "loc_results.json"
    )
    merged = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                merged = json.load(f)
        except json.JSONDecodeError:
            pass
    merged.update(out)
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)


if __name__ == "__main__":
    main()
