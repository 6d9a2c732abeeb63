#!/usr/bin/env python3
"""Diagnose the config-3/4 divergence: is the 242/469 px final error a
filter bug or a world ambiguity (the strip-road world is translation-
invariant along x)?

Prints per-step ml-vs-gt error decomposed into along-road (x) and
cross-road (y) components plus the GMM mode count.  If the error is
almost purely along-x with a small y component, the filter has locked
onto a translated mode of an ambiguous world.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


import numpy as np

from run_all import _world


def main(n=16384, hw=1024, steps=15, seed=4):
    import jax
    import jax.numpy as jnp

    from top_down_renderer_tpu.config import FilterParams, MapParams
    from top_down_renderer_tpu.filter.filter import ParticleFilter
    from top_down_renderer_tpu.maps.map import TopDownMap, build_grid
    from top_down_renderer_tpu.render.semantic import render_semantic_polar

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))
    from util_synthetic import generate_scan_points, rot2d

    maps = _world(hw, hw, 6, seed=seed)
    c, h, w = maps.shape
    scale, res = 2.0, 1.0
    tdm = TopDownMap(MapParams(map_path="", num_classes=c, resolution=1.0))
    tdm.grid = build_grid(maps, 1.0, 50.0)
    tdm.class_maps_binary = maps
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    params = FilterParams(
        pos_cov=0.1, regularization=0.02, fixed_scale=scale,
        class_weights=[0.5] + [1.5] * (c - 1), force_on_map=True,
    )
    pf = ParticleFilter(n, tdm, params, seed=0,
                        chunk_size=min(2048, n))
    gt = np.array([w * 0.25, h / 2.0], np.float32)
    psi = 0.0
    flut = np.arange(256, dtype=np.int32)
    for step in range(steps):
        pts = generate_scan_points(maps, gt, psi, scale, 25.0, 8192,
                                   seed=step)
        scan = render_semantic_polar(
            jnp.asarray(pts), jnp.asarray(flut), res,
            2 * np.pi / 100, c, 100, 25)
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf.update(scan, res)
        gt = gt + (rot2d(psi) @ np.array([1.0, 0.0])) * scale
        ml = pf.mean_likelihood()
        means, covs = pf.get_gmm()
        dx, dy = float(ml[0] - gt[0]), float(ml[1] - gt[1])
        print(f"step {step:2d}  err={np.hypot(dx, dy):8.2f}  "
              f"dx={dx:8.2f}  dy={dy:7.2f}  dtheta={float(ml[2]) - psi:6.3f} "
              f" k={len(means)}  n={pf.num_particles()}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--hw", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--seed", type=int, default=4)
    args = ap.parse_args()
    main(args.n, args.hw, args.steps, args.seed)
