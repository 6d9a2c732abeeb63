"""Consumer-boundary verification drive (the /verify canonical flow).

Exercises tdr strictly through the public package surface, the way a
user migrating from KumarRobotics/top_down_renderer would:

  1. author a color-raster semantic map PNG (terrain/road/building),
  2. load it via ClassConfig + MapParams -> TopDownMap (color-LUT path),
  3. run a global-localization drive with ParticleFilter at fixed scale
     (spread init -> converged tracking, fast dispatch on the GPU),
  4. mid-run dynamic-map swap: roll the index image, update_map() with a
     shifted center, and keep tracking in the shifted frame.

Expect a converged error under 8 px (seed 0, 2048 particles).  CPU runs
use the same world but the exact path.

Usage: python tests/drive_consumer.py [--cpu] [--particles N]
       [--steps N] [--no-swap]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time


_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _here)
sys.path.insert(0, os.path.dirname(_here))
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--particles", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--no-swap", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    if args.cpu:
        # the config update takes effect after import
        jax.config.update("jax_platforms", "cpu")

    import numpy as np
    import jax.numpy as jnp
    from PIL import Image

    from top_down_renderer_tpu import ClassConfig, FilterParams, MapParams
    from top_down_renderer_tpu.filter.filter import ParticleFilter
    from top_down_renderer_tpu.maps.map import TopDownMap
    from top_down_renderer_tpu.render.semantic import render_semantic_polar

    from util_synthetic import generate_scan_points, make_world, rot2d

    print(f"[drive] backend = {jax.default_backend()}")

    # -- 1. author the color raster -----------------------------------
    colors = np.array(
        [(0, 100, 0), (128, 128, 128), (170, 40, 40)], np.uint8
    )  # terrain, road, building
    world = make_world()  # (3, H, W) bottom-up, 0 = class present
    ind_bu = np.zeros(world.shape[1:], np.uint8)
    ind_bu[world[1] == 0] = 1
    ind_bu[world[2] == 0] = 2
    rgb = colors[ind_bu[::-1]]  # image coords: row 0 at top
    png = "/tmp/tdr_drive_map.png"
    Image.fromarray(rgb).save(png)

    # -- 2. public map loading path ------------------------------------
    color_lut = np.full((256, 3), 255, np.uint8)
    color_lut[:3] = colors
    cc = ClassConfig(
        color_lut=color_lut,
        class_to_flattened=[0, 1, 2],
        flattened_to_class=[0, 1, 2],
        exclusivity=[True, True, False],
        loc_weight=[0.1, 1.5, 3.0],
    )
    mp = MapParams(
        map_path=png,
        num_classes=3,
        resolution=1.0,
        flatten_lut=cc.flatten_lut(),
        exclusive_classes=cc.exclusive_classes(),
        class_config=cc,
    )
    tdm = TopDownMap(mp)
    assert tdm.have_map, "PNG map failed to load"
    assert 1 in tdm.get_classes_at_point((60, 105)), "road missing"
    tdm.sample_pts_polar(100, 25)

    # -- 3. the localization drive -------------------------------------
    scale_gt = 2.0
    psi_gt = 0.7
    gt_pos = np.array([60.0, 105.0], np.float32)
    fp = FilterParams(
        pos_cov=0.1,
        theta_cov=math.pi / 100,
        regularization=0.02,
        fixed_scale=scale_gt,
        class_weights=[0.1, 1.5, 3.0],
        force_on_map=True,
    )
    pf = ParticleFilter(
        args.particles, tdm, fp, seed=args.seed, chunk_size=512
    )
    print(f"[drive] {pf.num_particles()} particles, use_fast={pf.use_fast}")

    flut = np.arange(256, dtype=np.int32)
    res = 1.0
    ang_res = 2 * math.pi / 100
    frame_delta = np.zeros(2, np.float32)  # world -> map frame offset

    def step(i: int):
        nonlocal gt_pos
        pts = generate_scan_points(
            world, gt_pos, psi_gt, scale_gt, max_range_m=25.0,
            n_pad=8192, seed=i,
        )
        scan = render_semantic_polar(
            jnp.asarray(pts), jnp.asarray(flut), res, ang_res, 3, 100, 25
        )
        trans = np.array([1.5, 0.0], np.float32)
        t0 = time.time()
        pf.propagate(trans, 0.0)
        pf.update(scan, res)
        gt_pos = gt_pos + (rot2d(psi_gt) @ trans) * scale_gt
        ml = pf.mean_likelihood()
        cov = pf.compute_mean_cov()
        err = float(np.linalg.norm(ml[:2] - (gt_pos + frame_delta)))
        print(
            f"[drive] step {i:3d}  err {err:7.2f} px  cov_xx {cov[0, 0]:9.1f}"
            f"  wall {time.time() - t0:6.2f} s"
        )
        return err, float(cov[0, 0])

    for i in range(args.steps):
        err, cov_xx = step(i)

    ok = err < 8.0 and cov_xx < 400.0
    print(f"[drive] converged: err {err:.2f} px, cov_xx {cov_xx:.1f}")

    # -- 4. dynamic-map swap probe -------------------------------------
    if not args.no_swap:
        delta = np.array([24, 16])  # (dx, dy) px
        ind_rolled = np.roll(ind_bu, (delta[1], delta[0]), (0, 1))
        pf.update_map(ind_rolled[::-1], delta)
        frame_delta += delta.astype(np.float32)
        print(f"[drive] dynamic-map swap, center -> {delta}")
        for i in range(6):
            err, cov_xx = step(args.steps + i)
        ok = ok and err < 10.0
        print(f"[drive] post-swap: err {err:.2f} px")

    print(f"[drive] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
