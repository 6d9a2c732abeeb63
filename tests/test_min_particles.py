"""Regression test at the documented minimum-particle floor.

The reference ships a 300-particle launch default and localizes with
300-20,000 particles (/root/reference/launch/top_down_render.launch:22,
top_down_render.cpp:53).  This framework's measured floors on the
closed-loop city worlds (earlier CPU and accelerator sweeps with
benchmarks/sweep_min_particles.py):

  - city (known scale):       2,048  (mean err 2.3 m)
  - city_hard (occlusions):   2,048  (2 runs converged, ~4.9-6.8 m)
  - unknown scale (city):    20,480 measured-good; 4,096 diverges

This test pins the HARDEST known-scale floor cell: a city_hard drive at
2,048 particles must converge within the first ~35 simulated seconds
(measured 16.4-17.4 s across seeds) and track with bounded error.  The
drive is capped at 180 scans to keep suite cost bounded; convergence
happens by ~87 scans, so the cap leaves 2x margin.
"""

import json
import os
import sys

import numpy as np
import pytest

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(_here), "benchmarks"))

FLOOR_N = 2048
MAX_SCANS = 180


@pytest.mark.slow
def test_city_hard_floor_2048_converges():
    from bench_loc import make_node_factory
    from top_down_renderer_tpu.io.replay import Bag, replay

    data = os.path.join(
        os.path.dirname(_here), "benchmarks", "data"
    )
    if not os.path.exists(os.path.join(data, "city_hard.npz")):
        pytest.skip("benchmarks/data/city_hard.npz not generated")
    make_node, meta = make_node_factory(
        data, FLOOR_N, name="city_hard"
    )
    bag = Bag.load(os.path.join(data, "city_hard.npz"))
    rec = replay(make_node(0), bag, max_scans=MAX_SCANS)

    assert rec["first_converged_stamp"] is not None, (
        f"no convergence in {MAX_SCANS} scans at the {FLOOR_N}-particle "
        "floor (measured floor: converges by ~87 scans)"
    )
    t_conv = rec["first_converged_stamp"] - rec["start_stamp"]
    assert t_conv < 35.0, f"converged too late: {t_conv:.1f}s"

    # post-convergence tracking error vs GPS (same alignment as
    # benchmark_loc, io/replay.py)
    stamps = np.array([p.stamp for p in rec["poses"]])
    est = np.array([p.position[:2] for p in rec["poses"]])
    assert len(est) >= 20, "too few published poses after convergence"
    from top_down_renderer_tpu.io.replay import _interp_gps

    gps = _interp_gps(bag, stamps)
    gps = gps - gps[0] + est[0]
    errs = np.linalg.norm(est - gps, axis=1)
    assert float(errs.mean()) < 12.0, (
        f"mean tracking error {errs.mean():.1f} m at the floor "
        "(measured 4.9-6.8 m across seeds)"
    )
