"""Dev probe: host-vs-device split of the node loop on the city bag.

Splits a 60-scan city drive into render / filter / publish / host-rest
to find where the node loop's time goes beyond the device step.

Run: python tests/profile_node.py  (GPU; ~2 min)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks"))
from top_down_renderer_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


import numpy as np


def main():
    from bench_loc import make_node_factory
    from top_down_renderer_tpu.io import Bag, replay
    from top_down_renderer_tpu.runtime import node as node_mod

    data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks", "data")
    bag = Bag.load(os.path.join(data, "city.npz"))
    # default 20480 = the bench_loc drive count, so this probe rides
    # the same compiled variants (20000 would re-compile every shape)
    n = int(os.environ.get("BENCH_N", 20480))
    make_node, _meta = make_node_factory(data, n)
    node = make_node(0)
    # TDR_ASYNC_PUBLISH=1: the low-latency serving mode (publish the
    # freshest completed snapshot instead of blocking on this scan's)
    if int(os.environ.get("TDR_ASYNC_PUBLISH", "0")):
        node.rt.async_publish = True

    stats = {"render": [], "filter": [], "publish": [], "total": []}
    orig_publish = node.publish_pose_est

    def timed_publish(stamp):
        t0 = time.perf_counter()
        orig_publish(stamp)
        stats["publish"].append(time.perf_counter() - t0)

    node.publish_pose_est = timed_publish

    t_last = [None]
    orig_take = node.take_step

    def timed_take(stamp, points, prior):
        t0 = time.perf_counter()
        orig_take(stamp, points, prior)
        stats["total"].append(time.perf_counter() - t0)
        stats["render"].append(node.timing.get("render_ms", 0) / 1e3)
        stats["filter"].append(node.timing.get("filter_ms", 0) / 1e3)

    node.take_step = timed_take
    replay(node, bag, max_scans=60)

    for k in ("total", "render", "filter", "publish"):
        v = np.asarray(stats[k][5:]) * 1e3  # skip warmup scans
        print(f"{k:8s} med {np.median(v):7.1f} ms  "
              f"p90 {np.percentile(v, 90):7.1f} ms")
    other = (
        np.median(stats["total"][5:])
        - np.median(stats["render"][5:])
        - np.median(stats["filter"][5:])
        - np.median(stats["publish"][5:])
    )
    print(f"other    med {other * 1e3:7.1f} ms (pairing, callbacks)")


if __name__ == "__main__":
    main()
