#!/usr/bin/env python3
"""Node entry point: the top_down_render_node + launch-file equivalent.

The reference wires ~30 rosparams through a launch file
(/root/reference/launch/top_down_render.launch,
src/top_down_render_node.cpp); here a single YAML holds the same
parameter surface and the node runs either against ROS (with rospy
present) or a recorded npz bag.

Config YAML schema:
  world:
    classes: classes.yaml          # ClassConfig.from_yaml
    map: map.yaml                  # MapConfig.from_yaml
  runtime:                         # RuntimeParams fields (optional)
    particle_count: 20000
    use_motion_prior: true
    ...
  filter:                          # FilterParams overrides (optional)
    pos_cov: 0.3
    init_pos_px_x: none            # 'none' sentinel like the reference
    ...
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_config(path):
    import yaml

    from top_down_renderer_tpu.config import (
        ClassConfig,
        MapConfig,
        RuntimeParams,
    )

    with open(path) as f:
        cfg = yaml.safe_load(f)
    base = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    cc = ClassConfig.from_yaml(resolve(cfg["world"]["classes"]))
    mc = MapConfig.from_yaml(resolve(cfg["world"]["map"]))
    rt = RuntimeParams(**cfg.get("runtime", {}))
    # 'none' sentinel parsing parity (top_down_render.cpp:203-232)
    fo = {}
    for k, v in cfg.get("filter", {}).items():
        if v == "none":
            v = (
                -1.0
                if k in ("init_pos_px_x", "init_pos_px_y")
                else float("inf")
            )
        fo[k] = v
    return cc, mc, rt, fo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--bag", default="", help="replay an npz bag")
    ap.add_argument("--ros", action="store_true", help="attach to ROS")
    ap.add_argument("--cache-dir", default="")
    args = ap.parse_args()

    from top_down_renderer_tpu.runtime.node import TopDownRenderNode

    cc, mc, rt, fo = load_config(args.config)
    node = TopDownRenderNode(
        cc, mc, rt, filter_overrides=fo, map_cache_dir=args.cache_dir
    )
    node.on(
        "pose_est",
        lambda p: print(
            f"[pose] t={p.stamp:.2f} xy=({p.position[0]:.2f}, "
            f"{p.position[1]:.2f}) cov_xx={p.covariance[0, 0]:.3f}"
        ),
    )

    if args.ros:
        import rospy

        from top_down_renderer_tpu.runtime.ros_shim import RosShim

        rospy.init_node("top_down_render")
        shim = RosShim(node)
        print("[tdr] node up (ROS)")
        shim.spin()
    elif args.bag:
        from top_down_renderer_tpu.io import Bag, replay

        rec = replay(node, Bag.load(args.bag))
        print(
            f"[tdr] replay done: {rec['n_scans']} scans, "
            f"{len(rec['poses'])} poses, converged="
            f"{rec['first_converged_stamp'] is not None}"
        )
    else:
        print("provide --bag or --ros", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
