"""tdr: semantic cross-view localization framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
KumarRobotics/top_down_renderer (the "XView" system): global Monte-Carlo
localization of a ground robot against an aerial semantic map from
semantically-labeled LiDAR scans.

Layer map (mirrors SURVEY.md section 1, redesigned for batched arrays):
  core/      array pytrees + geometry helpers
  maps/      semantic map loading (SVG/raster), jitted rasterization + EDT,
             polar sampling stencil  (ref: top_down_map.{h,cpp})
  render/    scan -> top-down rasterizers, polar + Cartesian, semantic +
             geometric  (ref: scan_renderer{,_polar}.cpp)
  filter/    the vmapped particle filter: propagate / score / resample /
             stats / GMM  (ref: state_particle.cpp, particle_filter.cpp)
  active/    active-localization goal selection (ref: active_localizer.cpp)
  parallel/  mesh + sharding of the particle axis over ICI
  runtime/   converged-state machine, pose output, host orchestration
             (ref: top_down_render.cpp)
  tools/     offline map refinement (ref: refine_map.cpp)
  io/        replay + benchmark harnesses (ref: scripts/benchmark_*.py)
"""

__version__ = "0.1.0"

from top_down_renderer_tpu.config import (
    ClassConfig,
    FilterParams,
    MapConfig,
    MapParams,
    RuntimeParams,
)

__all__ = [
    "ClassConfig",
    "FilterParams",
    "MapConfig",
    "MapParams",
    "RuntimeParams",
]
