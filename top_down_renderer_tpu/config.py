"""Configuration surface.

Mirrors the reference's parameter system with the same names and defaults:
  - ROS params declared in /root/reference/src/top_down_render.cpp:10-60,192-244
  - FilterParams struct (include/top_down_render/state_particle.h:19-38)
  - TopDownMap::Params (include/top_down_render/top_down_map.h:54-62)
  - semantics_manager ClassConfig/MapConfig (external pkg; usage at
    top_down_render.cpp:32-34,56-62,173-180,235-241)

Implemented as plain dataclasses + YAML loaders (no ROS parameter server).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

INF = float("inf")


@dataclasses.dataclass
class ClassConfig:
    """Semantic class configuration (semantics_manager ClassConfig equivalent).

    color_lut maps flattened-class-independent raw class index -> RGB color.
    class_to_flattened maps raw class id -> flattened (localization) class id,
    with -1 meaning "drop this class".  flattened_to_class is the inverse
    (one representative raw id per flattened class).
    """

    # raw class id -> (r, g, b)
    color_lut: np.ndarray  # (256, 3) uint8
    class_to_flattened: List[int]
    flattened_to_class: List[int]
    exclusivity: List[bool]  # indexed by raw class id
    loc_weight: List[float]  # indexed by raw class id

    @property
    def num_classes(self) -> int:
        return len(self.flattened_to_class)

    def flatten_lut(self) -> np.ndarray:
        """256-entry raw-class -> flattened-class LUT, -1 = unused.

        Parity: top_down_render.cpp:56-62.
        """
        lut = -np.ones(256, dtype=np.int32)
        for raw, flat in enumerate(self.class_to_flattened):
            lut[raw] = flat
        return lut

    def unflatten_lut(self) -> np.ndarray:
        return np.asarray(self.flattened_to_class, dtype=np.int32)

    def class_weights(self) -> np.ndarray:
        """Per-flattened-class localization weights.

        Parity: top_down_render.cpp:239-241.
        """
        return np.asarray(
            [self.loc_weight[cid] for cid in self.flattened_to_class],
            dtype=np.float32,
        )

    def exclusive_classes(self) -> List[int]:
        """Flattened ids of mutually-exclusive ground classes.

        Parity: top_down_render.cpp:177-182.
        """
        out = []
        for class_id in self.flattened_to_class:
            if self.exclusivity[class_id]:
                out.append(self.class_to_flattened[class_id])
        return out

    def color_to_ind(self, img_rgb: np.ndarray) -> np.ndarray:
        """RGB image -> raw class index image (SemanticColorLut::color2Ind)."""
        packed = (
            img_rgb[..., 0].astype(np.uint32) << 16
            | img_rgb[..., 1].astype(np.uint32) << 8
            | img_rgb[..., 2].astype(np.uint32)
        )
        lut_packed = (
            self.color_lut[:, 0].astype(np.uint32) << 16
            | self.color_lut[:, 1].astype(np.uint32) << 8
            | self.color_lut[:, 2].astype(np.uint32)
        )
        # map packed colors to indices; unknown colors -> 255
        order = np.argsort(lut_packed, kind="stable")
        sorted_packed = lut_packed[order]
        pos = np.searchsorted(sorted_packed, packed)
        pos = np.clip(pos, 0, len(sorted_packed) - 1)
        hit = sorted_packed[pos] == packed
        ind = np.where(hit, order[pos], 255).astype(np.uint8)
        return ind

    def ind_to_color(self, ind_img: np.ndarray) -> np.ndarray:
        """Raw class index image -> RGB (SemanticColorLut::ind2Color)."""
        return self.color_lut[ind_img]

    @staticmethod
    def from_yaml(path: str) -> "ClassConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        classes = data["classes"]
        n = len(classes)
        color_lut = np.full((256, 3), 255, dtype=np.uint8)
        class_to_flattened: List[int] = []
        exclusivity: List[bool] = []
        loc_weight: List[float] = []
        for i, cls in enumerate(classes):
            color_lut[i] = cls.get("color", [255, 255, 255])
            class_to_flattened.append(int(cls.get("flattened_id", i)))
            exclusivity.append(bool(cls.get("exclusive", False)))
            loc_weight.append(float(cls.get("loc_weight", 1.0)))
        num_flat = max(class_to_flattened) + 1
        flattened_to_class = [0] * num_flat
        for raw in range(n - 1, -1, -1):
            flat = class_to_flattened[raw]
            if flat >= 0:
                flattened_to_class[flat] = raw
        return ClassConfig(
            color_lut=color_lut,
            class_to_flattened=class_to_flattened,
            flattened_to_class=flattened_to_class,
            exclusivity=exclusivity,
            loc_weight=loc_weight,
        )


@dataclasses.dataclass
class MapConfig:
    """semantics_manager MapConfig equivalent."""

    dynamic: bool = False
    svg_path: str = ""
    raster_path: str = ""
    viz_path: str = ""
    resolution: float = -1.0  # px/m of the map == filter fixed_scale

    @staticmethod
    def from_yaml(path: str) -> "MapConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        return MapConfig(
            dynamic=bool(data.get("dynamic", False)),
            svg_path=str(data.get("svg_path", "")),
            raster_path=str(data.get("raster_path", "")),
            viz_path=str(data.get("viz_path", "")),
            resolution=float(data.get("resolution", -1.0)),
        )


@dataclasses.dataclass
class MapParams:
    """TopDownMap::Params equivalent (top_down_map.h:54-62).

    `resolution` is the map scale factor, fixed to 1 in the reference
    (top_down_render.cpp:184-186).
    """

    map_path: str = ""
    num_classes: int = 6
    resolution: float = 1.0
    out_of_bounds_const: float = 0.0
    flatten_lut: Optional[np.ndarray] = None  # raw->flattened, len 256
    exclusive_classes: Sequence[int] = ()
    class_config: Optional[ClassConfig] = None
    # EDT truncation in meters (top_down_map.cpp:315)
    dist_trunc_m: float = 50.0
    cache_dir: str = ""  # "" = no cache; parity with ~/.ros/xview_cache


@dataclasses.dataclass
class FilterParams:
    """FilterParams equivalent (state_particle.h:19-38) with the reference's
    defaults from top_down_render.cpp:192-244."""

    pos_cov: float = 0.3
    theta_cov: float = math.pi / 100
    regularization: float = 0.15

    init_pos_px_x: float = -1.0
    init_pos_px_y: float = -1.0
    init_pos_px_cov: float = -1.0

    init_pos_m_x: float = INF
    init_pos_m_y: float = INF
    init_pos_deg_theta: float = INF
    init_pos_deg_cov: float = 10.0

    force_on_map: bool = False
    fixed_scale: float = -1.0
    scale_log_min: float = -0.1
    scale_log_max: float = 1.0

    class_weights: Sequence[float] = ()

    # --- static-shape knobs (no reference equivalent) ---
    # number of theta hypotheses in the uninitialized rotation search
    # (state_particle.cpp:197: 40 steps of 2*pi/40)
    num_rot_search: int = 40


@dataclasses.dataclass
class RuntimeParams:
    """Runtime/orchestrator parameters (top_down_render.cpp:10-60)."""

    use_motion_prior: bool = False
    particle_count: int = 20000
    range_scale_min: float = 0.5
    range_scale_max: float = 4.0
    target_uncertainty_m: float = 2.5
    conf_factor: float = 1.0
    map_frame: str = "map"
    map_viz_frame: str = "sem_map"
    svg_origin_x: int = 0
    svg_origin_y: int = 0
    map_pub_resolution: float = 1.0
    # polar scan/stencil window (top_down_render.cpp:115,528-536)
    theta_bins: int = 100
    range_bins: int = 25
    # GMM refresh: every k filter steps (replaces the reference's 1 Hz
    # background thread, particle_filter.cpp:245-250; at ~10 Hz scans the
    # reference recomputes roughly every 10th update)
    gmm_every: int = 10
    # multi-chip: shard the particle axis over the first N devices
    # (parallel/sharding.py; 0 = single-chip).  The reference's analog
    # is its TBB thread pool (particle_filter.cpp:104-105)
    mesh_devices: int = 0
    # publish pose from the freshest COMPLETED filter step (<= one scan
    # stale) instead of blocking on the in-flight step - the low-latency
    # serving mode.  Default off: the published pose reflects the scan
    # it is stamped with (what the accuracy benchmarks measure).
    async_publish: bool = False


def ang_res(theta_bins: int = 100) -> float:
    return 2.0 * math.pi / theta_bins
