"""Host-facing semantic map: loading, preprocessing, device residency.

Capability port of TopDownMap / TopDownMapPolar
(/root/reference/src/top_down_map.cpp, top_down_map_polar.cpp):
  - load an SVG vector map, a color raster (png/jpg), or a cached raster dir
    (ctor, top_down_map.cpp:9-64)
  - rasterize per-class occupancy, build the 2-channel geometric map
    (getGeoRasterMap :410-427)
  - compute per-class truncated distance transforms + unknown mask
    (computeDists :289-326) -- here as a jitted EDT on device
  - metadata-validated preprocessing cache (:226-286) -- here a single npz
  - dynamic map updates from a class-index image (updateMap :146-157)
  - class query at a point (getClassesAtPoint :159-175)
  - polar local-window gather for debug/active-localization
    (top_down_map_polar.cpp:21-76) -- the hot scoring path has its own
    fused implementation in filter/scoring.py

Device layout: the scoring tensor is channel-last
(H, W, C_pad) with the unknown mask folded in as a channel, so one gather
at (y, x) reads every class distance plus the mask in a single vector.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from top_down_renderer_tpu.config import MapParams
from top_down_renderer_tpu.core.grids import SemanticMapGrid
from top_down_renderer_tpu.maps.edt import compute_dists
from top_down_renderer_tpu.maps.polar import polar_stencil
from top_down_renderer_tpu.maps.rasterize import rasterize_map


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_grid(
    class_maps_binary: np.ndarray,
    resolution: float = 1.0,
    trunc_m: float = 50.0,
    num_geo_from: int = 3,
    map_center: Tuple[int, int] = (0, 0),
) -> SemanticMapGrid:
    """Build the device-resident SemanticMapGrid from binary class maps
    ((C, H, W), 0 inside class / 1 outside)."""
    class_maps_binary = np.asarray(class_maps_binary, dtype=np.float32)
    c, h, w = class_maps_binary.shape

    # geometric 2-channel map (getGeoRasterMap, top_down_map.cpp:410-427)
    geo1 = np.zeros((h, w), dtype=np.float32)
    for i in range(num_geo_from, c):
        geo1 += 1.0 - class_maps_binary[i]
    geo1 = 1.0 - np.minimum(geo1, 1.0)  # 0 where elevated class present
    geo0 = 1.0 - geo1
    geo_binary = np.stack([geo0, geo1])

    dists, mask = compute_dists(
        jnp.asarray(class_maps_binary), resolution=resolution, trunc_m=trunc_m
    )
    geo_dists, _ = compute_dists(
        jnp.asarray(geo_binary), resolution=resolution, trunc_m=trunc_m
    )

    dists = np.asarray(dists)
    mask = np.asarray(mask)

    # channel-last packed scoring tensor: [dist_0..dist_{C-1}, known, pad...]
    c_pad = _round_up(c + 1, 8)
    packed = np.zeros((h, w, c_pad), dtype=np.float32)
    packed[..., :c] = np.moveaxis(dists, 0, -1)
    packed[..., c] = 1.0 - mask.astype(np.float32)  # known-space indicator

    # road presence for particle init: getClassesAtPoint reports a class
    # when its (post-EDT) map value is < 1 (top_down_map.cpp:165;
    # state_particle.cpp:28-31 checks for class 1 = road).  Unknown cells
    # have dist 0 and therefore count as road - reference quirk preserved.
    road_ok = dists[1] < 1.0 if c > 1 else dists[0] < 1.0

    geo_packed = np.moveaxis(np.asarray(geo_dists), 0, -1)

    return SemanticMapGrid(
        dist=jnp.asarray(packed),
        geo_dist=jnp.asarray(geo_packed),
        mask=jnp.asarray(mask),
        road_ok=jnp.asarray(road_ok),
        map_center=jnp.asarray(map_center, dtype=jnp.int32),
        resolution=float(resolution),
        num_classes=int(c),
    )


def class_maps_from_index_image(
    ind_img: np.ndarray,
    flatten_lut: np.ndarray,
    num_classes: int,
    resolution: float = 1.0,
) -> np.ndarray:
    """loadCompressedRasterMap parity (top_down_map.cpp:116-144).

    ind_img: (H_img, W_img) uint8 raw class indices in *image* coordinates
    (row 0 at top).  Output class maps are bottom-up (row 0 at bottom):
      src_row = max(img_h - yi*res - 1, 0), src_col = min(xi*res, img_w-1).
    """
    img_h, img_w = ind_img.shape
    h = int(img_h / resolution)
    w = int(img_w / resolution)
    yi = np.arange(h)
    xi = np.arange(w)
    src_r = np.maximum(img_h - (yi * resolution).astype(np.int64) - 1, 0)
    src_c = np.minimum((xi * resolution).astype(np.int64), img_w - 1)
    raw = ind_img[src_r[:, None], src_c[None, :]]
    flat = flatten_lut[raw]  # (h, w), -1 for unused classes
    maps = np.ones((num_classes, h, w), dtype=np.float32)
    for cls in range(num_classes):
        maps[cls][flat == cls] = 0.0
    return maps


class TopDownMap:
    """TopDownMap + TopDownMapPolar equivalent."""

    def __init__(self, params: MapParams):
        self.params = params
        self.have_map = False
        self.grid: Optional[SemanticMapGrid] = None
        self.class_maps_binary: Optional[np.ndarray] = None
        self._map_center = np.zeros(2, dtype=np.int64)
        # default polar stencil 100x50 (top_down_map_polar.cpp:3-5); the
        # node overrides to 100x25 (top_down_render.cpp:115)
        self.sample_pts_polar(theta_bins=100, range_bins=50)

        if not params.map_path:
            return  # dynamic-map case: wait for update_map

        if self._load_cache():
            return

        path = params.map_path
        if path.endswith(".svg"):
            self._load_svg(path)
        elif path.endswith(".png") or path.endswith(".jpg"):
            self._load_color_raster(path)
        else:
            self._load_raster_dir(path)

        if self.class_maps_binary is not None:
            self.grid = build_grid(
                self.class_maps_binary, resolution=params.resolution,
                trunc_m=params.dist_trunc_m,
            )
            self.have_map = True
            self._save_cache()

    # ------------------------------------------------------------------
    # loading paths
    # ------------------------------------------------------------------
    def _load_svg(self, path: str) -> None:
        from top_down_renderer_tpu.maps.svg import load_svg

        cc = self.params.class_config
        assert cc is not None, "SVG loading requires class_config"
        (w, h), polys = load_svg(
            path, cc.color_lut, cc.flatten_lut(), self.params.num_classes
        )
        maps = rasterize_map(
            polys,
            (w, h),
            resolution=self.params.resolution,
            exclusive_classes=self.params.exclusive_classes,
        )
        self.class_maps_binary = np.asarray(maps)
        # saveRasterizedMaps parity (top_down_map.cpp:30,197-211)
        self._save_raster_dir(path[:-4] + "_raster_cache")

    def _load_color_raster(self, path: str) -> None:
        from PIL import Image

        cc = self.params.class_config
        assert cc is not None, "raster loading requires class_config"
        img = np.asarray(Image.open(path).convert("RGB"))
        ind = cc.color_to_ind(img)
        self.class_maps_binary = class_maps_from_index_image(
            ind,
            self.params.flatten_lut
            if self.params.flatten_lut is not None
            else cc.flatten_lut(),
            self.params.num_classes,
            self.params.resolution,
        )

    def _load_raster_dir(self, path: str) -> None:
        """loadRasterizedMaps parity (top_down_map.cpp:213-224): per-class
        grayscale pngs, stored flipped (row 0 at top)."""
        from PIL import Image

        maps = []
        for i in range(self.params.num_classes):
            img = np.asarray(
                Image.open(os.path.join(path, f"class{i}.png")).convert("L"),
                dtype=np.float32,
            )
            maps.append(img[::-1] / 255.0)  # flip back to bottom-up
        self.class_maps_binary = np.stack(maps)

    def _save_raster_dir(self, path: str) -> None:
        from PIL import Image

        os.makedirs(path, exist_ok=True)
        for i, m in enumerate(self.class_maps_binary):
            img = (m[::-1] * 255).astype(np.uint8)  # flip like the input map
            Image.fromarray(img).save(os.path.join(path, f"class{i}.png"))

    # ------------------------------------------------------------------
    # preprocessing cache (parity: top_down_map.cpp:226-286)
    # ------------------------------------------------------------------
    def _cache_file(self) -> Optional[str]:
        if not self.params.cache_dir:
            return None
        return os.path.join(self.params.cache_dir, "map_cache.npz")

    def _load_cache(self) -> bool:
        f = self._cache_file()
        if not f or not os.path.exists(f):
            return False
        data = np.load(f, allow_pickle=False)
        if (
            str(data["map_path"]) != self.params.map_path
            or int(data["num_classes"]) != self.params.num_classes
            or abs(float(data["resolution"]) - self.params.resolution) > 0.01
        ):
            return False
        self.class_maps_binary = data["class_maps_binary"]
        self.grid = SemanticMapGrid(
            dist=jnp.asarray(data["dist"]),
            geo_dist=jnp.asarray(data["geo_dist"]),
            mask=jnp.asarray(data["mask"]),
            road_ok=jnp.asarray(data["road_ok"]),
            map_center=jnp.asarray(data["map_center"]),
            resolution=float(data["resolution"]),
            num_classes=int(data["num_classes"]),
        )
        self.have_map = True
        return True

    def _save_cache(self) -> None:
        f = self._cache_file()
        if not f or self.grid is None:
            return
        os.makedirs(self.params.cache_dir, exist_ok=True)
        np.savez_compressed(
            f,
            map_path=self.params.map_path,
            num_classes=self.params.num_classes,
            resolution=self.params.resolution,
            class_maps_binary=self.class_maps_binary,
            dist=np.asarray(self.grid.dist),
            geo_dist=np.asarray(self.grid.geo_dist),
            mask=np.asarray(self.grid.mask),
            road_ok=np.asarray(self.grid.road_ok),
            map_center=np.asarray(self.grid.map_center),
        )

    # ------------------------------------------------------------------
    # queries (parity: top_down_map.cpp:159-195)
    # ------------------------------------------------------------------
    def size(self) -> np.ndarray:
        """(width, height) px, TopDownMap::size (top_down_map.cpp:181-183)."""
        if self.grid is None:
            return np.zeros(2, dtype=np.int64)
        return np.array([self.grid.width, self.grid.height], dtype=np.int64)

    def map_center(self) -> np.ndarray:
        return np.asarray(self.grid.map_center) if self.grid is not None \
            else self._map_center

    @property
    def num_classes(self) -> int:
        return self.params.num_classes

    @property
    def resolution(self) -> float:
        return self.params.resolution

    def get_classes_at_point(self, xy_px: Sequence[float]) -> List[int]:
        """getClassesAtPoint (top_down_map.cpp:159-170): classes whose
        post-EDT map value at the point is < 1."""
        if self.grid is None:
            return []
        x = int(float(xy_px[0]) / self.params.resolution)
        y = int(float(xy_px[1]) / self.params.resolution)
        if not (0 <= x < self.grid.width and 0 <= y < self.grid.height):
            return []
        vals = np.asarray(self.grid.dist[y, x, : self.num_classes])
        return [int(c) for c in np.nonzero(vals < 1.0)[0]]

    # ------------------------------------------------------------------
    # dynamic map update (parity: top_down_map.cpp:146-157,
    # particle_filter.cpp:320-341 handles the particle shift)
    # ------------------------------------------------------------------
    def update_map(
        self, ind_img: np.ndarray, map_center: Sequence[int]
    ) -> None:
        cc = self.params.class_config
        flut = (
            self.params.flatten_lut
            if self.params.flatten_lut is not None
            else (cc.flatten_lut() if cc else np.arange(256))
        )
        self.class_maps_binary = class_maps_from_index_image(
            np.asarray(ind_img),
            np.asarray(flut),
            self.params.num_classes,
            self.params.resolution,
        )
        # have_map check parity (top_down_map.cpp:150-154): warn only if the
        # road channel is identically zero (i.e. road literally everywhere)
        if np.any(self.class_maps_binary[1] != 0):
            self.have_map = True
        self.grid = build_grid(
            self.class_maps_binary,
            resolution=self.params.resolution,
            trunc_m=self.params.dist_trunc_m,
            map_center=(int(map_center[0]), int(map_center[1])),
        )

    # ------------------------------------------------------------------
    # polar stencil + local-window gather (top_down_map_polar.cpp)
    # ------------------------------------------------------------------
    def sample_pts_polar(
        self, theta_bins: int, range_bins: int, ang_res: float | None = None
    ) -> None:
        self.stencil = polar_stencil(
            theta_bins, range_bins, ang_res, self.params.resolution
        )

    def get_local_map(
        self, center_xy_px: Sequence[float], scale: float, res: float
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host/debug polar gather: returns (dists (C, Th, R), mask (Th, R)).

        Parity: TopDownMapPolar::getLocalMap (top_down_map_polar.cpp:21-53):
        nearest-neighbor round, out-of-bounds -> dist 0 / mask 1.
        """
        g = self.grid
        pts = self.stencil * (scale * res)
        rows = np.rint(
            pts[..., 0] + center_xy_px[1] / self.params.resolution
        ).astype(np.int64)
        cols = np.rint(
            pts[..., 1] + center_xy_px[0] / self.params.resolution
        ).astype(np.int64)
        valid = (
            (rows >= 0) & (rows < g.height) & (cols >= 0) & (cols < g.width)
        )
        rc = np.clip(rows, 0, g.height - 1)
        cc_ = np.clip(cols, 0, g.width - 1)
        packed = np.asarray(g.dist)[rc, cc_]  # (Th, R, C_pad)
        dists = np.where(
            valid[..., None], packed[..., : self.num_classes], 0.0
        )
        known = np.where(valid, packed[..., self.num_classes], 0.0)
        mask = 1.0 - known  # 1 = unknown or out of bounds
        return np.moveaxis(dists, -1, 0), mask

    def get_local_map_cartesian(
        self,
        center_xy_px: Sequence[float],
        rot: float,
        res: float,
        h: int,
        w: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Rotated Cartesian local-window gather
        (TopDownMap::getLocalMap, top_down_map.cpp:429-459): an (h, w)
        grid of samples centered on `center`, rotated by `rot`, spaced
        `res`; out-of-bounds -> dist 0 / mask 1.

        Returns (dists (C, h, w), mask (h, w))."""
        g = self.grid
        # samplePts grid (top_down_map.cpp:367-389): row coord first
        yy = res * (np.arange(h) - (h - 1) / 2.0)
        xx = res * (np.arange(w) - (w - 1) / 2.0)
        py, px = np.meshgrid(yy, xx, indexing="ij")
        c, s = math.cos(rot), math.sin(rot)
        ry = c * py - s * px
        rx = s * py + c * px
        rows = np.rint(
            ry + center_xy_px[1] / self.params.resolution
        ).astype(np.int64)
        cols = np.rint(
            rx + center_xy_px[0] / self.params.resolution
        ).astype(np.int64)
        valid = (
            (rows >= 0) & (rows < g.height) & (cols >= 0) & (cols < g.width)
        )
        rc = np.clip(rows, 0, g.height - 1)
        cc_ = np.clip(cols, 0, g.width - 1)
        packed = np.asarray(g.dist)[rc, cc_]
        dists = np.where(
            valid[..., None], packed[..., : self.num_classes], 0.0
        )
        mask = np.where(
            valid, 1.0 - packed[..., self.num_classes], 1.0
        )
        return np.moveaxis(dists, -1, 0), mask

    def get_local_geo_map(
        self, center_xy_px: Sequence[float], scale: float, res: float
    ) -> np.ndarray:
        """TopDownMapPolar::getLocalGeoMap (top_down_map_polar.cpp:55-76)."""
        g = self.grid
        pts = self.stencil * (scale * res)
        rows = np.rint(
            pts[..., 0] + center_xy_px[1] / self.params.resolution
        ).astype(np.int64)
        cols = np.rint(
            pts[..., 1] + center_xy_px[0] / self.params.resolution
        ).astype(np.int64)
        valid = (
            (rows >= 0) & (rows < g.height) & (cols >= 0) & (cols < g.width)
        )
        rc = np.clip(rows, 0, g.height - 1)
        cc_ = np.clip(cols, 0, g.width - 1)
        geo = np.asarray(g.geo_dist)[rc, cc_]  # (Th, R, 2)
        geo = np.where(valid[..., None], geo, 0.0)
        return np.moveaxis(geo, -1, 0)
