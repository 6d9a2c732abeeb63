"""Offline map refinement.

Capability port of the refine_map tool (/root/reference/src/refine_map.cpp):
accumulate a semantically-labeled 3D occupancy point set into per-class
2D count grids aligned with the original map rasters (loadSemOccGrid,
:56-95), optionally overwrite the exclusive classes by majority vote
(:123-153 - shipped disabled behind `if (false)`; here an explicit flag,
default off for parity), and write a color visualization (:104-169).

Batched: the accumulation over the full trajectory's points is one
jitted scatter-add sweep (BASELINE.json config 5); the reference's VTK
poly-data input becomes a plain points+colors array loaded from npz/ply.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# reference LUT (refine_map.cpp:37-53), stored RGB here (theirs is BGR)
DEFAULT_COLOR_LUT = np.array(
    [
        (255, 255, 255),  # unlabeled
        (0, 100, 0),  # terrain
        (0, 0, 255),  # road
        (255, 0, 255),  # dirt
        (255, 0, 0),  # building
        (0, 255, 0),  # veg
        (0, 255, 255),  # car
    ],
    dtype=np.uint8,
)


@functools.partial(
    jax.jit, static_argnames=("num_classes", "height", "width")
)
def accumulate_counts(
    points: jnp.ndarray,
    classes: jnp.ndarray,
    res: float | jnp.ndarray,
    center_xy: jnp.ndarray,
    num_classes: int,
    height: int,
    width: int,
) -> jnp.ndarray:
    """Jitted sweep: per-cell per-class point counts.

    points: (P, 3) xyz; classes: (P,) int (-1 = drop).
    Binning parity (refine_map.cpp:76-94): ind = floor(p/res) +
    int(center/res); out of bounds and unknown-class points are dropped.
    """
    ix = jnp.floor(points[:, 0] / res).astype(jnp.int32) + (
        center_xy[0] / res
    ).astype(jnp.int32)
    iy = jnp.floor(points[:, 1] / res).astype(jnp.int32) + (
        center_xy[1] / res
    ).astype(jnp.int32)
    ok = (
        (ix >= 0)
        & (ix < width)
        & (iy >= 0)
        & (iy < height)
        & (classes >= 0)
        & (classes < num_classes)
    )
    size = num_classes * height * width
    flat = jnp.where(ok, (classes * height + iy) * width + ix, size)
    hist = jnp.zeros(size, jnp.float32)
    hist = hist.at[flat].add(1.0, mode="drop")
    return hist.reshape(num_classes, height, width)


def load_sem_occ_points(path: str):
    """Load a semantic occupancy point set: .npz with points/colors (or
    points/classes), or an ASCII .ply with x y z r g b."""
    if path.endswith(".npz"):
        data = np.load(path)
        pts = np.asarray(data["points"], np.float32)
        if "classes" in data:
            return pts, np.asarray(data["classes"], np.int32), None
        return pts, None, np.asarray(data["colors"], np.uint8)
    if path.endswith(".ply"):
        with open(path) as f:
            line = f.readline()
            n = 0
            while line and "end_header" not in line:
                if line.startswith("element vertex"):
                    n = int(line.split()[-1])
                line = f.readline()
            rows = np.loadtxt(f, max_rows=n)
        return (
            rows[:, :3].astype(np.float32),
            None,
            rows[:, 3:6].astype(np.uint8),
        )
    raise ValueError(f"unsupported occupancy grid format: {path}")


class MapRefiner:
    """MapRefiner equivalent (refine_map.cpp:12-29)."""

    def __init__(
        self,
        num_classes: int = 6,
        num_exclusive_classes: int = 4,
        color_lut: Optional[np.ndarray] = None,
        res: float = 1.0,
        map_center_xy: Sequence[float] = (0.0, 0.0),
    ):
        self.num_classes = num_classes
        self.num_exclusive = num_exclusive_classes
        self.color_lut = (
            color_lut if color_lut is not None else DEFAULT_COLOR_LUT
        )
        self.res = res
        self.center = np.asarray(map_center_xy, np.float32)

    def classes_from_colors(self, colors: np.ndarray) -> np.ndarray:
        """RGB -> class index 0..num_classes-1 via LUT rows 1..C
        (refine_map.cpp:46-53); unknown colors -> -1 (:91)."""
        packed = (
            colors[:, 0].astype(np.int64) << 16
            | colors[:, 1].astype(np.int64) << 8
            | colors[:, 2].astype(np.int64)
        )
        lut = self.color_lut[1 : self.num_classes + 1]
        lut_packed = (
            lut[:, 0].astype(np.int64) << 16
            | lut[:, 1].astype(np.int64) << 8
            | lut[:, 2].astype(np.int64)
        )
        out = -np.ones(len(colors), np.int32)
        for i, lp in enumerate(lut_packed):
            out[packed == lp] = i
        return out

    def load_original_map(self, path: str) -> np.ndarray:
        """Per-class grayscale pngs (refine_map.cpp:97-102)."""
        from PIL import Image

        maps = []
        for i in range(self.num_classes):
            img = Image.open(os.path.join(path, f"class{i}.png")).convert(
                "L"
            )
            maps.append(np.asarray(img, np.uint8))
        return np.stack(maps)

    def refine(
        self,
        sem_occ_path: str,
        original_map_path: str,
        apply_majority: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full refineMap flow (:171-194).  Returns (refined_maps,
        viz_rgb); writes map_viz.png next to the original maps."""
        from PIL import Image

        original = self.load_original_map(original_map_path)
        pts, classes, colors = load_sem_occ_points(sem_occ_path)
        if classes is None:
            classes = self.classes_from_colors(colors)
        c, h, w = original.shape
        counts = np.asarray(
            accumulate_counts(
                jnp.asarray(pts),
                jnp.asarray(classes),
                self.res,
                jnp.asarray(self.center),
                self.num_classes,
                h,
                w,
            )
        )
        refined = original.copy()
        if apply_majority:
            # the reference's disabled majority-vote block (:123-153)
            ex = counts[: self.num_exclusive]
            best = np.argmax(ex, axis=0)
            best_cnt = np.max(ex, axis=0)
            has = best_cnt > 0
            for cls in range(self.num_exclusive):
                sel = has & (best == cls)
                refined[cls][sel] = 0
                for other in range(self.num_exclusive):
                    if other != cls:
                        refined[other][sel] = 255
            for cls in range(self.num_exclusive, self.num_classes):
                refined[cls][counts[cls] > 0] = 0
                refined[cls][counts[cls] == 0] = 255

        viz = np.zeros((h, w, 3), np.uint8)
        for cls in range(self.num_classes):
            viz[refined[cls] < 255] = self.color_lut[cls + 1]
        Image.fromarray(viz).save(
            os.path.join(original_map_path, "map_viz.png")
        )
        return refined, viz
