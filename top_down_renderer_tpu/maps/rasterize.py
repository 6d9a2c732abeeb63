"""Jitted even-odd polygon rasterization.

Parity port of TopDownMap::getClasses / samplePts / getRasterMap
(/root/reference/src/top_down_map.cpp:328-408): fills per-class occupancy
maps (0 inside a class polygon, 1 outside) from SVG polygon lists using the
even-odd rule, including the exclusive-class resolution (:357-364).

Batched design: instead of the reference's per-polygon Eigen loop over a
flattened pixel array, we batch pixels x edges.  Edges are concatenated per
class into one padded (E, 5) table (x0, y0, x1, y1, poly_id); the parity
accumulator XORs crossings per (pixel, polygon) using a segment-sum over
poly ids, all under jit, with pixel-row chunking to bound memory.

The reference's vectorized crossing test (top_down_map.cpp:343-345):
  crossing = (py < y_i) != (py < y_j)  &&  px < x_i + (x_j-x_i)*(py-y_i)/(y_j-y_i)
where "px" is pts.row(1) (x/col coordinate) and "py" is pts.row(0) (y/row).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pack_polygons(
    polys: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a list of (V_i, 2) float polygons (x, y vertices) into a single
    edge table.

    Returns (edges (E, 4) float32 [x0, y0, x1, y1], poly_ids (E,) int32).
    Edge i of polygon p connects vertex i to vertex (i-1) mod V_p, matching
    the reference's j = i-1 wraparound (top_down_map.cpp:340-347).
    """
    all_edges = []
    all_ids = []
    for pid, poly in enumerate(polys):
        poly = np.asarray(poly, dtype=np.float32)
        v = poly.shape[0]
        if v < 3:
            continue
        prev = np.roll(np.arange(v), 1)
        e = np.concatenate([poly, poly[prev]], axis=1)  # (V, 4)
        all_edges.append(e)
        all_ids.append(np.full(v, pid, dtype=np.int32))
    if not all_edges:
        return (
            np.zeros((0, 4), dtype=np.float32),
            np.zeros((0,), dtype=np.int32),
        )
    return np.concatenate(all_edges), np.concatenate(all_ids)


def _pixel_coords(h: int, w: int, resolution: float, map_size_xy):
    """Pixel-center sample coordinates, parity with samplePts
    (top_down_map.cpp:367-389) at rot=0, center=map_size/2:
      py[k] = center_y - res*(H-1)/2 + res*k   (k = row index)
      px[k] = center_x - res*(W-1)/2 + res*k   (k = col index)
    """
    cy = map_size_xy[1] / 2.0
    cx = map_size_xy[0] / 2.0
    py = cy + resolution * (jnp.arange(h, dtype=jnp.float32) - (h - 1) / 2.0)
    px = cx + resolution * (jnp.arange(w, dtype=jnp.float32) - (w - 1) / 2.0)
    return py, px


@functools.partial(
    jax.jit, static_argnames=("h", "w", "n_polys", "resolution")
)
def rasterize_class(
    edges: jnp.ndarray,
    poly_ids: jnp.ndarray,
    map_size_xy: jnp.ndarray,
    h: int,
    w: int,
    n_polys: int,
    resolution: float = 1.0,
) -> jnp.ndarray:
    """Rasterize one class: (H, W) float32, 0 inside any polygon, 1 outside.

    A pixel is inside the class if it is inside ANY of the class's polygons
    by the even-odd rule (the reference's per-polygon buf + max reduction,
    top_down_map.cpp:339-349).
    """
    py_all, px_all = _pixel_coords(h, w, resolution, map_size_xy)
    e = edges  # (E, 4): x0 y0 x1 y1 (x_i, y_i, x_j, y_j)
    xi, yi, xj, yj = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    denom = yj - yi
    safe_denom = jnp.where(denom == 0, jnp.float32(1.0), denom)

    def row_fn(py):
        # py: scalar row coordinate; returns (W,) parity-per-pixel
        straddle = (py < yi) != (py < yj)  # (E,)
        xint = xi + (xj - xi) * (py - yi) / safe_denom  # (E,)
        # crossing[e, px] = straddle[e] & (px < xint[e])
        cross = straddle[:, None] & (px_all[None, :] < xint[:, None])
        # per-polygon parity: segment-XOR over edges of the same polygon
        per_poly = jax.ops.segment_sum(
            cross.astype(jnp.int32), poly_ids, num_segments=n_polys
        )  # (P, W)
        inside_any = jnp.any(per_poly % 2 == 1, axis=0)  # (W,)
        return jnp.where(inside_any, jnp.float32(0.0), jnp.float32(1.0))

    return jax.lax.map(row_fn, py_all, batch_size=32)


def apply_exclusive(
    class_maps: jnp.ndarray, exclusive_classes: Sequence[int]
) -> jnp.ndarray:
    """Exclusive-class resolution: only one ground type per cell; higher
    exclusive class ids override lower ones.

    Parity: top_down_map.cpp:357-364 (maps are 0-inside/1-outside, so adding
    (1 - higher) marks the cell not-present in the lower class).
    """
    maps = list(class_maps)
    for under in exclusive_classes:
        for cls in exclusive_classes:
            if under < cls:
                maps[under] = maps[under] + (1.0 - maps[cls])
        maps[under] = jnp.minimum(maps[under], 1.0)
    return jnp.stack(maps)


def rasterize_map(
    polys_per_class: List[List[np.ndarray]],
    map_size_xy: Tuple[float, float],
    resolution: float = 1.0,
    exclusive_classes: Sequence[int] = (),
) -> jnp.ndarray:
    """Full map rasterization (getRasterMap, top_down_map.cpp:391-408).

    polys_per_class: per flattened class, list of (V, 2) (x, y) vertex
    arrays in SVG coordinates (already y-flipped by the loader).
    Returns (C, H, W) float32 class maps, 0 inside / 1 outside.
    """
    h = int(map_size_xy[1] / resolution)
    w = int(map_size_xy[0] / resolution)
    size = jnp.asarray(map_size_xy, dtype=jnp.float32)
    out = []
    for polys in polys_per_class:
        edges, ids = pack_polygons(polys)
        n_polys = int(ids.max()) + 1 if ids.size else 1
        if edges.shape[0] == 0:
            out.append(jnp.ones((h, w), dtype=jnp.float32))
            continue
        out.append(
            rasterize_class(
                jnp.asarray(edges),
                jnp.asarray(ids),
                size,
                h,
                w,
                n_polys,
                resolution,
            )
        )
    maps = jnp.stack(out)
    if exclusive_classes:
        maps = apply_exclusive(maps, exclusive_classes)
    return maps
