"""Semantic top-down scan rasterizers (the live sensor model).

Parity ports of:
  ScanRendererPolar::renderSemanticTopDown
    (/root/reference/src/scan_renderer_polar.cpp:83-109)
  ScanRenderer::renderSemanticTopDown
    (/root/reference/src/scan_renderer.cpp:55-78)

Batched design: the reference's per-point scatter loop becomes one fused
scatter-add into a flattened (C*Theta*R) histogram with mode='drop' handling
every bounds/validity case, jitted with static shapes.  Points are a padded
(P, 4) array (x, y, z, class); the reference's "skip x==0 && y==0" sentinel
(scan_renderer_polar.cpp:95) doubles as the padding convention.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit,
    static_argnames=("num_classes", "theta_bins", "range_bins"),
)
def render_semantic_polar(
    points: jnp.ndarray,
    flatten_lut: jnp.ndarray,
    res: float | jnp.ndarray,
    ang_res: float | jnp.ndarray,
    num_classes: int,
    theta_bins: int = 100,
    range_bins: int = 25,
) -> jnp.ndarray:
    """Scatter-add point counts into per-class polar (theta, r) grids.

    points: (P, 4) float32 - x, y, z, raw class id (the reference reads the
            class from the PointXYZI intensity field, scan_renderer.cpp:72).
    Returns (num_classes, theta_bins, range_bins) float32.

    Binning parity (scan_renderer_polar.cpp:93-107):
      theta = atan2(x, y); r = hypot(x, y)
      theta_ind = round(theta/ang_res) + Theta/2 ; r_ind = round(r/res)
    """
    x, y = points[:, 0], points[:, 1]
    cls_raw = points[:, 3].astype(jnp.int32)
    valid = ~((x == 0) & (y == 0))

    theta = jnp.arctan2(x, y)
    r = jnp.sqrt(x * x + y * y)
    theta_ind = (
        jnp.round(theta / ang_res).astype(jnp.int32) + theta_bins // 2
    )
    r_ind = jnp.round(r / res).astype(jnp.int32)

    flat_cls = flatten_lut[jnp.clip(cls_raw, 0, 255)]
    ok = (
        valid
        & (theta_ind >= 0)
        & (theta_ind < theta_bins)
        & (r_ind >= 0)
        & (r_ind < range_bins)
        & (flat_cls >= 0)
        & (flat_cls < num_classes)
    )
    size = num_classes * theta_bins * range_bins
    # dropped points get an out-of-bounds index (mode='drop'); -1 would
    # wrap to the last cell under JAX's negative-index semantics
    flat_idx = jnp.where(
        ok,
        (flat_cls * theta_bins + theta_ind) * range_bins + r_ind,
        size,
    )
    hist = jnp.zeros(size, jnp.float32)
    hist = hist.at[flat_idx].add(1.0, mode="drop")
    return hist.reshape(num_classes, theta_bins, range_bins)


@functools.partial(
    jax.jit, static_argnames=("num_classes", "width", "height")
)
def render_semantic_cartesian(
    points: jnp.ndarray,
    flatten_lut: jnp.ndarray,
    res: float | jnp.ndarray,
    num_classes: int,
    width: int,
    height: int,
) -> jnp.ndarray:
    """Cartesian semantic top-down render (scan_renderer.cpp:55-78).

    Returns (num_classes, height, width): imgs[c][y_ind, x_ind] counts with
      x_ind = round(x/res) + W/2 ; y_ind = round(y/res) + H/2.
    """
    x, y = points[:, 0], points[:, 1]
    cls_raw = points[:, 3].astype(jnp.int32)
    valid = ~((x == 0) & (y == 0))

    x_ind = jnp.round(x / res).astype(jnp.int32) + width // 2
    y_ind = jnp.round(y / res).astype(jnp.int32) + height // 2
    flat_cls = flatten_lut[jnp.clip(cls_raw, 0, 255)]
    ok = (
        valid
        & (x_ind >= 0)
        & (x_ind < width)
        & (y_ind >= 0)
        & (y_ind < height)
        & (flat_cls >= 0)
        & (flat_cls < num_classes)
    )
    size = num_classes * height * width
    flat_idx = jnp.where(
        ok, (flat_cls * height + y_ind) * width + x_ind, size
    )
    hist = jnp.zeros(size, jnp.float32)
    hist = hist.at[flat_idx].add(1.0, mode="drop")
    return hist.reshape(num_classes, height, width)
