"""Geometric (slope-based) top-down scan rasterizers.

Parity ports of:
  ScanRendererPolar::renderGeometricTopDown
    (/root/reference/src/scan_renderer_polar.cpp:6-81)
  ScanRenderer::renderGeometricTopDown
    (/root/reference/src/scan_renderer.cpp:7-53)

Both are computed-but-disabled in the reference's live path
(top_down_render.cpp:540, state_particle.cpp:145-152) but are part of the
capability surface.

Batched derivation: the reference walks each theta-bin (sorted far->near)
or each organized-cloud column with a `last_high_grad` carry.  Inspection of
the branch structure (scan_renderer_polar.cpp:62-75) shows the carry
collapses: after processing a point, last_high_grad == (slope > 1) for that
point in every case.  So the walk is data-parallel:
  obstacle event at i  <=>  slope_i > 1
  ground   event at i  <=>  slope_i < 0.3  and not (slope_{i-1} > 1)
with slopes taken between consecutive points (per bin/column, reset at
boundaries).  Range-fills become difference-array scatters + a cumsum, and
line-interp fills become a bounded fan-out scatter - all fused under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(
    jax.jit, static_argnames=("theta_bins", "range_bins")
)
def render_geometric_polar(
    points: jnp.ndarray,
    res: float | jnp.ndarray,
    ang_res: float | jnp.ndarray,
    theta_bins: int = 100,
    range_bins: int = 25,
) -> jnp.ndarray:
    """Polar geometric render -> (2, theta_bins, range_bins):
    channel 0 = ground coverage, channel 1 = vertical obstacles."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    valid = ~((x == 0) & (y == 0))
    theta = jnp.arctan2(x, y)
    r = jnp.sqrt(x * x + y * y)
    # clamped theta bin (scan_renderer_polar.cpp:36-37)
    theta_ind = jnp.clip(
        jnp.round(theta / ang_res).astype(jnp.int32) + theta_bins // 2,
        0,
        theta_bins - 1,
    )
    theta_ind = jnp.where(valid, theta_ind, theta_bins)  # invalid sort last

    # sort by (theta_ind asc, r desc) - the reference sorts each bin
    # descending in r (scan_renderer_polar.cpp:49-51)
    order = jnp.lexsort((-r, theta_ind))
    xs, ys, zs = x[order], y[order], z[order]
    rs = r[order]
    tb = theta_ind[order]
    vs = valid[order]
    r_ind = jnp.round(rs / res).astype(jnp.int32)

    # previous point within the same bin (else the (0,0,0) walk origin)
    same = jnp.concatenate(
        [jnp.array([False]), (tb[1:] == tb[:-1]) & vs[:-1]]
    )
    px = jnp.where(same, jnp.roll(xs, 1), 0.0)
    py = jnp.where(same, jnp.roll(ys, 1), 0.0)
    pz = jnp.where(same, jnp.roll(zs, 1), 0.0)
    prev_r_ind = jnp.where(same, jnp.roll(r_ind, 1), 0)

    dist = jnp.sqrt((xs - px) ** 2 + (ys - py) ** 2)
    slope = jnp.abs(zs - pz) / dist  # IEEE inf/nan semantics as reference
    prev_slope = jnp.where(same, jnp.roll(slope, 1), 0.0)
    last_high_grad = same & (prev_slope > 1.0)

    obstacle = vs & (slope > 1.0) & (r_ind >= 0) & (r_ind < range_bins)
    ground = vs & (slope < 0.3) & ~last_high_grad

    # dropped events use an out-of-bounds index; -1 would wrap
    img1 = jnp.zeros(theta_bins * range_bins, jnp.float32)
    obs_idx = jnp.where(
        obstacle, tb * range_bins + r_ind, theta_bins * range_bins
    )
    img1 = img1.at[obs_idx].add(1.0, mode="drop")

    # ground span fill [prev_r_ind, r_ind] clipped to < range_bins
    # (scan_renderer_polar.cpp:67-72) via difference array + cumsum
    start = prev_r_ind
    end = jnp.minimum(r_ind, range_bins - 1)
    has_span = ground & (start <= end) & (start < range_bins)
    dsize = theta_bins * (range_bins + 1)
    diff = jnp.zeros(dsize, jnp.float32)
    s_idx = jnp.where(has_span, tb * (range_bins + 1) + start, dsize)
    e_idx = jnp.where(has_span, tb * (range_bins + 1) + end + 1, dsize)
    diff = diff.at[s_idx].add(1.0, mode="drop")
    diff = diff.at[e_idx].add(-1.0, mode="drop")
    img0 = jnp.cumsum(
        diff.reshape(theta_bins, range_bins + 1), axis=1
    )[:, :range_bins]

    return jnp.stack(
        [img0, img1.reshape(theta_bins, range_bins)]
    )


@functools.partial(
    jax.jit, static_argnames=("width", "height", "max_interp")
)
def render_geometric_cartesian(
    cloud: jnp.ndarray,
    res: float | jnp.ndarray,
    width: int,
    height: int,
    max_interp: int = 64,
) -> jnp.ndarray:
    """Cartesian geometric render from an ORGANIZED cloud
    (scan_renderer.cpp:7-53).

    cloud: (H_cloud, W_cloud, 3) xyz; (0, 0, z) marks invalid points.
    Walks up each column (idy ascending), classifying slope between
    consecutive valid points; ground spans are drawn by interpolating the
    2D line between consecutive image indices (:38-45), bounded here by
    max_interp steps (the reference's step count is ceil(|diff|)).
    Returns (2, height, width).
    """
    hc, wc, _ = cloud.shape
    x = cloud[..., 0]
    y = cloud[..., 1]
    z = cloud[..., 2]
    valid = ~((x == 0) & (y == 0))

    x_ind = jnp.round(x / res).astype(jnp.int32) + width // 2
    y_ind = jnp.round(y / res).astype(jnp.int32) + height // 2

    # index (row) of the previous valid point in each column
    rows = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 0)
    prev_row = jax.lax.cummax(jnp.where(valid, rows, -1), axis=0)
    prev_row = jnp.concatenate(
        [jnp.full((1, wc), -1, jnp.int32), prev_row[:-1]], axis=0
    )
    has_prev = prev_row >= 0
    pr = jnp.clip(prev_row, 0, hc - 1)
    cols = jax.lax.broadcasted_iota(jnp.int32, (hc, wc), 1)
    gather = lambda a, fill: jnp.where(has_prev, a[pr, cols], fill)
    px, py, pz = gather(x, 0.0), gather(y, 0.0), gather(z, 0.0)
    # walk origin: last_ind starts at image center (scan_renderer.cpp:19)
    plx = gather(x_ind, width // 2)
    ply = gather(y_ind, height // 2)

    dist = jnp.sqrt((x - px) ** 2 + (y - py) ** 2)
    slope = jnp.abs(z - pz) / dist
    prev_slope_raw = gather(slope, 0.0)
    last_high_grad = has_prev & (prev_slope_raw > 1.0)

    obstacle = (
        valid
        & (slope > 1.0)
        & (x_ind >= 0) & (x_ind < width)
        & (y_ind >= 0) & (y_ind < height)
    )
    ground = valid & (slope < 0.3) & ~last_high_grad

    img1 = jnp.zeros(height * width, jnp.float32)
    obs_idx = jnp.where(obstacle, y_ind * width + x_ind, height * width)
    img1 = img1.at[obs_idx].add(1.0, mode="drop")

    # line interpolation: i = k/|diff| for k = 0 .. ceil(|diff|)-1
    dx = (x_ind - plx).astype(jnp.float32)
    dy = (y_ind - ply).astype(jnp.float32)
    norm = jnp.sqrt(dx * dx + dy * dy)
    n_steps = jnp.where(
        norm > 0, jnp.ceil(norm).astype(jnp.int32), 1
    )
    n_steps = jnp.minimum(n_steps, max_interp)
    k = jnp.arange(max_interp, dtype=jnp.float32)  # (K,)
    frac = k[None, None, :] / jnp.maximum(norm, 1e-20)[..., None]
    ix = jnp.round(plx[..., None] + frac * dx[..., None]).astype(jnp.int32)
    iy = jnp.round(ply[..., None] + frac * dy[..., None]).astype(jnp.int32)
    step_ok = (
        ground[..., None]
        & (k[None, None, :] < n_steps[..., None])
        & (ix >= 0) & (ix < width)
        & (iy >= 0) & (iy < height)
    )
    img0 = jnp.zeros(height * width, jnp.float32)
    g_idx = jnp.where(step_ok, iy * width + ix, height * width)
    img0 = img0.at[g_idx.reshape(-1)].add(1.0, mode="drop")

    return jnp.stack(
        [img0.reshape(height, width), img1.reshape(height, width)]
    )
