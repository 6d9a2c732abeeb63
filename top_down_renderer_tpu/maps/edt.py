"""Jitted truncated Euclidean distance transform.

Array-native replacement for cv::distanceTransform(DIST_L2, DIST_MASK_PRECISE)
as used by TopDownMap::computeDists (/root/reference/src/top_down_map.cpp:
289-326): per-class distance maps, scaled by map resolution, truncated at
50 m, and zeroed on unknown cells.

Algorithm (exact within the truncation radius, Meijster-style separable):
  pass 1 (columns): 1D vertical distance to the nearest seed in the same
          column, computed with two cumulative scans (O(H log H) on the device's
          associative-scan lowering, fully vectorized over W).
  pass 2 (rows): D^2[i,j] = min_{|dj|<=T} (g[i,j+dj]^2 + dj^2), a
          (2T+1)-tap sliding min over a padded buffer.  Seeds farther than
          the truncation radius T cannot influence the truncated result, so
          the windowed min is exact.

Everything is elementwise/VPU work over (H, W) planes - XLA fuses the taps;
this runs once per map load, not per scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _axis_seed_distance(present: jnp.ndarray) -> jnp.ndarray:
    """1D distance along axis 0 (rows) to nearest True, per column.

    Returns float32 (H, W); columns with no seed get +inf.
    """
    h = present.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.float32, present.shape, 0)
    neg_inf = jnp.float32(-jnp.inf)
    # nearest seed at-or-above: cummax of row index where present
    seed_above = jax.lax.cummax(
        jnp.where(present, rows, neg_inf), axis=0
    )
    d_above = rows - seed_above  # +inf where no seed above
    # nearest seed at-or-below: cummax from the bottom on negated rows
    seed_below = -jax.lax.cummax(
        jnp.flip(jnp.where(present, -rows, neg_inf), axis=0), axis=0
    )
    seed_below = jnp.flip(seed_below, axis=0)
    d_below = seed_below - rows
    return jnp.minimum(d_above, d_below)


@functools.partial(jax.jit, static_argnames=("trunc_px",))
def edt(present: jnp.ndarray, trunc_px: int) -> jnp.ndarray:
    """Truncated exact L2 EDT: distance (px) from each pixel to the nearest
    True pixel of `present`, clipped to trunc_px.

    present: (H, W) bool.  Returns (H, W) float32.
    """
    t = int(trunc_px)
    g = _axis_seed_distance(present)
    g = jnp.minimum(g, jnp.float32(t))  # seeds beyond T can't matter
    g2 = g * g
    h, w = g2.shape
    big = jnp.float32(t * t)
    padded = jnp.full((h, w + 2 * t), big, dtype=jnp.float32)
    padded = jax.lax.dynamic_update_slice(padded, g2, (0, t))

    def body(i, d2):
        # offset dj = i - t  in [-t, t]
        dj = i - t
        shifted = jax.lax.dynamic_slice(padded, (0, i), (h, w))
        return jnp.minimum(d2, shifted + jnp.float32(1.0) * (dj * dj))

    d2 = jnp.full((h, w), big, dtype=jnp.float32)
    d2 = jax.lax.fori_loop(0, 2 * t + 1, body, d2)
    return jnp.minimum(jnp.sqrt(d2), jnp.float32(t))


@functools.partial(
    jax.jit, static_argnames=("resolution", "trunc_m")
)
def compute_dists(
    class_maps: jnp.ndarray,
    resolution: float = 1.0,
    trunc_m: float = 50.0,
):
    """Parity port of TopDownMap::computeDists (top_down_map.cpp:289-326).

    class_maps: (C, H, W) float32, 0 inside a class region, 1 elsewhere.

    Returns (dists, mask):
      dists: (C, H, W) float32 - L2 distance to the class, * resolution,
             truncated at trunc_m, and set to 0 where mask (unknown).
      mask:  (H, W) uint8 - 1 where no class present at all (:294-299,321).
    """
    # unknown = every class map is 1 (no class anywhere)
    mask = (jnp.sum(class_maps, axis=0) >= class_maps.shape[0]).astype(
        jnp.uint8
    )
    trunc_px = max(1, int(round(trunc_m / resolution)))

    def one(cm):
        d = edt(cm == 0, trunc_px) * jnp.float32(resolution)
        d = jnp.minimum(d, jnp.float32(trunc_m))
        return jnp.where(mask == 1, jnp.float32(0.0), d)

    dists = jax.vmap(one)(class_maps)
    return dists, mask
