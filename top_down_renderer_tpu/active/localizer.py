"""Active localization: where to drive to disambiguate hypotheses.

Parity port of ActiveLocalizer (/root/reference/src/active_localizer.cpp):
given the GMM hypothesis means, search candidate relative positions
(distance rings 50..150 step 25, 16 headings) and pick the one that
maximizes the mean pairwise L1 difference of the rotation-aligned local
maps across hypotheses - "go where the hypotheses look most different"
(:44-82).  The reference wires it into the GMM thread but leaves the call
commented (particle_filter.cpp:316); here it is a first-class jitted
function over the same device-resident map tensor.

Batched: all (hypothesis x candidate) local windows are gathered in one
batched stencil gather and the pairwise-difference reduction is a single
einsum-style contraction; the reference's early-exit ring loop
(best_diff < 6000) is reproduced with a ring-prefix argmax.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.jit,
    static_argnames=("num_classes", "n_theta", "map_resolution"),
)
def get_best_rel_pos(
    packed_map: jnp.ndarray,
    stencil: jnp.ndarray,
    means: jnp.ndarray,
    k: jnp.ndarray,
    num_classes: int,
    dists: jnp.ndarray | None = None,
    n_theta: int = 16,
    res: float = 2.0,
    early_thresh: float = 6000.0,
    map_resolution: float = 1.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (best_dist, best_theta).

    means: (K_max, 3) GMM means (x_px, y_px, theta); k: active count.
    Candidate position = mean + dist * (cos(theta+mean_th),
    sin(theta+mean_th)) (active_localizer.cpp:62-63); local windows are
    gathered at scale 1 / res 2 (:29) and rotation-aligned by row-shift
    (:31-40) before the mean pairwise L1 difference (:7-20).
    """
    if dists is None:
        dists = jnp.asarray([50.0, 75.0, 100.0, 125.0], jnp.float32)
    h, w, c_pad = packed_map.shape
    th, r, _ = stencil.shape
    k_max = means.shape[0]
    n_d = dists.shape[0]

    theta_c = (
        jnp.arange(n_theta, dtype=jnp.float32) * (2.0 * jnp.pi / n_theta)
    )
    # candidate centers: (K, n_d, n_theta, 2)
    ang = theta_c[None, None, :] + means[:, None, None, 2]
    cx = means[:, None, None, 0] + dists[None, :, None] * jnp.cos(ang)
    cy = means[:, None, None, 1] + dists[None, :, None] * jnp.sin(ang)

    # gather local windows: (K, n_d, n_theta, Th, R, C)
    sten = stencil.reshape(th * r, 2) * res
    iy = jnp.round(
        sten[None, None, None, :, 0] + cy[..., None] / map_resolution
    ).astype(jnp.int32)
    ix = jnp.round(
        sten[None, None, None, :, 1] + cx[..., None] / map_resolution
    ).astype(jnp.int32)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    lin = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
    g = jnp.take(
        packed_map.reshape(h * w, c_pad), lin, axis=0
    )  # (..., TR, C_pad)
    g = jnp.where(valid[..., None], g, 0.0)[..., :num_classes]
    g = g.reshape(k_max, n_d, n_theta, th, r, num_classes)

    # rotation alignment: out[j] = orig[(j - rs) % Th] per hypothesis
    rs = jnp.round(
        means[:, 2] * th / (2.0 * jnp.pi)
    ).astype(jnp.int32) % th
    rows = (
        jnp.arange(th)[None, :] - rs[:, None]
    ) % th  # (K, Th)
    g = jnp.take_along_axis(
        g, rows[:, None, None, :, None, None], axis=3
    )

    # mean pairwise L1 over hypothesis pairs i<j, per candidate: the
    # reference's total/cnt with cnt incremented per (pair, class)
    # (computeTotalDifference, active_localizer.cpp:7-20); each l1 entry
    # already sums over classes, so divide by n_pairs * num_classes
    active = (jnp.arange(k_max) < k).astype(jnp.float32)
    diff_flat = g.reshape(k_max, n_d * n_theta, th * r * num_classes)
    l1 = jnp.sum(
        jnp.abs(diff_flat[:, None] - diff_flat[None, :]), axis=-1
    )  # (K, K, cand)
    pair_w = jnp.triu(active[:, None] * active[None, :], 1)  # (K, K)
    cnt = jnp.maximum(jnp.sum(pair_w) * num_classes, 1.0)
    diffs = jnp.einsum("ij,ijc->c", pair_w, l1).reshape(
        n_d, n_theta
    ) / cnt

    # reference ring loop: stop expanding once best-so-far >= thresh
    ring_best = jnp.max(diffs, axis=1)  # (n_d,)
    prefix_best = jax.lax.cummax(ring_best)
    reached = prefix_best >= early_thresh
    # first ring index where threshold reached (else last ring)
    first = jnp.argmax(reached)
    stop_ring = jnp.where(jnp.any(reached), first, n_d - 1)
    ring_mask = jnp.arange(n_d) <= stop_ring
    masked = jnp.where(ring_mask[:, None], diffs, -jnp.inf)
    flat_idx = jnp.argmax(masked)
    di, ti = flat_idx // n_theta, flat_idx % n_theta
    best = masked.reshape(-1)[flat_idx]
    has_best = best > 0
    return (
        jnp.where(has_best, dists[di], 0.0),
        jnp.where(has_best, theta_c[ti], 0.0),
    )


class ActiveLocalizer:
    """Host-facing wrapper (ActiveLocalizer API, active_localizer.h:9)."""

    def __init__(self, tdmap):
        self.map = tdmap

    def get_best_rel_pos(
        self, means: np.ndarray
    ) -> Tuple[float, float]:
        """means: (K, 3) hypothesis states."""
        k = means.shape[0]
        k_max = max(k, 1)
        padded = np.zeros((k_max, 3), np.float32)
        padded[:k] = means
        d, t = get_best_rel_pos(
            self.map.grid.dist,
            jnp.asarray(self.map.stencil),
            jnp.asarray(padded),
            jnp.asarray(k),
            self.map.num_classes,
            map_resolution=self.map.resolution,
        )
        return float(d), float(t)
