"""Particle scoring: the hot loop.

Parity port of StateParticle::computeWeight / getCostForRot
(/root/reference/src/state_particle.cpp:112-219) redesigned for batched
matmul hardware:

The reference scores one particle by (a) gathering the per-class polar
local window around the particle pose (top_down_map_polar.cpp:21-76), then
(b) for each candidate rotation, circularly shifting the polar SCAN rows
and correlating against the window (state_particle.cpp:123-143):

  cost(s)  = sum_c 0.01 * w_c * sum_{theta,r} scan_c[(theta+s)%Th, r]
                                              * dist_c[theta, r]
  norm(s)  = sum_{theta,r} (sum_c scan_c)[(theta+s)%Th, r] * known[theta,r]
  cost(s) /= norm(s);  NaN if known fraction < 0.5   (:117-120)

Mapping: the rotation axis is shared by all particles, so we build a
rolled-scan CIRCULANT once per step and compute every particle x every
shift as ONE matmul:

  costs[p, s] = gathered[p, (theta, r, c)] @ circulant[(theta, r, c), s]

The per-particle gather reads the channel-last packed map (H*W, C_pad) so
each stencil point is a single contiguous vector load (all class distances
+ the known mask together).  Particles are processed in chunks under
lax.map to bound the gathered buffer.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp


def build_circulants(
    scan: jnp.ndarray, class_weights: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Build (cost_circ (Th*R*C, Th), norm_circ (Th*R, Th)) from a polar
    scan (C, Th, R).

    cost_circ[(theta, r, c), s] = 0.01 * w_c * scan_c[(theta+s) % Th, r]
    norm_circ[(theta, r), s]    = (sum_c scan_c)[(theta+s) % Th, r]
    """
    c, th, r = scan.shape
    wscan = scan * (0.01 * class_weights)[:, None, None]
    # static rolls (no gather-based roll)
    rolled = jnp.stack(
        [jnp.roll(wscan, -s, axis=1) for s in range(th)], axis=2
    )  # (C, Th, S, R): rolled[c, t, s] = wscan[c, (t+s) % Th]
    cost_circ = jnp.transpose(rolled, (1, 3, 0, 2)).reshape(th * r * c, th)
    ssum = jnp.sum(scan, axis=0)  # (Th, R)
    rolled_sum = jnp.stack(
        [jnp.roll(ssum, -s, axis=0) for s in range(th)], axis=1
    )  # (Th, S, R)
    norm_circ = jnp.transpose(rolled_sum, (0, 2, 1)).reshape(th * r, th)
    return cost_circ, norm_circ


def circulants_at_shifts(
    scan: jnp.ndarray, class_weights: jnp.ndarray, shifts: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Circulant COLUMNS at the given row shifts only.

    Returns (cost_sel (Th*R*C, S), norm_sel (Th*R, S)) with
    cost_sel[(t, r, c), j] = 0.01 * w_c * scan_c[(t+shifts[j]) % Th, r].

    build_circulants materializes all Th shifts as Th static rolls;
    this fetches only the requested shifts as ONE row gather on a
    theta-doubled scan.  shifts must lie in [0, Th)."""
    c, th, r = scan.shape
    wscan = scan * (0.01 * class_weights)[:, None, None]
    rows = jnp.concatenate([wscan, wscan], axis=1).transpose(
        1, 0, 2
    ).reshape(2 * th, c * r)
    idx = (jnp.arange(th)[:, None] + shifts[None, :]).reshape(-1)
    g = jnp.take(rows, idx, axis=0).reshape(th, -1, c, r)
    cost_sel = g.transpose(0, 3, 2, 1).reshape(th * r * c, -1)
    ssum = jnp.sum(scan, axis=0)  # (Th, R)
    s2 = jnp.concatenate([ssum, ssum], axis=0)
    gn = jnp.take(s2, idx, axis=0).reshape(th, -1, r)
    norm_sel = gn.transpose(0, 2, 1).reshape(th * r, -1)
    return cost_sel, norm_sel


@functools.partial(
    jax.jit,
    static_argnames=("num_classes", "map_resolution", "chunk_size"),
)
def score_all_rotations(
    packed_map: jnp.ndarray,
    stencil: jnp.ndarray,
    scan: jnp.ndarray,
    class_weights: jnp.ndarray,
    center_px: jnp.ndarray,
    scale: jnp.ndarray,
    res: jnp.ndarray,
    num_classes: int,
    map_resolution: float = 1.0,
    chunk_size: int = 2048,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Score every particle against every theta shift.

    packed_map: (H, W, C_pad) - class dists [0:C] + known indicator [C].
    stencil: (Th, R, 2) polar offsets (dy, dx) per unit (scale * res).
    center_px: (N, 2) particle pixel pose (x, y).
    scale: (N,) px/m. res: scalar range resolution (m/bin).

    Returns (costs (N, Th) float32 - NaN where known fraction < 0.5,
             known_frac (N,)).

    Out-of-bounds stencil points read dist 0 / known 0 (the reference's
    dist 0 / mask 1 convention, top_down_map_polar.cpp:38-50).
    """
    h, w, c_pad = packed_map.shape
    th, r, _ = stencil.shape
    n = center_px.shape[0]
    assert n % chunk_size == 0, "pad particle count to chunk multiple"

    cost_circ, norm_circ = build_circulants(scan, class_weights)
    flat_map = packed_map.reshape(h * w, c_pad)
    sten = stencil.reshape(th * r, 2)  # (TR, 2): dy, dx

    def chunk_fn(args):
        ctr, scl = args  # (chunk, 2), (chunk,)
        f = (scl * res)[:, None, None]  # (chunk, 1, 1)
        yy = sten[None, :, 0] * f[..., 0] + ctr[:, None, 1] / map_resolution
        xx = sten[None, :, 1] * f[..., 0] + ctr[:, None, 0] / map_resolution
        iy = jnp.round(yy).astype(jnp.int32)
        ix = jnp.round(xx).astype(jnp.int32)
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        lin = jnp.clip(iy, 0, h - 1) * w + jnp.clip(ix, 0, w - 1)
        g = jnp.take(flat_map, lin, axis=0)  # (chunk, TR, C_pad)
        g = jnp.where(valid[..., None], g, 0.0)
        dists = g[..., :num_classes].reshape(-1, th * r * num_classes)
        known = g[..., num_classes]  # (chunk, TR)
        num = jnp.dot(
            dists, cost_circ, preferred_element_type=jnp.float32
        )
        den = jnp.dot(
            known, norm_circ, preferred_element_type=jnp.float32
        )
        costs = num / den
        kf = jnp.mean(known, axis=1)
        costs = jnp.where(kf[:, None] < 0.5, jnp.nan, costs)
        return costs, kf

    ctr_chunks = center_px.reshape(-1, chunk_size, 2)
    scl_chunks = scale.reshape(-1, chunk_size)
    costs, kf = jax.lax.map(chunk_fn, (ctr_chunks, scl_chunks))
    return costs.reshape(n, th), kf.reshape(n)


def rotation_shift(theta: jnp.ndarray, theta_bins: int) -> jnp.ndarray:
    """Rotation -> row-shift count, normalized to [0, Th)
    (state_particle.cpp:123-128)."""
    s = jnp.round(theta * theta_bins / (2.0 * jnp.pi)).astype(jnp.int32)
    return jnp.mod(s, theta_bins)


def search_shifts(theta_bins: int, num_rot: int) -> jnp.ndarray:
    """The uninitialized-theta search grid: t_k = k * 2pi/num_rot
    (state_particle.cpp:197) mapped to row shifts."""
    k = jnp.arange(num_rot)
    t = k.astype(jnp.float32) * (2.0 * jnp.pi / num_rot)
    return rotation_shift(t, theta_bins)


def shift_mask(
    shifts: jnp.ndarray, alive: jnp.ndarray, theta_bins: int
) -> jnp.ndarray:
    """(theta_bins,) bool: which rotation shifts are occupied by alive
    particles.

    NOT a scatter: a 100k-update scatter into ~100 slots serializes on
    colliding updates; the mask is packed into int32 words with a
    bitwise-or reduction instead."""
    words = (theta_bins + 31) // 32
    m = jnp.where(alive, shifts, theta_bins)
    bit = jnp.left_shift(jnp.int32(1), (m % 32).astype(jnp.int32))
    eq = (m // 32)[:, None] == jnp.arange(words, dtype=jnp.int32)[None]
    vals = jnp.where(
        eq & (m < theta_bins)[:, None], bit[:, None], jnp.int32(0)
    )
    packed = jax.lax.reduce(
        vals, jnp.int32(0), jax.lax.bitwise_or, (0,)
    )
    b = jnp.arange(theta_bins, dtype=jnp.int32)
    return (jnp.right_shift(packed[b // 32], b % 32) & 1) > 0
