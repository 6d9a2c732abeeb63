"""Per-particle crop scoring: the spread-cloud fast path.

A particle's costs at every rotation shift are the dot product of its
map window with the stencil-folded circulant - the same
(2mo+2, 2mo+2, 8, S) kernel the conv path slides over a region
(conv_score.build_conv_kernel), evaluated at the particle centers only:

    out[p, s] = crop_p_flat @ M[:, s],   M = kernel.reshape(-1, S)
    crop_p    = map[cy_p - mo - 1 : cy_p + mo + 1,
                    cx_p - mo - 1 : cx_p + mo + 1, :]

Windows are gathered from the zero-padded bf16 map (PaddedMaps.padded3d)
in particle chunks - the full set at mo=24 and 102,400 particles is
~4 GB - and contracted in bf16 with f32 accumulation.

Scale buckets (the unknown-scale regime, filter/multiscale.py) give each
bucket its own M.  Particles are ordered bucket-major into chunks that
hold one bucket each, so every chunk is one plain matmul.

Sampling semantics: sample = map[round(cy) + round(dy*f),
round(cx) + round(dx*f)] - a nearest-neighbor discretization that can
differ from the exact path's round(cy + dy*f) by at most one pixel (both
are NN samplings of the same field; the exact path remains the parity
reference, top_down_map_polar.cpp:21-53).  Off-map reads are zero:
dist 0 / known 0 (top_down_map_polar.cpp:38-50).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from top_down_renderer_tpu.filter.conv_score import (
    C_PAD,
    build_conv_kernel,
    conv_dims,
)
from top_down_renderer_tpu.filter.scoring import rotation_shift

# max stencil pixel offset buckets of the crop path; larger scale*res
# scores against a coarser mip of the map (ParticleFilter._fast_mode)
MO_BUCKETS = (12, 24)
# window bytes gathered per chunk (bounds the step's scratch memory)
CHUNK_BYTES = 256 << 20


def window_origins(center_px, map_resolution, mo, h, w, pad):
    """Top-left (row, col) of each particle's window in a map padded by
    `pad` on every side (h, w: the unpadded extent; scalars or
    per-particle arrays).

    A center whose whole stencil falls off the map is clamped to a
    window that still reads only the zero border, so the result equals
    NN sampling with zero out-of-bounds reads for every center."""
    d = mo + 1
    assert pad >= 2 * d, (pad, mo)
    cy = jnp.round(center_px[:, 1] / map_resolution).astype(jnp.int32)
    cx = jnp.round(center_px[:, 0] / map_resolution).astype(jnp.int32)
    cy = jnp.clip(cy, -d, h + mo)
    cx = jnp.clip(cx, -d, w + mo)
    return cy - d + pad, cx - d + pad


def kernel_matrix(scan, class_weights, stencil, f, mo, mode, num_rot,
                  theta_bins):
    """(dr*dc*8, S) bf16 M.  tracked: S = 2*Th+1 (cost at every shift |
    norm at every shift | kf); init: S = 2*num_rot+1 over the search
    shifts."""
    k = build_conv_kernel(
        scan, class_weights, stencil, f, mo, mode, num_rot,
        window_w=theta_bins, s0=0,
    )
    return k.reshape(-1, k.shape[-1])


def _chunk_size(n, k_dim, n_buckets):
    """Particles per chunk: a power of two whose windows fit
    CHUNK_BYTES; with several buckets also <= n / (2 * n_buckets), so
    the per-bucket padding to whole chunks stays small."""
    cap = max(CHUNK_BYTES // (k_dim * 2), 8)
    if n_buckets > 1:
        cap = min(cap, max(n // (2 * n_buckets), 8))
    c = 8
    while c * 2 <= min(cap, n):
        c *= 2
    return c


def _bucket_slots(bucket, n_buckets, chunk):
    """Order particles bucket-major into chunk-aligned slots, every
    chunk holding one bucket.  Returns (slot (n,) of each particle,
    src (n_pad,) particle read by each slot - empty slots read particle
    0 and are discarded - and chunk_bucket (n_chunks,))."""
    n = bucket.shape[0]
    if n_buckets == 1:
        n_pad = -(-n // chunk) * chunk
        slot = jnp.arange(n, dtype=jnp.int32)
        src = jnp.minimum(jnp.arange(n_pad, dtype=jnp.int32), n - 1)
        return slot, src, jnp.zeros(n_pad // chunk, jnp.int32)
    n_chunks = -(-n // chunk) + n_buckets
    counts = jnp.zeros(n_buckets, jnp.int32).at[bucket].add(1)
    padded = -(-counts // chunk) * chunk
    ends = jnp.cumsum(padded)
    starts = ends - padded
    order = jnp.argsort(bucket, stable=True).astype(jnp.int32)
    b_sorted = bucket[order]
    first = jnp.cumsum(counts) - counts  # sorted index of bucket start
    rank = jnp.arange(n, dtype=jnp.int32) - first[b_sorted]
    slot_sorted = starts[b_sorted] + rank
    slot = jnp.zeros(n, jnp.int32).at[order].set(slot_sorted)
    src = jnp.zeros(n_chunks * chunk, jnp.int32).at[slot_sorted].set(
        order
    )
    c0 = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    chunk_bucket = jnp.minimum(
        jnp.sum(ends[None, :] <= c0[:, None], axis=1), n_buckets - 1
    ).astype(jnp.int32)
    return slot, src, chunk_bucket


def crop_rows(padded, oy, ox, kernels, bucket, mo):
    """(n, S) f32: each particle's window at (oy, ox) of `padded`
    (H, W, 8) bf16 contracted with its bucket's M, kernels (B, K, S)
    bf16 with K = (2mo+2)^2 * 8."""
    d = conv_dims(mo)[0]
    n = oy.shape[0]
    n_b, k_dim, s = kernels.shape
    assert k_dim == d * d * C_PAD, (kernels.shape, mo)
    chunk = _chunk_size(n, k_dim, n_b)
    slot, src, chunk_bucket = _bucket_slots(bucket, n_b, chunk)
    oys = oy[src].reshape(-1, chunk)
    oxs = ox[src].reshape(-1, chunk)

    def one_chunk(args):
        y, x, b = args
        win = jax.vmap(
            lambda yy, xx: jax.lax.dynamic_slice(
                padded, (yy, xx, 0), (d, d, C_PAD)
            )
        )(y, x)
        return jnp.dot(
            win.reshape(chunk, k_dim), kernels[b],
            preferred_element_type=jnp.float32,
        )

    out = jax.lax.map(one_chunk, (oys, oxs, chunk_bucket))
    return out.reshape(-1, s)[slot]


def tracked_select(rows, theta, theta_bins, range_bins):
    """(cost_num, norm, kf) at each particle's own rotation shift from
    tracked rows [cost x Th | norm x Th | kf]."""
    s = rotation_shift(theta, theta_bins)[:, None]
    num = jnp.take_along_axis(rows, s, axis=1)[:, 0]
    den = jnp.take_along_axis(rows, s + theta_bins, axis=1)[:, 0]
    kf = rows[:, 2 * theta_bins] / (theta_bins * range_bins)
    return num, den, kf


def init_split(rows, num_rot, theta_bins, range_bins):
    """(nums (n, num_rot), dens (n, num_rot), kf) from init rows."""
    kf = rows[:, 2 * num_rot] / (theta_bins * range_bins)
    return rows[:, :num_rot], rows[:, num_rot : 2 * num_rot], kf


def _uniform_rows(maps, stencil, scan, class_weights, center_px, f, mo,
                  mode, num_rot, map_resolution):
    th, r, _ = stencil.shape
    m = kernel_matrix(
        scan, class_weights, stencil, f, mo, mode, num_rot, th
    )
    pad = maps.pad
    oy, ox = window_origins(
        center_px, map_resolution, mo, maps.hp - 2 * pad,
        maps.wp - 2 * pad, pad,
    )
    bucket = jnp.zeros(center_px.shape[0], jnp.int32)
    return crop_rows(maps.padded3d, oy, ox, m[None], bucket, mo)


def score_tracked(maps, stencil, scan, class_weights, center_px, theta,
                  f, mo, map_resolution=1.0):
    """Tracked mode at uniform f = scale*res: (cost_num, norm, kf) per
    particle at its own rotation shift."""
    th, r, _ = stencil.shape
    rows = _uniform_rows(
        maps, stencil, scan, class_weights, center_px, f, mo,
        "tracked", 0, map_resolution,
    )
    return tracked_select(rows, theta, th, r)


def score_init(maps, stencil, scan, class_weights, center_px, f, mo,
               num_rot=40, map_resolution=1.0):
    """Theta-search mode at uniform f: (nums (N, num_rot),
    dens (N, num_rot), kf (N,)) over the search shifts."""
    th, r, _ = stencil.shape
    rows = _uniform_rows(
        maps, stencil, scan, class_weights, center_px, f, mo, "init",
        num_rot, map_resolution,
    )
    return init_split(rows, num_rot, th, r)

