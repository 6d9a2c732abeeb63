"""Systematic (low-variance) resampling.

Parity port of the resample loop in ParticleFilter::update
(/root/reference/src/particle_filter.cpp:171-187): samples u_i=(i+shift)/n
with one shared random shift; particle j is selected for the first j with
cumsum(w) > u_i (clamped to the last particle).

Fixed-shape formulation: all N slots are computed; slots >= n_new are
marked dead.  Dead source slots carry weight 0, so the flat cumsum never
selects them.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

from top_down_renderer_tpu.core.grids import Particles


def resample_via() -> str:
    """TDR_RESAMPLE=gather|scatter selects the source-row duplication
    formulation (default gather; see each impl's note)."""
    return os.environ.get("TDR_RESAMPLE", "gather")


def _systematic_indices(
    weights: jnp.ndarray,
    n_new: jnp.ndarray,
    n_active_old: jnp.ndarray,
    shift: jnp.ndarray,
) -> jnp.ndarray:
    """Source index per output slot, j[i] = first src with cumsum > u_i.

    Because both u_i = (i+shift)/n_new and the cumsum are sorted, this is
    computed WITHOUT searchsorted (log-N rounds of gathers): per-source
    output counts via the inverse CDF, then segment starts scattered and
    forward-filled with a cummax.
    """
    n = weights.shape[0]
    csum = jnp.cumsum(weights)
    nn = jnp.maximum(n_new, 1).astype(jnp.float32)
    # F[j] = #outputs assigned to sources <= j = #{i: u_i < csum[j]}
    f = jnp.clip(
        jnp.ceil(csum * nn - shift), 0.0, nn
    ).astype(jnp.int32)
    f_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), f[:-1]])
    has = f > f_prev  # sources with at least one output
    src = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.where(has, f_prev, n)  # drop empty sources
    seg = jnp.zeros(n, jnp.int32).at[pos].max(src, mode="drop")
    j = jax.lax.cummax(seg)
    return jnp.minimum(j, jnp.maximum(n_active_old - 1, 0))


def _segment_rows_scatter(
    packed: jnp.ndarray,
    weights: jnp.ndarray,
    n_new: jnp.ndarray,
    n_active_old: jnp.ndarray,
    shift: jnp.ndarray,
) -> jnp.ndarray:
    """packed[j] WITHOUT the row gather.

    Because j is non-decreasing, the resample output is a sequence of
    constant-row segments: scatter each selected source's row at its
    segment start (starts are distinct by construction: f is
    non-decreasing, so f_prev values of selected sources are strictly
    increasing), then forward-fill rows with a log-N associative scan.
    Parity-tested against the gather, which systematic_resample uses by
    default."""
    n = weights.shape[0]
    csum = jnp.cumsum(weights)
    nn = jnp.maximum(n_new, 1).astype(jnp.float32)
    f = jnp.clip(
        jnp.ceil(csum * nn - shift), 0.0, nn
    ).astype(jnp.int32)
    f_prev = jnp.concatenate([jnp.zeros(1, jnp.int32), f[:-1]])
    has = (f > f_prev) & (
        jnp.arange(n) < jnp.maximum(n_active_old, 1)
    )
    pos = jnp.where(has, f_prev, n)  # drop empty sources
    rows0 = jnp.zeros_like(packed).at[pos].set(packed, mode="drop")
    valid0 = jnp.zeros(n, bool).at[pos].set(True, mode="drop")

    def comb(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf[..., None], bv, av), af | bf

    rows, valid = jax.lax.associative_scan(
        comb, (rows0, valid0), axis=0
    )
    # slot 0 is always a segment start when any source was selected;
    # the remaining invalid rows (degenerate all-zero weights) take
    # source 0, matching the gather path's zeros-base cummax.
    return jnp.where(valid[:, None], rows, packed[0])


def systematic_resample(
    particles: Particles,
    weights: jnp.ndarray,
    n_new: jnp.ndarray,
    n_active_old: jnp.ndarray,
    key: jax.Array,
    via_scatter: bool = False,
    via: str | None = None,
) -> Particles:
    """Returns the resampled particle set with n_new alive particles."""
    n = particles.n_max
    shift = jax.random.uniform(key)
    alive = jnp.arange(n) < n_new
    w_new = jnp.where(alive, 1.0 / jnp.maximum(n_new, 1), 0.0)
    # ONE (N, 8) row gather instead of 8 per-field ones; the
    # pack/unpack copies fuse away.
    packed = pack_fields(particles)
    if via is None:
        via = "scatter" if via_scatter else resample_via()
    if via == "scatter":
        g = _segment_rows_scatter(
            packed, weights, n_new, n_active_old, shift
        )
    else:
        j = _systematic_indices(weights, n_new, n_active_old, shift)
        g = jnp.take(packed, j, axis=0)
    return unpack_fields(g, w_new.astype(jnp.float32), alive)


def pack_fields(p: Particles) -> jnp.ndarray:
    """(N, 8) f32: init_px | d_m | theta | scale | last_dist | have_init
    (bool as 0/1 float - exact)."""
    return jnp.concatenate(
        [
            p.init_px,
            p.d_m,
            p.theta[:, None],
            p.scale[:, None],
            p.last_dist[:, None],
            p.have_init.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )


def unpack_fields(
    g: jnp.ndarray, weight: jnp.ndarray, alive: jnp.ndarray
) -> Particles:
    return Particles(
        init_px=g[:, 0:2],
        d_m=g[:, 2:4],
        theta=g[:, 4],
        scale=g[:, 5],
        have_init=g[:, 7] > 0.5,
        weight=weight,
        last_dist=g[:, 6],
        alive=alive,
    )
