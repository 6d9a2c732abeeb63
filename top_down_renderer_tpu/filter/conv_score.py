"""Convolutional grid scoring: the clustered-particle fast path.

After convergence the particle cloud occupies a small map region (the
adaptive count keeps ~3/4 n + 10 particles in a tight cluster,
particle_filter.cpp:151-158).  In that regime, evaluating the cost at
every integer center of the bounding region is cheaper than per-particle
work: the stencil->pixel selection folded through the rolled-scan
circulant is a convolution kernel K (build_conv_kernel), so

    field[y, x, s] = sum_{dy, dx, c} K[dy, dx, c, s] * map[y+dy, x+dx, c]

is ONE matmul over im2col patches (output channels = costs at all
shifts + norms + known-count), and each particle just reads
field[round(cy), round(cx), shift].

Sampling semantics: NN at round(center) + round(offset * scale * res),
identical to the crop path (crop_score.py evaluates the same kernel at
the particle centers only).

Used when the alive-particle bounding box fits a region bucket; the
crop path covers the spread case and the exact gather covers
everything else.

This module also owns the zero-padded device copies of the map that
both fast paths read (PaddedMaps) and the one-hot stencil->pixel
kernel builder they share.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from top_down_renderer_tpu.core import struct
from top_down_renderer_tpu.filter.scoring import rotation_shift

C_PAD = 8  # packed map channels (build_grid pads to 8)
# zero border of the padded maps: >= 2*mo+2 for every crop bucket
# (crop_score.window_origins clamps off-map windows into it)
MAP_PAD = 64
# max stencil pixel offset buckets of the conv path (kernel size grows
# ~mo^2)
MO_BUCKETS_CONV = (12, 24, 36, 48)
# output-region buckets (cost-field height/width in px)
REGION_BUCKETS = (64, 128, 192, 256)


def pick_crop_size(f: float, range_bins: int, buckets) -> int | None:
    """Smallest max-offset bucket mo covering scale*res = f (every
    stencil offset round((range_bins-1) * f) <= mo), or None if no
    bucket does."""
    max_off = int(np.ceil((range_bins - 1) * float(f)))
    for mo in buckets:
        if max_off <= mo:
            return mo
    return None


@struct.dataclass
class PaddedMaps:
    """Zero-padded device copies of the packed map; rebuild on map
    change.  Zeros = dist 0 / known 0, the reference's out-of-bounds
    values (top_down_map_polar.cpp:38-50)."""

    padded3d: jnp.ndarray  # (Hp, Wp, 8) bf16: crop windows, direct conv
    padded4d: jnp.ndarray  # (~Hp/4, ~Wp/4, 128) bf16 s2d phase fold
    padded4d_i8: jnp.ndarray = None  # int8 s2d fold (TDR_CONV_INT8)
    qinv4d: jnp.ndarray = None  # (8,) f32 scales for padded4d_i8
    hp: int = struct.field(pytree_node=False, default=0)
    wp: int = struct.field(pytree_node=False, default=0)
    pad: int = struct.field(pytree_node=False, default=0)


def quantize_channels(packed: jnp.ndarray):
    """(H, W, 8) f32 -> (int8 quantized, (8,) f32 qinv): symmetric
    per-channel scales q = 126/max|v| so known-channel {0,1} maps to
    {0,126} exactly and distance channels get ~max/126 granularity."""
    p32 = packed.astype(jnp.float32)
    amax = jnp.maximum(
        jnp.max(jnp.abs(p32), axis=(0, 1)), 1e-6
    )  # (8,)
    q = 126.0 / amax
    pq = jnp.clip(jnp.round(p32 * q), -127, 127).astype(jnp.int8)
    return pq, amax / 126.0


def build_padded_maps(
    packed: jnp.ndarray, pad: int = MAP_PAD
) -> PaddedMaps:
    """(H, W, 8) f32 -> PaddedMaps with a `pad`-pixel zero border."""
    pb = jnp.pad(
        packed.astype(jnp.bfloat16), ((pad, pad), (pad, pad), (0, 0))
    )
    pq, qinv = quantize_channels(packed)
    p8 = jnp.pad(pq, ((pad, pad), (pad, pad), (0, 0)))
    return PaddedMaps(
        padded3d=pb,
        padded4d=fold_map_s2d(pb),
        padded4d_i8=fold_map_s2d(p8, jnp.int8),
        qinv4d=qinv,
        hp=int(pb.shape[0]), wp=int(pb.shape[1]), pad=int(pad),
    )


def _build_base_y_from_pix(
    pix8: jnp.ndarray,  # (TR,) K-row base index per stencil point
    kext: int,
    c: int,
    cost_cols: jnp.ndarray,  # (TR*C, n_cost) - rows in (theta,r,c) order
    norm_cols: jnp.ndarray,  # (TR, n_norm)
    s_cols: int,
) -> jnp.ndarray:
    """Build the base tensor y (C_PAD, s_cols, n_slots) f32.

    The stencil->pixel selection is a dense one-hot matmul at CELL
    granularity: every stencil cell's 8 channels share one pixel slot
    (pix8 is always a multiple of C_PAD), so the one-hot is
    (TR, Kext/8) instead of (TR*8, Kext):
      y[(ch, s), slot] = circ3_T ((C_PAD*s_cols), TR) @ onehot (TR, slots)
    Channels < c carry cost, channel c carries norm + the kf count,
    channels > c are zero padding.
    """
    tr = pix8.shape[0]
    n_cost = cost_cols.shape[1]
    n_norm = norm_cols.shape[1]
    circ2 = jnp.zeros((tr, C_PAD, s_cols), jnp.float32)
    circ2 = circ2.at[:, :c, :n_cost].set(
        cost_cols.reshape(tr, c, n_cost)
    )
    circ2 = circ2.at[:, c, n_cost : n_cost + n_norm].set(norm_cols)
    circ2 = circ2.at[:, c, n_cost + n_norm].set(1.0)
    n_slots = kext // C_PAD
    lhs = (
        circ2.transpose(1, 2, 0)
        .reshape(C_PAD * s_cols, tr)
        .astype(jnp.bfloat16)
    )
    pix_cell = pix8 // C_PAD
    # one-hot chunked to ~16 MB of bf16
    n_chunks = max(1, -(-(tr * n_slots * 2) // (16 << 20)))
    kc = -(-n_slots // (n_chunks * 128)) * 128
    parts = []
    for j in range(n_chunks):
        kidx = j * kc + jax.lax.broadcasted_iota(jnp.int32, (1, kc), 1)
        onehot = (pix_cell[:, None] == kidx).astype(jnp.bfloat16)
        parts.append(
            jnp.dot(lhs, onehot, preferred_element_type=jnp.float32)
        )
    y = jnp.concatenate(parts, axis=1)[:, :n_slots]
    return y.reshape(C_PAD, s_cols, n_slots)


def conv_dims(mo: int):
    """Kernel extent for max stencil offset mo: rows/cols hold
    offset + mo + 1 in [1, 2*mo+1] (row/col 0 is structurally zero)."""
    d = 2 * mo + 2
    return d, d


def pick_region(extent: int) -> int | None:
    for b in REGION_BUCKETS:
        if extent <= b:
            return b
    return None


def _windowed_cost_norm(scan, class_weights, s0, ww):
    """Cost/norm circulant COLUMNS for the consecutive shift window
    [s0, s0+ww) only: ww doubled-axis dynamic slices instead of
    materializing the full Th-wide circulant and gathering ww of its
    columns (build_circulants' 100 rolls + relayout)."""
    c, th, r = scan.shape
    wscan = scan * (0.01 * class_weights)[:, None, None]
    # triple-tile the theta axis so start = s0 + j < 2*Th always leaves
    # a full Th window
    w3 = jnp.concatenate([wscan, wscan, wscan], axis=1)
    ssum = jnp.sum(scan, axis=0)
    s3 = jnp.concatenate([ssum, ssum, ssum], axis=0)
    cost_slices, norm_slices = [], []
    for j in range(ww):
        start = s0 + j
        cost_slices.append(
            jax.lax.dynamic_slice(w3, (0, start, 0), (c, th, r))
        )
        norm_slices.append(
            jax.lax.dynamic_slice(s3, (start, 0), (th, r))
        )
    cost_cols = (
        jnp.stack(cost_slices, axis=2)
        .transpose(1, 3, 0, 2)
        .reshape(th * r * c, ww)
    )
    norm_cols = (
        jnp.stack(norm_slices, axis=1)
        .transpose(0, 2, 1)
        .reshape(th * r, ww)
    )
    return cost_cols, norm_cols


def _searched_cost_norm(scan, class_weights, num_rot):
    """Cost/norm circulant columns at the num_rot STATIC search shifts
    (state_particle.cpp:197)."""
    c, th, r = scan.shape
    wscan = scan * (0.01 * class_weights)[:, None, None]
    ssum = jnp.sum(scan, axis=0)
    # the shifts come from the SAME search_shifts the exact/crop init
    # paths use (host-fetched: its inputs are static so it constant-folds
    # eagerly on the current backend) - a numpy re-derivation can round
    # the exact .5 ties the other way than XLA's divide, scoring those
    # candidates one theta bin off
    from top_down_renderer_tpu.filter.scoring import search_shifts

    # the shifts are static; evaluate them OUTSIDE any enclosing trace
    # (inside a jitted step, jnp ops on constants are traced too, and
    # np.asarray on the tracer would throw)
    with jax.ensure_compile_time_eval():
        ssh = np.asarray(search_shifts(th, num_rot))
    cost_cols = (
        jnp.stack([jnp.roll(wscan, -int(s), axis=1) for s in ssh],
                  axis=2)
        .transpose(1, 3, 0, 2)
        .reshape(th * r * c, num_rot)
    )
    norm_cols = (
        jnp.stack([jnp.roll(ssum, -int(s), axis=0) for s in ssh],
                  axis=1)
        .transpose(0, 2, 1)
        .reshape(th * r, num_rot)
    )
    return cost_cols, norm_cols


def _cost_norm_cols(scan, class_weights, mode, num_rot, window_w, s0):
    if mode == "tracked":
        return _windowed_cost_norm(scan, class_weights, s0, window_w)
    return _searched_cost_norm(scan, class_weights, num_rot)


def build_conv_kernel(
    scan: jnp.ndarray,
    class_weights: jnp.ndarray,
    stencil: jnp.ndarray,
    f,
    mo: int,
    mode: str,
    num_rot: int = 40,
    window_w: int = 100,
    s0=0,
) -> jnp.ndarray:
    """(dr, dc, 8, S_out) bf16 conv kernel (HWIO: the layout the base
    builder emits without an extra relayout).

    tracked: the kernel covers the circular shift window
      [s0, s0+window_w): S_out = 2*window_w+1 ->
      [0:W) costs | [W:2W) norms | [2W] kf.  A converged cloud occupies
      a narrow theta band, so W << theta_bins cuts the conv cost
      proportionally (the live window is tracked in FilterState.smask).
    init: S_out = 2*num_rot+1 over the search shifts.
    """
    c, th, r = scan.shape
    dr, dc = conv_dims(mo)
    off = jnp.round(stencil.reshape(-1, 2) * f).astype(jnp.int32)
    pix8 = ((off[:, 0] + dr // 2) * dc + (off[:, 1] + dc // 2)) * C_PAD
    k = dr * dc * C_PAD
    if mode == "tracked":
        cost_cols, norm_cols = _windowed_cost_norm(
            scan, class_weights, s0, window_w
        )
        y = _build_base_y_from_pix(
            pix8, k, c, cost_cols, norm_cols, 2 * window_w + 1,
        )
    else:
        cost_cols, norm_cols = _searched_cost_norm(
            scan, class_weights, num_rot
        )
        y = _build_base_y_from_pix(
            pix8, k, c, cost_cols, norm_cols, 2 * num_rot + 1,
        )
    s_out = y.shape[1]
    return (
        y.transpose(2, 0, 1)
        .reshape(dr, dc, C_PAD, s_out)
        .astype(jnp.bfloat16)
    )


# ---------------------------------------------------------------------
# Space-to-depth phase folding: the dense-contraction conv formulation.
#
# The C_PAD=8 direct conv contracts over only 8 channels per tap.
# Folding 4x4 spatial phases of the map into the channel dim makes the
# contraction 128 deep:
#
#   map4[Y, X, (qy, qx, c)]   = map[4Y+qy, 4X+qx, c]      (once per map)
#   K4[(py, px, s), DY, DX, (qy, qx, c)] = K[s, 4DY+qy-py, 4DX+qx-px, c]
#   out4[Yb, Xb, (py, px, s)] = VALID conv(map4 block, K4)
#
# and field[j, x] for center row j = 4Yb + py reads out4[Yb, ...] at
# channel (py*4 + px)*S + s.  Same arithmetic, 16x less im2col traffic.
F_S2D = 4
# kernel-size gate: above this the folded kernel's memory traffic is
# taken to stop paying for itself; fall back to the direct conv.  256 MB
# covers the full-window tracked kernel at mo=24 (161 MB)
K4_MAX_BYTES = 256 * 2**20


def s2d_extent(d: int) -> int:
    """Folded kernel spatial extent: dy + (qy - py) spans [-3, d+2]."""
    return (d + 2) // F_S2D + 1


def fold_map_s2d(
    padded3d: jnp.ndarray, out_dtype=jnp.bfloat16
) -> jnp.ndarray:
    """(Hp, Wp, 8) -> (ceil/4 + margin, ceil/4 + margin, 128) bf16
    (or out_dtype: the TDR_CONV_INT8 path folds the int8-quantized map).

    80 extra zero rows/cols cover the folded conv's read-ahead past the
    direct path's block end: at most 10 px single-chip, plus up to
    4*(n_dev-1) px of row-padding when the field is row-sharded over a
    mesh (parallel/sharding.py, n_dev <= 16).  Zeros = out-of-bounds
    semantics (/root/reference/src/top_down_map_polar.cpp:38-50)."""
    h, w, c = padded3d.shape
    f = F_S2D
    hp = ((h + f - 1) // f) * f + 80
    wp = ((w + f - 1) // f) * f + 80
    p = jnp.pad(
        padded3d.astype(out_dtype), ((0, hp - h), (0, wp - w), (0, 0))
    )
    return (
        p.reshape(hp // f, f, wp // f, f, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(hp // f, wp // f, f * f * c)
    )


def fold_kernel_s2d(kernel: jnp.ndarray) -> jnp.ndarray:
    """(dr, dc, 8, S) HWIO -> (DYe, DXe, 128, 16*S) HWIO.

    Output channel (py*4 + px)*S + s scores centers at spatial phase
    (py, px); folded input channel order (qy, qx, c) matches
    fold_map_s2d.  (HWIO keeps the relayout off the minor dims.)"""
    dr, dc, c, s = kernel.shape
    f = F_S2D
    dye, dxe = s2d_extent(dr), s2d_extent(dc)
    kp = jnp.pad(
        kernel,
        ((3, f * dye - dr), (3, f * dxe - dc), (0, 0), (0, 0)),
    )
    phases = []
    for py in range(f):
        for px in range(f):
            ks = jax.lax.slice(
                kp,
                (3 - py, 3 - px, 0, 0),
                (3 - py + f * dye, 3 - px + f * dxe, c, s),
            )
            phases.append(
                ks.reshape(dye, f, dxe, f, c, s)
                .transpose(0, 2, 1, 3, 4, 5)
                .reshape(dye, dxe, f * f * c, s)
            )
    return jnp.concatenate(phases, axis=3)


@functools.lru_cache(maxsize=None)
def _fold_relabel(d: int) -> np.ndarray:
    """(d, extent*16) 0/1 relabel matrix for ONE spatial axis of the
    s2d fold.  Column (D*4 + q)*4 + p — which simplifies to
    (dy + p)*4 + p — is 1 at row dy iff dy = 4*D + q - p, i.e. exactly
    fold_kernel_s2d's phase-p shifted slice along that axis, so
    contracting the unfolded kernel axis with this matrix IS the fold
    along that axis (one one-hot entry per (dy, p): the matmul copies
    values, never sums)."""
    e = s2d_extent(d)
    m = np.zeros((d, e * 16), np.float32)
    for dy in range(d):
        for p in range(F_S2D):
            m[dy, (dy + p) * F_S2D + p] = 1.0
    return m


def fold_mm() -> bool:
    """TDR_FOLD_MM=1 switches cost_field_s2d to the relabel-matmul fold
    (fold_kernel_s2d_mm); default is the slice/pad/transpose fold."""
    return os.environ.get("TDR_FOLD_MM", "0") == "1"


def conv_int8() -> bool:
    """TDR_CONV_INT8=1 runs the kf-split tracked cost field as an int8
    contraction: int8-quantized folded map (quantize_channels scales)
    x per-column int8 kernel, i32 accumulation, f32 dequant.  Halves
    the im2col + kernel bytes of the converged step's largest matmul.

    Every column gets a hi/lo int8 residual pair (effective ~16-bit).
    A single
    plane is NOT enough here - the windowed cost columns are
    all-positive with ~39% of their nonzero coefficients below half an
    LSB, so single-plane rounding zeroes them and biases cost -4%
    (tests/test_conv_score.py::test_conv_int8_matches_bf16 guards it).
    Default OFF: its speed has not been measured on the GPU.  Requires
    the kf-split layout, so the init and full-window kernels stay
    bf16."""
    return os.environ.get("TDR_CONV_INT8", "0") == "1"


def kf_split() -> bool:
    """TDR_KF_SPLIT=1 folds the kf (known-count) column into its own
    tiny K4 and runs it as a second matmul, so the main fold
    concatenates 2*window_w-lane phase chunks instead of 2*ww+1: at
    ww=16 the chunks are 32 lanes (exactly 1/4 of the 128-lane tile)
    and every phase boundary is 32-aligned instead of the odd
    33-column interleave.  Default ON; its speed on the GPU has not
    been re-measured.  Applies to tracked mode with
    (2*window_w) % 32 == 0 only (the full-window and init kernels
    stay combined); TDR_KF_SPLIT=0 restores the combined fold."""
    return os.environ.get("TDR_KF_SPLIT", "1") == "1"


def fold_kernel_s2d_mm(kernel: jnp.ndarray) -> jnp.ndarray:
    """fold_kernel_s2d as two tiny relabel matmuls + ONE transpose.

    The 16-phase slice/pad/transpose fold materializes 16 intermediates
    with narrow minor dims (c=8, s_out~33).  The fold is separable per
    spatial axis — K4[.., 4*DY+qy-py, ..] is a relabel dy -> (DY, qy,
    py) — so contracting each kernel axis with the static 0/1 matrix
    _fold_relabel(d) performs it as a matmul (~0.5 GFLOP at mo=24)
    and leaves one dense 8-axis transpose into the final
    (DYe, DXe, (qy,qx,c), (p,s)) layout.  Bit-exact vs fold_kernel_s2d:
    one-hot rows copy bf16 values, zero columns stay exactly zero
    (tests/test_conv_score.py::test_fold_mm_parity).  Off by default
    (TDR_FOLD_MM=1); its speed on the GPU has not been measured."""
    dr, dc, c, s = kernel.shape
    dye, dxe = s2d_extent(dr), s2d_extent(dc)
    fy = jnp.asarray(_fold_relabel(dr), jnp.bfloat16)
    fx = jnp.asarray(_fold_relabel(dc), jnp.bfloat16)
    kb = kernel.astype(jnp.bfloat16)
    t1 = jnp.einsum(
        "yxcs,yi->ixcs", kb, fy, preferred_element_type=jnp.float32
    )
    t2 = jnp.einsum(
        "ixcs,xj->ijcs", t1.astype(jnp.bfloat16), fx,
        preferred_element_type=jnp.float32,
    ).astype(jnp.bfloat16)
    k4 = (
        t2.reshape(dye, F_S2D, F_S2D, dxe, F_S2D, F_S2D, c, s)
        .transpose(0, 3, 1, 4, 6, 2, 5, 7)  # DY DX qy qx c py px s
        .reshape(dye, dxe, F_S2D * F_S2D * c, F_S2D * F_S2D * s)
    )
    return k4


def cost_field_s2d_k4(
    map4: jnp.ndarray,
    k4: jnp.ndarray,
    origin_yx: jnp.ndarray,
    mo: int,
    region: int,
    s_out: int,
):
    """cost_field_s2d with the folded kernel already built (the direct
    build_conv_kernel_s2d path)."""
    dr, dc = conv_dims(mo)
    f = F_S2D
    dye, dxe = s2d_extent(dr), s2d_extent(dc)
    nyb, nxb = region // f + 1, region // f + 1
    y0 = origin_yx[0] - dr // 2
    x0 = origin_yx[1] - dc // 2
    ys4, roy = y0 // f, y0 % f
    xs4, rox = x0 // f, x0 % f
    block = jax.lax.dynamic_slice(
        map4,
        (ys4, xs4, 0),
        (nyb + dye - 1, nxb + dxe - 1, f * f * C_PAD),
    )
    # explicit im2col + ONE matmul instead of conv_general_dilated
    # (a tiny-spatial / huge-channel conv); the static tap slices
    # stack into (nyb*nxb, dye*dxe*128) patches whose column order
    # matches k4's (dy, dx, channel) reshape
    pat = jnp.stack(
        [
            jax.lax.slice(
                block, (dy, dx, 0),
                (dy + nyb, dx + nxb, f * f * C_PAD),
            )
            for dy in range(dye)
            for dx in range(dxe)
        ],
        axis=2,
    ).reshape(nyb * nxb, dye * dxe * f * f * C_PAD)
    out = jnp.dot(
        pat,
        k4.reshape(dye * dxe * f * f * C_PAD, -1),
        preferred_element_type=jnp.float32,
    )
    return out.reshape(nyb, nxb, -1), roy, rox


@functools.partial(
    jax.jit, static_argnames=("mo", "region", "s_out")
)
def cost_field_s2d_split(
    map4: jnp.ndarray,
    kernel: jnp.ndarray,
    origin_yx: jnp.ndarray,
    mo: int,
    region: int,
    s_out: int,
):
    """kf-split variant of cost_field_s2d (TDR_KF_SPLIT=1): the main
    kernel columns [0, s_out-1) fold at 32-lane-aligned phase chunks
    and the kf column [s_out-1] folds into its own (DYe, DXe, 128, 16)
    K4 scored by a second matmul over the same im2col patches.

    Returns (out4 (nYb, nXb, 16*(s_out-1)), out_kf (nYb, nXb, 16),
    roy, rox); out_kf channel = the spatial phase py*4 + px."""
    dr, dc = conv_dims(mo)
    sm = s_out - 1
    assert (sm % 32) == 0, sm
    k4 = fold_kernel_s2d(kernel[..., :sm])
    k4_kf = fold_kernel_s2d(kernel[..., sm:])
    f = F_S2D
    dye, dxe = s2d_extent(dr), s2d_extent(dc)
    nyb, nxb = region // f + 1, region // f + 1
    y0 = origin_yx[0] - dr // 2
    x0 = origin_yx[1] - dc // 2
    ys4, roy = y0 // f, y0 % f
    xs4, rox = x0 // f, x0 % f
    block = jax.lax.dynamic_slice(
        map4,
        (ys4, xs4, 0),
        (nyb + dye - 1, nxb + dxe - 1, f * f * C_PAD),
    )
    pat = jnp.stack(
        [
            jax.lax.slice(
                block, (dy, dx, 0),
                (dy + nyb, dx + nxb, f * f * C_PAD),
            )
            for dy in range(dye)
            for dx in range(dxe)
        ],
        axis=2,
    ).reshape(nyb * nxb, dye * dxe * f * f * C_PAD)
    out = jnp.dot(
        pat,
        k4.reshape(dye * dxe * f * f * C_PAD, -1),
        preferred_element_type=jnp.float32,
    )
    out_kf = jnp.dot(
        pat,
        k4_kf.reshape(dye * dxe * f * f * C_PAD, -1),
        preferred_element_type=jnp.float32,
    )
    return (
        out.reshape(nyb, nxb, -1),
        out_kf.reshape(nyb, nxb, -1),
        roy,
        rox,
    )


@functools.partial(
    jax.jit, static_argnames=("mo", "region", "s_out")
)
def cost_field_s2d_split_i8(
    map4_i8: jnp.ndarray,
    kernel: jnp.ndarray,
    qinv: jnp.ndarray,
    origin_yx: jnp.ndarray,
    mo: int,
    region: int,
    s_out: int,
):
    """int8 variant of cost_field_s2d_split (TDR_CONV_INT8=1).

    map4_i8 holds the quantize_channels int8 map (value ~ int * qinv[c],
    folded with the channel scales intact), so absorbing qinv into the
    bf16 kernel per input channel and re-quantizing each OUTPUT column
    to int8 makes the whole contraction int8 x int8 -> i32, dequantized by
    per-column scales.  Every column gets a hi/lo residual pair
    (conv_int8 docstring: single-plane rounding zeroes the 39% of cost
    coefficients below half an LSB, a -4% bias), concatenated [hi | lo]
    along the column axis so the fold chunks stay 32-aligned.
    kf column: its own hi/lo pair -> (DYe, DXe, 128, 32) K4.

    Same return contract as cost_field_s2d_split."""
    dr, dc = conv_dims(mo)
    sm = s_out - 1
    assert (sm % 32) == 0, sm
    kq = kernel.astype(jnp.float32) * qinv[None, None, :, None]
    km = kq[..., :sm]
    amax = jnp.maximum(jnp.max(jnp.abs(km), axis=(0, 1, 2)), 1e-30)
    s_hi = amax / 127.0  # (sm,)
    hi = jnp.clip(jnp.round(km / s_hi), -127, 127)
    s_lo = s_hi / 254.0
    lo = jnp.clip(
        jnp.round((km - hi * s_hi) / s_lo), -127, 127
    )
    k_i8 = jnp.concatenate([hi, lo], axis=3).astype(jnp.int8)
    kf = kq[..., sm]
    akf = jnp.maximum(jnp.max(jnp.abs(kf)), 1e-30)
    skf_hi = akf / 127.0
    kf_hi = jnp.clip(jnp.round(kf / skf_hi), -127, 127)
    skf_lo = skf_hi / 254.0
    kf_lo = jnp.clip(
        jnp.round((kf - kf_hi * skf_hi) / skf_lo), -127, 127
    )
    kf2 = jnp.stack([kf_hi, kf_lo], axis=-1).astype(jnp.int8)
    k4 = fold_kernel_s2d(k_i8)  # (dye, dxe, 128, 16*2*sm) int8
    k4_kf = fold_kernel_s2d(kf2)  # (dye, dxe, 128, 32) int8
    f = F_S2D
    dye, dxe = s2d_extent(dr), s2d_extent(dc)
    nyb, nxb = region // f + 1, region // f + 1
    y0 = origin_yx[0] - dr // 2
    x0 = origin_yx[1] - dc // 2
    ys4, roy = y0 // f, y0 % f
    xs4, rox = x0 // f, x0 % f
    block = jax.lax.dynamic_slice(
        map4_i8,
        (ys4, xs4, 0),
        (nyb + dye - 1, nxb + dxe - 1, f * f * C_PAD),
    )
    pat = jnp.stack(
        [
            jax.lax.slice(
                block, (dy, dx, 0),
                (dy + nyb, dx + nxb, f * f * C_PAD),
            )
            for dy in range(dye)
            for dx in range(dxe)
        ],
        axis=2,
    ).reshape(nyb * nxb, dye * dxe * f * f * C_PAD)
    acc = jax.lax.dot_general(
        pat,
        k4.reshape(dye * dxe * f * f * C_PAD, -1),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)  # (nyb*nxb, 16*2*sm): col = p*2sm + j*sm + s
    a2 = acc.reshape(-1, 16, 2, sm)
    out = (a2[:, :, 0] * s_hi + a2[:, :, 1] * s_lo).reshape(
        -1, 16 * sm
    )
    acc_kf = jax.lax.dot_general(
        pat,
        k4_kf.reshape(dye * dxe * f * f * C_PAD, -1),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ).astype(jnp.float32)  # (nyb*nxb, 32): col = phase*2 + {hi, lo}
    out_kf = acc_kf[:, 0::2] * skf_hi + acc_kf[:, 1::2] * skf_lo
    return (
        out.reshape(nyb, nxb, -1),
        out_kf.reshape(nyb, nxb, -1),
        roy,
        rox,
    )


@functools.partial(
    jax.jit, static_argnames=("mo", "region", "s_out")
)
def cost_field_s2d(
    map4: jnp.ndarray,
    kernel: jnp.ndarray,
    origin_yx: jnp.ndarray,
    mo: int,
    region: int,
    s_out: int,
):
    """Folded-phase cost field from an UNFOLDED (dr, dc, 8, s_out)
    kernel.  Returns (out4 (nYb, nXb, 16*s_out) f32, roy, rox): the
    center at padded (origin_y + iy, origin_x + ix) lives at
    j = iy + roy, Yb = j // 4, py = j % 4 (same for x), channel
    (py*4 + px)*s_out + s."""
    fold = fold_kernel_s2d_mm if fold_mm() else fold_kernel_s2d
    return cost_field_s2d_k4(
        map4, fold(kernel), origin_yx, mo, region, s_out
    )


@functools.partial(
    jax.jit,
    static_argnames=("mo", "region", "s_out"),
)
def cost_field(
    padded3d: jnp.ndarray,
    kernel: jnp.ndarray,
    origin_yx: jnp.ndarray,
    mo: int,
    region: int,
    s_out: int,
) -> jnp.ndarray:
    """Evaluate the cost field over a (region, region) block of centers
    whose top-left center is origin_yx (padded coords).

    Returns (region, region, s_out) f32: field[y, x] corresponds to the
    center at padded (origin_y + y, origin_x + x)."""
    dr, dc = conv_dims(mo)
    # center (y, x) reads kernel rows [y - dr//2, ...), cols
    # [x - dc//2, ...)
    oy = origin_yx[0] - dr // 2
    ox = origin_yx[1] - dc // 2
    block = jax.lax.dynamic_slice(
        padded3d,
        (oy, ox, 0),
        (region + dr - 1, region + dc - 1, C_PAD),
    )
    out = jax.lax.conv_general_dilated(
        block[None].astype(jnp.bfloat16),
        kernel,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.float32,
    )
    return out[0]


def make_conv_scorer(
    mo: int,
    region: int,
    mode: str,
    num_rot: int = 40,
    map_resolution: float = 1.0,
    window_w: int = 100,
):
    """Returns score(maps3d: PaddedMaps-like padded3d array, stencil,
    scan, cw, centers, theta, f) for the clustered regime.

    The caller guarantees every alive particle's rounded center falls in
    a (region, region) box (host-checked); stragglers are clamped to the
    box edge and will score as if at the edge (callers fall back to the
    crop path when the cloud doesn't fit).

    When the folded kernel fits the K4_MAX_BYTES gate the field runs on
    the space-to-depth formulation (16x less im2col traffic; identical
    arithmetic, f32 accumulation order differs)."""
    s_out = (
        2 * window_w + 1 if mode == "tracked" else 2 * num_rot + 1
    )
    dr, dc = conv_dims(mo)
    k4_bytes = (
        16 * s_out * s2d_extent(dr) * s2d_extent(dc) * 128 * 2
    )
    use_s2d = k4_bytes <= K4_MAX_BYTES
    use_split = (
        kf_split() and mode == "tracked" and (2 * window_w) % 32 == 0
    )
    use_i8 = use_split and conv_int8()

    def score(padded3d, padded4d, pad, stencil, scan, class_weights,
              center_px, theta, f, alive, s0=0,
              padded4d_i8=None, qinv=None):
        th, r, _ = stencil.shape
        cy = jnp.round(center_px[:, 1] / map_resolution).astype(
            jnp.int32
        ) + pad
        cx = jnp.round(center_px[:, 0] / map_resolution).astype(
            jnp.int32
        ) + pad
        hp, wp, _ = padded3d.shape
        dr, dc = conv_dims(mo)
        # region origin: min over ALIVE particles (dead slots are stale
        # resample leftovers anywhere on the map), clamped to fit
        big = jnp.int32(1 << 30)
        oy = jnp.clip(
            jnp.min(jnp.where(alive, cy, big)),
            dr // 2,
            hp - (region + dr - 1) + dr // 2,
        )
        ox = jnp.clip(
            jnp.min(jnp.where(alive, cx, big)),
            dc // 2,
            wp - (region + dc - 1) + dc // 2,
        )
        iy = jnp.clip(cy - oy, 0, region - 1)
        ix = jnp.clip(cx - ox, 0, region - 1)
        if use_s2d:
            kernel = build_conv_kernel(
                scan, class_weights, stencil, f, mo, mode, num_rot,
                window_w, s0,
            )
            if use_split:
                if use_i8 and padded4d_i8 is not None:
                    out4, out_kf, roy, rox = cost_field_s2d_split_i8(
                        padded4d_i8, kernel, qinv,
                        jnp.stack([oy, ox]), mo, region, s_out,
                    )
                else:
                    out4, out_kf, roy, rox = cost_field_s2d_split(
                        padded4d, kernel, jnp.stack([oy, ox]), mo,
                        region, s_out,
                    )
                sm = s_out - 1  # 2*window_w main columns per phase
                nxb = region // F_S2D + 1
                jy = iy + roy
                jx = ix + rox
                cell16 = (
                    ((jy // F_S2D) * nxb + jx // F_S2D) * 16
                    + (jy % F_S2D) * F_S2D
                    + jx % F_S2D
                )
                rows = out4.reshape(-1, sm)[cell16]  # (n, 2*ww)
                s = rotation_shift(theta, th)
                local = jnp.clip((s - s0) % th, 0, window_w - 1)
                lane = jnp.arange(sm, dtype=jnp.int32)[None, :]
                cost = jnp.sum(
                    jnp.where(lane == local[:, None], rows, 0.0), 1
                )
                norm = jnp.sum(
                    jnp.where(
                        lane == window_w + local[:, None], rows, 0.0
                    ),
                    1,
                )
                kf = out_kf.reshape(-1)[cell16] / (th * r)
                return cost, norm, kf
            out4, roy, rox = cost_field_s2d(
                padded4d, kernel, jnp.stack([oy, ox]), mo, region,
                s_out,
            )
            rows2d = out4.reshape(-1, s_out)
            nxb = region // F_S2D + 1
            jy = iy + roy
            jx = ix + rox
            cell = (
                ((jy // F_S2D) * nxb + jx // F_S2D) * 16
                + (jy % F_S2D) * F_S2D
                + jx % F_S2D
            )
        else:
            kernel = build_conv_kernel(
                scan, class_weights, stencil, f, mo, mode, num_rot,
                window_w, s0,
            )
            field = cost_field(
                padded3d,
                kernel,
                jnp.stack([oy, ox]),
                mo,
                region,
                s_out,
            )
            rows2d = field.reshape(-1, s_out)
            cell = iy * region + ix
        # ONE (n, s_out) row gather + lane selects feed every column
        # the mode needs
        rows = rows2d[cell]  # (n, s_out)
        if mode == "tracked":
            s = rotation_shift(theta, th)
            # column within the circular window; clamped for noise-tail
            # outliers (they read the window edge)
            local = jnp.clip((s - s0) % th, 0, window_w - 1)
            lane = jnp.arange(s_out, dtype=jnp.int32)[None, :]
            # where() keeps other lanes out of the sum while the
            # selected lane's value (incl. a NaN) propagates
            cost = jnp.sum(
                jnp.where(lane == local[:, None], rows, 0.0), 1
            )
            norm = jnp.sum(
                jnp.where(lane == window_w + local[:, None], rows, 0.0),
                1,
            )
            kf = rows[:, 2 * window_w] / (th * r)
            return cost, norm, kf
        # init: all num_rot shifts per particle, from the same rows
        costs = rows[:, :num_rot]
        norms = rows[:, num_rot : 2 * num_rot]
        kf = rows[:, 2 * num_rot] / (th * r)
        return costs, norms, kf

    return score
