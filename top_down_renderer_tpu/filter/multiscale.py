"""Unknown-scale fast path: K discrete scale buckets in one crop pass.

The reference's global-localization init draws 10 discrete scale
hypotheses per position (10^{k/10}, /root/reference/src/particle_filter.cpp:19-25,
state_particle.cpp:14-18) and diffuses them with <=2% multiplicative
noise per step (state_particle.cpp:71-74).  Until the scale freezes, the
particle scales therefore stay clustered around few discrete values -
but they are NOT uniform, so the uniform-f crop scorer
(filter/crop_score.py) does not apply as is.  Scale buckets are just
more kernel matrices:

  1. Host-side, cluster the alive log-scales into K <= MAX_BUCKETS
     slots (greedy 1-D clustering with relative tolerance SCALE_RTOL;
     at init the population is exactly the 10 discrete hypotheses, so
     clustering is exact).
  2. Build one M per bucket at the bucket's effective
     f_eff = slot*res/mip (one vmapped kernel build).
  3. Per-bucket mip levels ride a PYRAMID of the padded map (levels
     concatenated along rows); a particle's window origin is offset into
     its bucket's level.  One crop pass scores every particle against
     its own bucket's M at its own mip (crop_score.crop_rows orders the
     particles bucket-major).

Scoring semantics per particle: pose_px uses the particle's OWN
continuous scale; only the stencil offsets use the bucket's quantized
f (error <= SCALE_RTOL * (range_bins-1) px <= the NN rounding the crop
path already has).  Scales themselves are never modified - freeze_scale
still sees the continuous values, so there is nothing to de-quantize.
"""

from __future__ import annotations

import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from top_down_renderer_tpu.core import struct
from top_down_renderer_tpu.filter import crop_score as crop
from top_down_renderer_tpu.filter.conv_score import MAP_PAD

# bucket count cap: each bucket is one more kernel matrix and at most one
# partly empty particle chunk (crop_score.crop_rows).  16 covers the
# whole 10-hypothesis init range after diffusion at the coarsest rtol
# rung (0.9-8.8x: 15 slots at rtol 0.08)
MAX_BUCKETS = 16
# static bucket counts the slot table is padded to (fewer recompiles as
# buckets die off)
BUCKET_PAD = (2, 4, 8, 12, MAX_BUCKETS)
# coarsest pyramid level: at the node's initial 4 m/bin range scale the
# largest init hypotheses (~8.8 px/m after diffusion) reach f = 35 px per
# range bin, which the mo-12 window covers only at mip 128
MAX_MIP = 128
SCALE_RTOL = 0.02  # max |scale - slot| / slot within a bucket
# clustering tolerance ladder: diffusion (2%/step multiplicative,
# state_particle.cpp:71-74) spreads the surviving hypotheses into a
# continuum that exceeds MAX_BUCKETS at the base rtol; coarser slots
# keep the population on the fast path (slot quantization error
# rtol*(range_bins-1) px <= ~2 px at 0.08) instead of falling ~300x
# to the exact gather (observed in the r5 unknown-scale drive once the
# fallback started logging)
RTOL_LADDER = (SCALE_RTOL, 0.04, 0.08)
MO_MULTI = 12  # coarse static crop bucket (wide-posterior phase)
MO_MULTI_FINE = 24  # fine crop bucket (sharpened-posterior phase)
# adaptive threshold: alive-scale spread (robust p2/p98 ratio) at or
# below this scores at the fine mo.  1.6 = two adjacent discrete
# hypotheses (10^{1/10} = 1.26 apart, particle_filter.cpp:19-25) plus
# diffusion margin: once <=2 neighbors remain, mip-px granularity is
# what separates them, and the frozen-scale quality it buys dominates
# the rest of the drive (see multi_mo docstring for the measured A/B)
MULTI_FINE_SPREAD = 1.60


def multi_mo(scale_spread: float = float("inf")) -> int:
    """Crop bucket for the K-bucket multi path, adaptive in the width
    of the scale posterior (max/min ratio of the alive scales).

    mo=12 scores every bucket one mip level coarser than the f_eff <= 1
    assignment (f_eff <= 0.5: stencil NN granularity 2 mip px), with a
    4x smaller window; mo=24 is finest-mip granularity.

    The multi path only runs for the ~50-100 pre-freeze steps of a
    drive, but the scale it freezes poisons (or doesn't) the entire
    remaining drive - so precision wins whenever <=2 adjacent
    hypotheses remain (spread <= 1.6) and coarse speed is reserved for
    the genuinely multi-hypothesis culling phase (the 10 discrete init
    hypotheses span 7.9x).  In the earlier seed-matched 3-run
    unknown-scale city drives, fixed mo=24 froze a better scale than
    fixed mo=12, and a gate at spread 1.20 fired too late to help.  (A
    bucket-count gate does NOT work: diffusion keeps the blob split
    across 3-8 rtol-width slots all the way to the freeze, so kp never
    drops to the init-distinct range.)  TDR_MULTI_MO=12|24 forces a
    fixed value for A/B sweeps."""
    v = os.environ.get("TDR_MULTI_MO", "")
    if v:
        v = int(v)
        assert v in (MO_MULTI, MO_MULTI_FINE), v
        return v
    return (
        MO_MULTI_FINE if scale_spread <= MULTI_FINE_SPREAD
        else MO_MULTI
    )


def cluster_scales(
    scales: np.ndarray, rtol: float = SCALE_RTOL,
    max_buckets: int = MAX_BUCKETS,
) -> np.ndarray | None:
    """Greedy 1-D clustering of positive scales in log space.

    Returns (K,) slot values (geometric bucket centers) with every
    input within rtol of its nearest slot, or None if that needs more
    than max_buckets slots."""
    u = np.unique(scales[scales > 0])
    if u.size == 0:
        return None
    logs = np.log(u)
    width = np.log1p(rtol) * 2.0  # cluster span so center err <= rtol
    slots = []
    start = logs[0]
    for i in range(1, len(logs) + 1):
        if i == len(logs) or logs[i] - start > width:
            slots.append(0.5 * (start + logs[i - 1]))
            if i < len(logs):
                start = logs[i]
            if len(slots) > max_buckets:
                return None
    return np.exp(np.asarray(slots, np.float64)).astype(np.float32)


def mip_for_f(f: float, fmax: float = 1.0) -> int | None:
    """Smallest power-of-2 mip with f/mip <= fmax, or None if even
    MAX_MIP saturates (callers fall back to the exact gather).

    fmax is the largest per-mip-pixel stencil step the static MO_MULTI
    crop bucket covers: MO_MULTI / (range_bins - 1).  The default 1.0
    is the 25-range-bin stencil (mo=24 covers 24 unit steps); wider
    stencils (e.g. the 50-bin library default) need proportionally
    smaller fmax so no stencil offset lands outside the crop."""
    m = 1
    while f / m > fmax:
        if m >= MAX_MIP:
            return None
        m *= 2
    return m


# ---------------------------------------------------------------------
# Mip pyramid
# ---------------------------------------------------------------------


@struct.dataclass
class PyramidMaps:
    """Zero-padded mip levels of the packed map stacked along rows.

    Level l (a mips[l]-strided subsample) occupies rows
    [row_off[l], row_off[l] + h[l] + 2*pad) of `padded`, with a
    `pad`-pixel zero border on every side; all levels share the width
    of the finest (coarser ones are zero-padded right)."""

    padded: jnp.ndarray  # (H_tot, W_max, 8) bf16
    mips: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    row_off: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    h: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    w: Tuple[int, ...] = struct.field(pytree_node=False, default=())
    pad: int = struct.field(pytree_node=False, default=0)


def build_pyramid_maps(
    packed: jnp.ndarray, mips: Tuple[int, ...], pad: int = MAP_PAD
) -> PyramidMaps:
    """(H, W, 8) f32 full-res packed map -> pyramid over `mips`."""
    levels = [packed[::m, ::m].astype(jnp.bfloat16) for m in mips]
    wmax = max(lv.shape[1] for lv in levels) + 2 * pad
    offs, off = [], 0
    for lv in levels:
        offs.append(off)
        off += lv.shape[0] + 2 * pad
    padded = jnp.concatenate(
        [
            jnp.pad(
                lv,
                ((pad, pad), (pad, wmax - lv.shape[1] - pad), (0, 0)),
            )
            for lv in levels
        ],
        axis=0,
    )
    return PyramidMaps(
        padded=padded,
        mips=tuple(mips),
        row_off=tuple(offs),
        h=tuple(int(lv.shape[0]) for lv in levels),
        w=tuple(int(lv.shape[1]) for lv in levels),
        pad=pad,
    )


# ---------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------


def assign_buckets(scale: jnp.ndarray, slot_vals: jnp.ndarray):
    """Nearest slot in log space (slot values are host-chosen)."""
    d = jnp.abs(
        jnp.log(jnp.maximum(scale, 1e-20))[:, None]
        - jnp.log(slot_vals)[None, :]
    )
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def _multi_rows(pyr, bucket_mip_idx, mo, mode, num_rot, map_resolution,
                stencil, scan, class_weights, center_px, scale,
                slot_vals, res):
    """(n, S) crop rows, each particle scored with its bucket's M on its
    bucket's pyramid level."""
    th = stencil.shape[0]
    mips_b = jnp.asarray(
        [pyr.mips[i] for i in bucket_mip_idx], jnp.float32
    )
    f_eff = slot_vals * res / mips_b  # (K,)
    kernels = jax.vmap(
        lambda f: crop.kernel_matrix(
            scan, class_weights, stencil, f, mo, mode, num_rot, th
        )
    )(f_eff)
    bucket = assign_buckets(scale, slot_vals)
    lvl = jnp.asarray(
        [[pyr.row_off[i], pyr.h[i], pyr.w[i]] for i in bucket_mip_idx],
        jnp.int32,
    )[bucket]  # (n, 3)
    oy, ox = crop.window_origins(
        center_px, map_resolution * mips_b[bucket], mo, lvl[:, 1],
        lvl[:, 2], pyr.pad,
    )
    return crop.crop_rows(
        pyr.padded, oy + lvl[:, 0], ox, kernels, bucket, mo
    )


def make_score_init_multi(
    bucket_mip_idx: Tuple[int, ...],
    num_rot: int = 40,
    map_resolution: float = 1.0,
    mo: int = MO_MULTI,
):
    """Theta-search scorer over K scale buckets (bucket k scores on
    pyramid level bucket_mip_idx[k]): returns
    score(pyr, stencil, scan, cw, center_px, scale, slot_vals, res)
    -> (nums (N, num_rot), dens (N, num_rot), kf (N,))."""

    def score(pyr, stencil, scan, class_weights, center_px, scale,
              slot_vals, res):
        th, r, _ = stencil.shape
        rows = _multi_rows(
            pyr, bucket_mip_idx, mo, "init", num_rot, map_resolution,
            stencil, scan, class_weights, center_px, scale, slot_vals,
            res,
        )
        return crop.init_split(rows, num_rot, th, r)

    return score


def make_score_tracked_multi(
    bucket_mip_idx: Tuple[int, ...],
    map_resolution: float = 1.0,
    mo: int = MO_MULTI,
):
    """Tracked-mode scorer over K scale buckets: returns
    score(pyr, stencil, scan, cw, center_px, theta, scale, slot_vals,
    res) -> (cost_num, norm, kf) at each particle's rotation shift."""

    def score(pyr, stencil, scan, class_weights, center_px, theta,
              scale, slot_vals, res):
        th, r, _ = stencil.shape
        rows = _multi_rows(
            pyr, bucket_mip_idx, mo, "tracked", 0, map_resolution,
            stencil, scan, class_weights, center_px, scale, slot_vals,
            res,
        )
        return crop.tracked_select(rows, theta, th, r)

    return score
