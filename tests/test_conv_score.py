"""Conv grid-scoring parity vs the exact gather path (CPU; the conv
path is pure XLA, unlike the Pallas crop kernel)."""

import numpy as np
import jax
import jax.numpy as jnp

from top_down_renderer_tpu.filter import conv_score as cs
from top_down_renderer_tpu.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    search_shifts,
)
from top_down_renderer_tpu.maps.polar import polar_stencil

TH, R, C = 100, 25, 3


def _setup(seed=0, h=256, w=256, n=512):
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :C] = rng.random((h, w, C)) * 50
    packed[..., C] = (rng.random((h, w)) < 0.9).astype(np.float32)
    stencil = jnp.asarray(polar_stencil(TH, R))
    scan = jnp.asarray(rng.random((C, TH, R)) * 3, jnp.float32)
    cw = jnp.asarray([1.0, 2.0, 0.5], jnp.float32)
    centers = (
        np.array([100.0, 120.0])
        + rng.integers(0, 60, (n, 2))
    ).astype(np.float32)
    thetas = (rng.random(n) * 2 * np.pi).astype(np.float32)
    return packed, stencil, scan, cw, centers, thetas


def test_conv_tracked_matches_exact():
    f = 1.0  # integer f + integer centers -> identical NN sampling
    mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
    packed, stencil, scan, cw, centers, thetas = _setup()
    maps = cs.build_padded_maps(jnp.asarray(packed))
    scorer = cs.make_conv_scorer(mo, 64, "tracked")
    alive = jnp.ones(len(centers), bool)
    num, den, kf = scorer(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
    )
    cost = np.asarray(num / den)

    costs_e, kf_e = score_all_rotations(
        jnp.asarray(packed), stencil, scan, cw,
        jnp.asarray(centers),
        jnp.full(len(centers), 2.0, np.float32),
        jnp.asarray(0.5), num_classes=C, map_resolution=1.0,
        chunk_size=len(centers),
    )
    s = np.asarray(rotation_shift(jnp.asarray(thetas), TH))
    ref = np.asarray(costs_e)[np.arange(len(centers)), s]
    m = ~np.isnan(ref)
    assert m.any()
    np.testing.assert_allclose(
        cost[m], ref[m], rtol=3e-3, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(kf), np.asarray(kf_e), atol=1e-5
    )
    # NaN rule agreement
    conv_nan = np.asarray(kf) < 0.5
    np.testing.assert_array_equal(conv_nan, np.isnan(ref))


def test_conv_init_matches_exact():
    f = 1.0
    mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
    packed, stencil, scan, cw, centers, thetas = _setup(seed=1)
    maps = cs.build_padded_maps(jnp.asarray(packed))
    scorer = cs.make_conv_scorer(mo, 64, "init")
    alive = jnp.ones(len(centers), bool)
    nums, dens, kf = scorer(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
    )
    costs = np.asarray(nums / dens)
    costs_e, _ = score_all_rotations(
        jnp.asarray(packed), stencil, scan, cw,
        jnp.asarray(centers),
        jnp.full(len(centers), 1.0, np.float32),
        jnp.asarray(1.0), num_classes=C, map_resolution=1.0,
        chunk_size=len(centers),
    )
    ssh = np.asarray(search_shifts(TH, 40))
    ref = np.asarray(costs_e)[:, ssh]
    m = ~np.isnan(ref)
    np.testing.assert_allclose(costs[m], ref[m], rtol=3e-3, atol=1e-5)


def test_region_origin_ignores_dead_particles():
    f = 1.0
    mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
    packed, stencil, scan, cw, centers, thetas = _setup(seed=2, n=64)
    maps = cs.build_padded_maps(jnp.asarray(packed))
    scorer = cs.make_conv_scorer(mo, 64, "tracked")
    alive = jnp.ones(64, bool)
    # a dead outlier far away must not shift the region
    centers2 = centers.copy()
    centers2[0] = (5.0, 5.0)
    alive2 = alive.at[0].set(False)
    _, _, kf_a = scorer(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
    )
    _, _, kf_b = scorer(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers2), jnp.asarray(thetas), f, alive2,
    )
    np.testing.assert_allclose(
        np.asarray(kf_a)[1:], np.asarray(kf_b)[1:], atol=1e-6
    )


def test_s2d_field_matches_direct():
    """The phase-folded conv must reproduce the direct cost field
    bit-for-bit up to f32 accumulation order, at every (roy, rox)
    residual of the region origin."""
    rng = np.random.default_rng(7)
    mo = 12
    dr, dc = cs.conv_dims(mo)
    s_out = 9
    region = 64
    kernel = jnp.asarray(
        rng.standard_normal((dr, dc, 8, s_out)), jnp.bfloat16
    )
    packed = jnp.asarray(rng.random((200, 200, 8)), jnp.float32)
    maps = cs.build_padded_maps(packed)
    nxb = region // cs.F_S2D + 1
    for oy, ox in [(20, 20), (21, 34), (23, 33), (50, 17)]:
        origin = jnp.asarray([oy + maps.pad, ox + maps.pad])
        direct = np.asarray(
            cs.cost_field(
                maps.padded3d, kernel, origin, mo, region, s_out
            )
        )
        out4, roy, rox = cs.cost_field_s2d(
            maps.padded4d, kernel, origin, mo, region, s_out
        )
        out4 = np.asarray(out4)
        roy, rox = int(roy), int(rox)
        folded = np.zeros_like(direct)
        for iy in range(region):
            for ix in range(region):
                jy, jx = iy + roy, ix + rox
                ch = ((jy % 4) * 4 + jx % 4) * s_out
                folded[iy, ix] = out4[
                    jy // 4, jx // 4, ch : ch + s_out
                ]
        np.testing.assert_allclose(
            folded, direct, rtol=2e-2, atol=2e-2
        )


def test_conv_tracked_direct_path_matches_exact(monkeypatch):
    """Force the non-folded conv (K4 gate at 0) through the same parity
    check so both field implementations stay covered."""
    monkeypatch.setattr(cs, "K4_MAX_BYTES", 0)
    test_conv_tracked_matches_exact()


def test_fold_mm_parity():
    """The relabel-matmul fold is BIT-exact vs the slice/pad/transpose
    fold: its one-hot rows copy bf16 kernel values (never sum), and
    out-of-range (dy + py) cells stay exactly zero."""
    rng = np.random.default_rng(3)
    for mo in (12, 24):
        dr, dc = cs.conv_dims(mo)
        for s_out in (33, 81):
            k = jnp.asarray(
                rng.standard_normal((dr, dc, 8, s_out)), jnp.bfloat16
            )
            # jitted: XLA-CPU's eager DotThunk rejects bf16 x bf16
            ref = np.asarray(
                jax.jit(cs.fold_kernel_s2d)(k), np.float32
            )
            mm = np.asarray(
                jax.jit(cs.fold_kernel_s2d_mm)(k), np.float32
            )
            assert mm.shape == ref.shape
            np.testing.assert_array_equal(mm, ref)


def test_kf_split_matches_combined(monkeypatch):
    """TDR_KF_SPLIT=1 (32-aligned main fold + separate kf matmul) must
    reproduce the combined-kernel scorer: the main columns are the
    same k4 columns contracted over the same patches in the same f32
    order, and the kf column sees identical values."""
    f = 1.0
    mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
    packed, stencil, scan, cw, centers, thetas = _setup(seed=5)
    maps = cs.build_padded_maps(jnp.asarray(packed))
    alive = jnp.ones(len(centers), bool)
    # windowed tracked mode: pick s0 so every theta's shift falls in
    # [s0, s0+ww) modulo TH -- thetas drawn near a band
    thetas = (0.3 + 0.8 * np.random.default_rng(5).random(
        len(centers))).astype(np.float32)
    s0, ww = 3, 16
    args = (
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
        jnp.asarray(s0, jnp.int32),
    )
    monkeypatch.setenv("TDR_KF_SPLIT", "0")
    base = cs.make_conv_scorer(mo, 64, "tracked", window_w=ww)
    n0, d0, k0 = base(*args)
    monkeypatch.setenv("TDR_KF_SPLIT", "1")
    split = cs.make_conv_scorer(mo, 64, "tracked", window_w=ww)
    n1, d1, k1 = split(*args)
    np.testing.assert_allclose(
        np.asarray(n1), np.asarray(n0), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(d1), np.asarray(d0), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(k1), np.asarray(k0), rtol=1e-6, atol=1e-6
    )


def test_conv_int8_matches_bf16(monkeypatch):
    """TDR_CONV_INT8=1 (int8 map4 x hi/lo int8 kernel, i32
    accumulation) vs the bf16 kf-split scorer.  The hi/lo residual
    pair keeps cost/norm within ~1e-3 (single-plane rounding measured
    a -4% cost bias: 39% of the all-positive cost coefficients sit
    below half an LSB); kf counts carry value-correlated residuals
    (~5e-4 rel: same-count cells share one rounding error), so the
    kf<0.5 NaN gate is asserted only off the knife edge."""
    f = 1.0
    mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
    packed, stencil, scan, cw, centers, thetas = _setup(seed=7)
    maps = cs.build_padded_maps(jnp.asarray(packed))
    assert maps.padded4d_i8 is not None
    alive = jnp.ones(len(centers), bool)
    thetas = (0.3 + 0.8 * np.random.default_rng(7).random(
        len(centers))).astype(np.float32)
    s0, ww = 3, 16
    monkeypatch.setenv("TDR_KF_SPLIT", "1")
    base = cs.make_conv_scorer(mo, 64, "tracked", window_w=ww)
    n0, d0, k0 = base(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
        jnp.asarray(s0, jnp.int32),
    )
    monkeypatch.setenv("TDR_CONV_INT8", "1")
    i8 = cs.make_conv_scorer(mo, 64, "tracked", window_w=ww)
    n1, d1, k1 = i8(
        maps.padded3d, maps.padded4d, maps.pad, stencil, scan, cw,
        jnp.asarray(centers), jnp.asarray(thetas), f, alive,
        jnp.asarray(s0, jnp.int32),
        padded4d_i8=maps.padded4d_i8, qinv=maps.qinv4d,
    )
    c0 = np.asarray(n0) / np.asarray(d0)
    c1 = np.asarray(n1) / np.asarray(d1)
    m = ~np.isnan(c0)
    assert m.any()
    err = np.abs(c1[m] - c0[m]) / np.maximum(np.abs(c0[m]), 1e-6)
    assert np.median(err) < 1e-3, np.median(err)
    assert err.max() < 1e-2, err.max()
    np.testing.assert_allclose(
        np.asarray(k1), np.asarray(k0), rtol=2e-3, atol=2e-3
    )
    off_edge = np.abs(np.asarray(k0) - 0.5) > 2e-3
    np.testing.assert_array_equal(
        (np.asarray(k1) < 0.5)[off_edge],
        (np.asarray(k0) < 0.5)[off_edge],
    )
