"""Parity tests for the crop scorer (filter/crop_score.py).

The crop path contracts each particle's map window with the stencil-
folded circulant in plain XLA.  These tests compare it with the exact-
gather parity reference (filter/scoring.py::score_all_rotations),
covering:

  - tracked, init (theta-search) and mixed modes, at both crop buckets
    (mo 12 / 24) and at mip levels 1, 2 and 4,
  - map-edge windows reading the zero border (dist 0 / known 0, the
    reference's out-of-bounds semantics,
    /root/reference/src/top_down_map_polar.cpp:38-50),
  - fully off-map centers (kf 0).

The map is stored bf16 on the crop path (f32 on the exact path) and the
crop path samples at round(center) + round(offset) where the exact path
rounds the sum (<= 1 px apart), so cost parity is tolerance-based; a
perturbed scorer (wrong shift, wrong pixel, wrong bucket) produces O(1)
relative errors on most particles and fails these bounds by orders of
magnitude.  (The file and test names predate the XLA formulation and
are kept.)
"""

import numpy as np
import jax.numpy as jnp
import pytest

from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import Particles
from top_down_renderer_tpu.filter import conv_score as cs
from top_down_renderer_tpu.filter import crop_score as crop
from top_down_renderer_tpu.filter.filter import (
    compute_weights,
    make_update_step_fast,
    select_init_cost,
)
from top_down_renderer_tpu.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    search_shifts,
)
from top_down_renderer_tpu.maps.polar import polar_stencil

H = W = 160
C = 3
TH, R = 100, 25
F = 0.5  # scale * res -> mo bucket 12
N = 256  # 128 residual-grid + 5 edge + 2 far-out + 121 random


def _world(h=H, w=W, seed=3):
    rng = np.random.default_rng(seed)
    packed = np.zeros((h, w, 8), np.float32)
    packed[..., :C] = rng.random((h, w, C)) * 50
    packed[..., C] = (rng.random((h, w)) < 0.9).astype(np.float32)
    stencil = polar_stencil(TH, R)
    scan = (rng.random((C, TH, R)) * 3).astype(np.float32)
    cw = jnp.asarray([1.0, 2.0, 0.5], jnp.float32)
    return packed, stencil, scan, cw, rng


def _centers(rng):
    # a 16x8 integer-center grid
    xs, ys = np.meshgrid(np.arange(16), np.arange(8))
    grid = np.stack([40.0 + xs.ravel(), 40.0 + ys.ravel()], -1)
    # map-edge centers whose windows read the zero border
    edges = np.array(
        [[1, 80], [W - 2, 80], [80, 1], [80, H - 2], [2, 2]], float
    )
    # far outside the padded map -> kf 0
    far = np.array([[-300.0, 80.0], [80.0, H + 300.0]])
    rnd = rng.integers(2, min(H, W) - 2, (N - len(grid) - 7, 2))
    out = np.concatenate([grid, edges, far, rnd]).astype(np.float32)
    assert out.shape == (N, 2)
    return out


def _exact(packed, stencil, scan, cw, centers, f, mip=1):
    costs, kf = score_all_rotations(
        jnp.asarray(packed),
        jnp.asarray(stencil),
        jnp.asarray(scan),
        cw,
        jnp.asarray(centers),
        jnp.full(len(centers), 1.0, jnp.float32),  # scale 1 -> f = res
        jnp.asarray(f, jnp.float32),
        num_classes=C,
        map_resolution=float(mip),
        chunk_size=len(centers),
    )
    return np.asarray(costs), np.asarray(kf)


@pytest.fixture(scope="module")
def setup():
    packed, stencil, scan, cw, rng = _world()
    maps = cs.build_padded_maps(jnp.asarray(packed))
    centers = _centers(rng)
    costs_e, kf_e = _exact(packed, stencil, scan, cw, centers, F)
    return stencil, scan, cw, maps, centers, costs_e, kf_e, rng


def _check(ref, got, kf_ref, kf_got, label):
    # fully out-of-range centers: both paths report known-fraction 0
    far = kf_ref == 0.0
    assert np.all(kf_got[far] == 0.0), f"{label}: far-out kf != 0"
    ok = (kf_ref >= 0.5) & ~np.isnan(ref)
    rel = np.abs(ref[ok] - got[ok]) / np.maximum(np.abs(ref[ok]), 1e-9)
    assert np.median(rel) < 5e-3, f"{label}: median rel {np.median(rel)}"
    assert np.mean(rel) < 2e-2, f"{label}: mean rel {np.mean(rel)}"
    assert np.mean(rel > 0.1) < 0.02, (
        f"{label}: {np.mean(rel > 0.1):.1%} outliers > 10%"
    )
    assert np.max(np.abs(kf_ref - kf_got)) < 1e-2, f"{label}: kf mismatch"


def test_tracked_interpret_parity(setup):
    stencil, scan, cw, maps, centers, costs_e, kf_e, rng = setup
    mo = cs.pick_crop_size(F, R, crop.MO_BUCKETS)
    assert mo == 12
    thetas = (rng.random(N) * 2 * np.pi).astype(np.float32)
    num, den, kf = crop.score_tracked(
        maps,
        jnp.asarray(stencil),
        jnp.asarray(scan),
        cw,
        jnp.asarray(centers),
        jnp.asarray(thetas),
        F,
        mo,
    )
    s = np.asarray(rotation_shift(jnp.asarray(thetas), TH))
    ref = costs_e[np.arange(N), s]
    got = np.asarray(num) / np.asarray(den)
    _check(ref, got, kf_e, np.asarray(kf), "tracked")


def test_mip_crop_parity():
    """Exploration-regime mip path: scoring against a mip-strided map
    with f/mip at resolution*mip must equal the exact gather evaluated
    on that same subsampled map (filter.py dispatches exactly these
    arguments when scale*res exceeds every crop bucket)."""
    mip, f = 4, 4.0  # f_eff = 1.0 -> mo 24
    hh = ww_ = 320
    packed, stencil, scan, cw, rng = _world(hh, ww_, seed=11)
    packed_mip = packed[::mip, ::mip]
    maps = cs.build_padded_maps(jnp.asarray(packed_mip))

    n = 128
    # centers on multiples of mip (exact c/mip), covering a 16x7 grid
    xs, ys = np.meshgrid(np.arange(16), np.arange(7))
    grid = np.stack(
        [120.0 + mip * xs.ravel(), 120.0 + mip * ys.ravel()], -1
    )
    rnd = mip * rng.integers(8, (hh - 32) // mip, (n - len(grid), 2))
    centers = np.concatenate([grid, rnd]).astype(np.float32)

    costs_e, kf_e = _exact(
        packed_mip, stencil, scan, cw, centers, f / mip, mip
    )
    mo = cs.pick_crop_size(f / mip, R, crop.MO_BUCKETS)
    assert mo == 24
    nums, dens, kf = crop.score_init(
        maps,
        jnp.asarray(stencil),
        jnp.asarray(scan),
        cw,
        jnp.asarray(centers),
        f / mip,
        mo,
        map_resolution=float(mip),
    )
    ssh = np.asarray(search_shifts(TH, 40))
    ref = costs_e[:, ssh]
    got = np.asarray(nums) / np.asarray(dens)
    kf_b = np.broadcast_to(np.asarray(kf)[:, None], ref.shape)
    kfe_b = np.broadcast_to(kf_e[:, None], ref.shape)
    _check(ref.ravel(), got.ravel(), kfe_b.ravel(), kf_b.ravel(), "mip")


def _particles(centers, thetas, have_init):
    n = len(centers)
    return Particles(
        init_px=jnp.asarray(centers, jnp.float32),
        d_m=jnp.zeros((n, 2), jnp.float32),
        theta=jnp.asarray(thetas, jnp.float32),
        scale=jnp.ones(n, jnp.float32),
        have_init=jnp.asarray(have_init),
        weight=jnp.full(n, 1.0 / n, jnp.float32),
        last_dist=jnp.ones(n, jnp.float32),
        alive=jnp.ones(n, bool),
    )


def _score_impl(mode, mo, mip):
    params = FilterParams(fixed_scale=1.0, class_weights=[1.0, 2.0, 0.5])
    return make_update_step_fast(
        params, C, 1.0, TH, N, mode, mo=mo, path="crop", mip=mip,
    )._score_impl


def test_init_sel_matches_host_epilogue(setup):
    """The fast step's init scoring (filter.make_update_step_fast,
    path="crop") must equal the crop scorer's rows fed through the
    host epilogue (nums/dens, kf<0.5 -> NaN, select_init_cost) - same
    rows, same f32 ops, so the agreement is exact."""
    stencil, scan, cw, maps, centers, costs_e, kf_e, rng = setup
    mo = cs.pick_crop_size(F, R, crop.MO_BUCKETS)
    nums, dens, kf = crop.score_init(
        maps, jnp.asarray(stencil), jnp.asarray(scan), cw,
        jnp.asarray(centers), F, mo,
    )
    costs = jnp.asarray(nums) / jnp.asarray(dens)
    costs = jnp.where(jnp.asarray(kf)[:, None] < 0.5, jnp.nan, costs)
    ref_cost, ref_theta = select_init_cost(costs, 40)

    p = _particles(centers, np.zeros(N), np.zeros(N, bool))
    got_cost, got_theta = _score_impl("init", mo, 1)(
        p, maps, jnp.asarray(stencil), jnp.asarray(scan),
        jnp.asarray(F, jnp.float32), jnp.asarray(0, jnp.int32),
    )
    np.testing.assert_array_equal(
        np.asarray(got_cost), np.asarray(ref_cost)
    )
    np.testing.assert_allclose(
        np.asarray(got_theta), np.asarray(ref_theta), rtol=0, atol=1e-6
    )


def test_init_interpret_parity(setup):
    stencil, scan, cw, maps, centers, costs_e, kf_e, rng = setup
    mo = cs.pick_crop_size(F, R, crop.MO_BUCKETS)
    nums, dens, kf = crop.score_init(
        maps,
        jnp.asarray(stencil),
        jnp.asarray(scan),
        cw,
        jnp.asarray(centers),
        F,
        mo,
    )
    ssh = np.asarray(search_shifts(TH, 40))
    ref = costs_e[:, ssh]
    got = np.asarray(nums) / np.asarray(dens)
    kf_b = np.broadcast_to(np.asarray(kf)[:, None], ref.shape)
    kfe_b = np.broadcast_to(kf_e[:, None], ref.shape)
    _check(ref.ravel(), got.ravel(), kfe_b.ravel(), kf_b.ravel(), "init")


@pytest.mark.parametrize("mode", ["tracked", "init", "mixed"])
@pytest.mark.parametrize("mip", [1, 2, 4])
@pytest.mark.parametrize("mo", [12, 24])
def test_crop_step_parity(mo, mip, mode):
    """The fast step's crop scoring (the argument wiring filter.py
    dispatches: f/mip at resolution*mip on the mip-strided map) against
    the exact gather on the same subsampled map, for every crop bucket,
    mip level and scoring mode."""
    f_eff = {12: 0.5, 24: 1.0}[mo]
    f = f_eff * mip
    packed, stencil, scan, cw, rng = _world(seed=20 + mo + mip)
    packed_mip = packed[::mip, ::mip]
    h, w = packed_mip.shape[:2]
    n = 64
    # interior, edge and off-map centers (multiples of mip: the mip
    # path scores round(c / mip))
    cells = np.concatenate(
        [
            rng.integers(1, min(h, w) - 1, (n - 4, 2)),
            [[0, h // 2], [w - 1, h // 2], [-200, 5], [5, h + 200]],
        ]
    )
    centers = (cells * mip).astype(np.float32)
    thetas = (rng.random(n) * 2 * np.pi).astype(np.float32)
    have = {
        "tracked": np.ones(n, bool),
        "init": np.zeros(n, bool),
        "mixed": rng.random(n) < 0.5,
    }[mode]
    costs_e, kf_e = _exact(packed_mip, stencil, scan, cw, centers,
                           f / mip, mip)
    p = _particles(centers, thetas, have)
    maps = cs.build_padded_maps(jnp.asarray(packed_mip))
    params = FilterParams(fixed_scale=1.0, class_weights=[1.0, 2.0, 0.5])
    score = make_update_step_fast(
        params, C, 1.0, TH, n, mode, mo=mo, path="crop", mip=mip,
    )._score_impl
    cost, theta = score(
        p, maps, jnp.asarray(stencil), jnp.asarray(scan),
        jnp.asarray(f, jnp.float32), jnp.asarray(0, jnp.int32),
    )
    cost, theta = np.asarray(cost), np.asarray(theta)
    # exact per-particle select (state_particle.cpp:188-210) on the
    # exact costs; off-map particles (kf 0) score NaN / FLT_MAX on both
    w_ref, theta_ref, _ = compute_weights(
        jnp.asarray(costs_e), p, params,
        jnp.asarray([1e9, 1e9], jnp.float32), TH,
    )
    w_ref = np.asarray(w_ref)
    w_got = 1.0 / (cost + params.regularization)
    ok = np.isfinite(w_ref) & (kf_e >= 0.5)
    assert ok.sum() > 0.8 * n
    rel = np.abs(w_got[ok] - w_ref[ok]) / np.abs(w_ref[ok])
    assert np.median(rel) < 5e-3, np.median(rel)
    assert np.mean(rel > 0.05) < 0.05, np.mean(rel > 0.05)
    off = kf_e == 0.0
    assert off.sum() >= 2
    if mode == "tracked":
        assert np.all(np.isnan(cost[off]))
    else:
        assert np.all(np.isnan(cost[off]) | (cost[off] > 1e30))
    # tracked particles keep their theta; searched ones adopt a search
    # rotation whose EXACT cost is within tolerance of the exact best
    np.testing.assert_allclose(theta[have], thetas[have], atol=1e-6)
    ssh = np.asarray(search_shifts(TH, 40))
    sel = ok & ~have
    if sel.any():
        ce = np.where(np.isnan(costs_e[:, ssh]), np.inf, costs_e[:, ssh])
        k = np.round(theta[sel] / (2 * np.pi / 40)).astype(int) % 40
        np.testing.assert_allclose(
            ce[sel, k], ce[sel].min(axis=1), rtol=5e-3, atol=1e-4
        )


def test_crop_off_map_windows_read_zero():
    """Windows reaching past the map read the zero border exactly like
    the exact gather's out-of-bounds reads, and a center far off the
    map (beyond the padded border) reads only zeros: every cost, norm
    and known count is 0, never a clamped in-map window."""
    packed, stencil, scan, cw, rng = _world(seed=5)
    maps = cs.build_padded_maps(jnp.asarray(packed))
    centers = np.array(
        [[-1.0, 80.0], [W + 3.0, 40.0], [80.0, -20.0], [-24.0, -24.0],
         [-5000.0, 80.0], [80.0, 7000.0], [1e6, -1e6], [80.0, 80.0]],
        np.float32,
    )
    costs_e, kf_e = _exact(packed, stencil, scan, cw, centers, 1.0)
    nums, dens, kf = map(np.asarray, crop.score_init(
        maps, jnp.asarray(stencil), jnp.asarray(scan), cw,
        jnp.asarray(centers), 1.0, 24,
    ))
    np.testing.assert_allclose(kf, kf_e, atol=1e-3)
    far = slice(4, 7)
    assert np.all(kf[far] == 0.0)
    assert np.all(nums[far] == 0.0) and np.all(dens[far] == 0.0)
    ssh = np.asarray(search_shifts(TH, 40))
    near = kf_e > 0.5
    assert near[-1]
    np.testing.assert_allclose(
        nums[near] / dens[near], costs_e[near][:, ssh], rtol=2e-2
    )
