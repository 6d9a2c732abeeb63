"""Mixed have_init populations stay on the fast scoring paths.

A mid-run partial reinit (a subset of particles redrawn with no theta
prior) used to drop dispatch to the exact gather, the slow path.  Now
_fast_mode returns mode="mixed" and every fast step runs both scoring
flavors plus the exact path's per-particle
select (compute_weights semantics, state_particle.cpp:188-210).
"""

import logging

import numpy as np
import jax.numpy as jnp
import pytest

from top_down_renderer_tpu.config import FilterParams, MapParams
from top_down_renderer_tpu.filter.filter import (
    ParticleFilter,
    compute_weights,
)
from top_down_renderer_tpu.filter.scoring import score_all_rotations
from top_down_renderer_tpu.maps.map import TopDownMap, build_grid
from util_synthetic import make_world


def _tdm():
    maps = make_world()
    tdm = TopDownMap(
        MapParams(map_path="", num_classes=3, resolution=1.0)
    )
    tdm.grid = build_grid(maps, 1.0, 50.0)
    tdm.class_maps_binary = maps
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    return tdm


def _pf(fixed_scale=2.0, n=256, clustered=True, **kw):
    params = FilterParams(
        fixed_scale=fixed_scale, class_weights=[1, 1, 1], **kw
    )
    if clustered:
        # Gaussian prior around a map point -> small bbox -> conv path
        params.init_pos_px_x = 100.0
        params.init_pos_px_y = 100.0
        params.init_pos_px_cov = 6.0
    pf = ParticleFilter(
        n, _tdm(), params, seed=0, chunk_size=n, use_fast=True
    )
    return pf


def _mixed(pf, frac=0.3, seed=5):
    pf.state = pf.state.replace(
        particles=pf.state.particles.replace(
            have_init=jnp.ones_like(pf.state.particles.have_init)
        )
    )
    pf._all_have_init = False  # force the per-particle re-check
    pf.reinitialize_fraction(frac, seed=seed)
    return pf


def test_reinitialize_fraction_state():
    pf = _pf()
    pf.state = pf.state.replace(
        particles=pf.state.particles.replace(
            have_init=jnp.ones_like(pf.state.particles.have_init)
        )
    )
    before = np.asarray(pf.state.particles.init_px).copy()
    pf.reinitialize_fraction(0.25, seed=7)
    p = pf.state.particles
    have = np.asarray(p.have_init)
    alive = np.asarray(p.alive)
    k = int((~have[alive]).sum())
    assert k == round(0.25 * alive.sum())
    # redrawn particles moved to road cells and lost their theta prior
    moved = np.any(np.asarray(p.init_px) != before, axis=1)
    assert np.array_equal(moved[alive], ~have[alive])
    road = np.asarray(pf.map.grid.road_ok)
    for x, y in np.asarray(p.init_px)[alive][~have[alive]]:
        assert road[int(round(y)), int(round(x))]
    assert not pf._all_have_init


def test_dispatch_coverage_matrix():
    """Enumerate (scale regime, init state) -> dispatch path.  The ONLY
    exact-gather cells are the documented ones (scale continuum /
    saturated mip), never a mixed-init population."""
    rows = []

    # fixed scale, clustered cloud
    for initstate in ("all", "none", "mixed"):
        pf = _pf()
        if initstate == "all":
            pf.state = pf.state.replace(
                particles=pf.state.particles.replace(
                    have_init=jnp.ones_like(
                        pf.state.particles.have_init
                    )
                )
            )
            pf._all_have_init = True
        elif initstate == "mixed":
            _mixed(pf)
        out = pf._fast_mode(0.5)
        assert out is not None, f"fixed/{initstate} fell to exact"
        rows.append(("fixed", initstate, out[0], out[3]))
        want = {"all": "tracked", "none": "init", "mixed": "mixed"}
        assert out[0] == want[initstate]
        assert out[3] in ("conv", "crop")

    # unknown scale (10 discrete hypotheses) -> multi path
    for initstate in ("none", "mixed"):
        pf = _pf(fixed_scale=-1.0)
        if initstate == "mixed":
            _mixed(pf)
        out = pf._fast_mode(0.5)
        assert out is not None, f"multi/{initstate} fell to exact"
        assert out[3] == "multi"
        want = {"none": "init", "mixed": "mixed"}
        assert out[0] == want[initstate]
        rows.append(("unknown", initstate, out[0], out[3]))

    # scale continuum: the one documented exact-gather cell
    pf = _pf(fixed_scale=-1.0)
    rng = np.random.default_rng(3)
    n = pf.state.particles.scale.shape[0]
    pf.state = pf.state.replace(
        particles=pf.state.particles.replace(
            # a log-uniform continuum over 1.3 decades: more than
            # MAX_BUCKETS slots even at the coarsest rtol rung
            scale=jnp.asarray(
                10.0 ** rng.uniform(0, 1.3, n), jnp.float32
            )
        )
    )
    assert pf._fast_mode(0.5) is None
    rows.append(("continuum", "none", None, "exact"))

    # every non-continuum cell stayed fast
    assert all(r[3] != "exact" for r in rows[:-1])


def test_exact_fallback_logs_loudly(caplog):
    pf = _pf(fixed_scale=-1.0)
    rng = np.random.default_rng(3)
    n = pf.state.particles.scale.shape[0]
    pf.state = pf.state.replace(
        particles=pf.state.particles.replace(
            # a log-uniform continuum over 1.3 decades: more than
            # MAX_BUCKETS slots even at the coarsest rtol rung
            scale=jnp.asarray(
                10.0 ** rng.uniform(0, 1.3, n), jnp.float32
            )
        )
    )
    with caplog.at_level(
        logging.WARNING, logger="top_down_renderer_tpu.filter.filter"
    ):
        assert pf._fast_mode(0.5) is None
        assert pf._fast_mode(0.5) is None  # dedup: logged once
    msgs = [r for r in caplog.records if "exact-gather" in r.message]
    assert len(msgs) == 1


def test_mixed_conv_score_matches_exact():
    """The mixed fast score (conv path) = the exact path's per-particle
    tracked/init select, within the conv parity tolerance."""
    pf = _pf()
    _mixed(pf)
    fast = pf._fast_mode(0.5)
    assert fast is not None and fast[0] == "mixed"
    mode, mo, scale_h, path, region, s0, ww, mip = fast
    assert path == "conv", "clustered prior should pick the conv field"
    fn = pf._get_fast_fn(mode, mo, path, region, ww, mip)
    score_impl = fn._score_impl

    g = pf.map.grid
    rng = np.random.default_rng(11)
    scan = jnp.asarray(
        rng.random((g.num_classes, 100, 25)) * 3, jnp.float32
    )
    stencil = jnp.asarray(pf.map.stencil)
    res = jnp.asarray(0.5, jnp.float32)
    p = pf.state.particles
    cost, theta = score_impl(
        p, pf._get_padded_maps(mip), stencil, scan, res,
        jnp.asarray(s0, jnp.int32),
    )
    cost, theta = np.asarray(cost), np.asarray(theta)

    cw = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)
    costs_all, _ = score_all_rotations(
        g.dist, stencil, scan, cw, p.pose_px(), p.scale, res,
        num_classes=g.num_classes, map_resolution=1.0,
        chunk_size=p.scale.shape[0],
    )
    map_size = jnp.asarray(
        [g.width * 1.0, g.height * 1.0], jnp.float32
    )
    w_ref, theta_ref, _ = compute_weights(
        costs_all, p, pf.params, map_size, 100
    )
    w_fast = 1.0 / (cost + pf.params.regularization)
    alive = np.asarray(p.alive)
    ok = (
        alive
        & np.isfinite(cost)
        & np.isfinite(np.asarray(w_ref))
    )
    assert ok.sum() > 0.9 * alive.sum()
    np.testing.assert_allclose(
        w_fast[ok], np.asarray(w_ref)[ok], rtol=5e-3, atol=1e-5
    )
    # init-flavor particles adopted a searched theta, tracked kept
    have = np.asarray(p.have_init)
    np.testing.assert_allclose(
        theta[ok & have], np.asarray(p.theta)[ok & have], atol=1e-6
    )
    # the searched theta may flip between near-tied rotations (conv vs
    # exact rounding); require the chosen rotation's EXACT cost to be
    # within tolerance of the exact best
    from top_down_renderer_tpu.filter.scoring import search_shifts

    ssh = np.asarray(search_shifts(100, 40))
    ce = np.asarray(costs_all)[:, ssh]
    ce = np.where(np.isnan(ce), np.float32(np.finfo(np.float32).max), ce)
    sel = ok & ~have
    k_fast = np.round(theta[sel] / (2 * np.pi / 40)).astype(int) % 40
    chosen = ce[sel, k_fast]
    best = ce[sel].min(axis=1)
    np.testing.assert_allclose(chosen, best, rtol=5e-3, atol=1e-4)


def test_mixed_update_end_to_end():
    """A full mixed update() runs the fast path on CPU (conv is pure
    XLA) and restores all-have-init after the step."""
    pf = _pf()
    g = pf.map.grid
    rng = np.random.default_rng(12)
    scan = rng.random((g.num_classes, 100, 25)).astype(np.float32) * 3
    pf.update(scan, 0.5)  # init-mode first update
    assert pf._all_have_init
    pf.reinitialize_fraction(0.3, seed=9)
    fast = pf._fast_mode(0.5)
    assert fast is not None and fast[0] == "mixed"
    pf.update(scan, 0.5)
    assert pf._all_have_init
    w = np.asarray(pf.state.particles.weight)
    assert np.isfinite(w).all() and w.sum() > 0


def test_mixed_multi_update_interpret():
    """Unknown-scale mixed population runs the K-bucket multi path."""
    pf = _pf(fixed_scale=-1.0, n=240)
    _mixed(pf)
    fast = pf._fast_mode(0.5)
    assert fast is not None and fast[3] == "multi"
    assert fast[0] == "mixed"
    g = pf.map.grid
    rng = np.random.default_rng(13)
    scan = rng.random((g.num_classes, 100, 25)).astype(np.float32) * 3
    pf.update(scan, 0.5)
    assert pf._all_have_init
    w = np.asarray(pf.state.particles.weight)
    assert np.isfinite(w).all() and w.sum() > 0
