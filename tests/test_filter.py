"""Particle-filter unit tests + the minimum end-to-end slice
(synthetic map -> polar render -> propagate/score/resample -> convergence,
mirroring BASELINE.json config 1)."""

import math

import numpy as np
import jax
import jax.numpy as jnp

from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import Particles
from top_down_renderer_tpu.filter import particles as particles_mod
from top_down_renderer_tpu.filter.filter import ParticleFilter
from top_down_renderer_tpu.filter.resample import systematic_resample
from top_down_renderer_tpu.filter import stats as stats_mod
from top_down_renderer_tpu.maps.map import TopDownMap, build_grid
from top_down_renderer_tpu.config import MapParams
from top_down_renderer_tpu.render.semantic import render_semantic_polar

from util_synthetic import generate_scan_points, make_world, rot2d


def _mk_particles(n, rng):
    return Particles(
        init_px=jnp.asarray(rng.random((n, 2)), jnp.float32) * 100,
        d_m=jnp.zeros((n, 2), jnp.float32),
        theta=jnp.asarray(rng.random(n), jnp.float32),
        scale=jnp.ones(n, jnp.float32) * 2,
        have_init=jnp.ones(n, bool),
        weight=jnp.ones(n, jnp.float32) / n,
        last_dist=jnp.zeros(n, jnp.float32),
        alive=jnp.ones(n, bool),
    )


def test_propagate_statistics():
    """Motion noise magnitudes match the model (state_particle.cpp:57-78)."""
    rng = np.random.default_rng(0)
    n = 20000
    p = _mk_particles(n, rng)
    p = p.replace(theta=jnp.zeros(n, jnp.float32))
    params = FilterParams(pos_cov=0.3, theta_cov=0.05)
    trans = jnp.asarray([2.0, 0.0])
    out = particles_mod.propagate(
        p, jax.random.PRNGKey(1), trans, jnp.asarray(0.1), params,
        jnp.asarray(False),
    )
    d = np.asarray(out.d_m)
    th = np.asarray(out.theta)
    dist = 2.0
    assert abs(d[:, 0].mean() - 2.0) < 0.02
    assert abs(d[:, 0].std() - params.pos_cov * dist) < 0.02
    assert abs(d[:, 1].mean() - 0.0) < 0.02
    assert abs(th.mean() - 0.1) < 0.005
    assert abs(th.std() - params.theta_cov * dist) < 0.005
    # scale noise sigma = min(2/dist, 0.02) = 0.02
    s = np.asarray(out.scale)
    assert abs(s.std() / 2.0 - 0.02) < 0.003
    # frozen scale -> no noise
    out2 = particles_mod.propagate(
        p, jax.random.PRNGKey(1), trans, jnp.asarray(0.0), params,
        jnp.asarray(True),
    )
    np.testing.assert_array_equal(np.asarray(out2.scale), np.asarray(p.scale))


def test_systematic_resample_proportional():
    """Resampled multiplicity proportional to weight
    (particle_filter.cpp:171-187)."""
    rng = np.random.default_rng(1)
    n = 1000
    p = _mk_particles(n, rng)
    w = np.zeros(n, np.float32)
    w[10] = 0.5
    w[500] = 0.3
    w[900] = 0.2
    out = systematic_resample(
        p, jnp.asarray(w), jnp.asarray(n), jnp.asarray(n),
        jax.random.PRNGKey(2),
    )
    src_theta = np.asarray(p.theta)
    out_theta = np.asarray(out.theta)
    counts = {
        i: int(np.sum(np.isclose(out_theta, src_theta[i])))
        for i in (10, 500, 900)
    }
    assert abs(counts[10] - 500) <= 1
    assert abs(counts[500] - 300) <= 1
    assert abs(counts[900] - 200) <= 1
    assert sum(counts.values()) == n


def test_resample_scatter_matches_gather():
    """The scatter+forward-fill formulation (resample.py:
    _segment_rows_scatter)
    must select byte-identical rows to the j-gather path across weight
    shapes: uniform, spiky, zero-prefix, partial n_active/n_new."""
    rng = np.random.default_rng(7)
    n = 512
    p = _mk_particles(n, rng)
    cases = []
    w = rng.random(n).astype(np.float32)
    cases.append((w / w.sum(), n, n))
    w = np.zeros(n, np.float32)
    w[3] = 0.9
    w[400] = 0.1
    cases.append((w, n, n))
    w = np.zeros(n, np.float32)
    w[100:200] = rng.random(100).astype(np.float32)
    w /= w.sum()
    cases.append((w, 300, 200))  # n_new < n, n_active < n
    w = np.zeros(n, np.float32)
    w[0] = 1.0
    cases.append((w, n, 1))
    for i, (w, n_new, n_act) in enumerate(cases):
        key = jax.random.PRNGKey(100 + i)
        a = systematic_resample(
            p, jnp.asarray(w), jnp.asarray(n_new), jnp.asarray(n_act),
            key, via_scatter=False,
        )
        b = systematic_resample(
            p, jnp.asarray(w), jnp.asarray(n_new), jnp.asarray(n_act),
            key, via_scatter=True,
        )
        for f in ("init_px", "d_m", "theta", "scale", "have_init",
                  "weight", "last_dist", "alive"):
            np.testing.assert_array_equal(
                np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                err_msg=f"case {i} field {f}",
            )


def test_resample_respects_n_new():
    rng = np.random.default_rng(2)
    n = 100
    p = _mk_particles(n, rng)
    w = np.ones(n, np.float32) / n
    out = systematic_resample(
        p, jnp.asarray(w), jnp.asarray(40), jnp.asarray(n),
        jax.random.PRNGKey(0),
    )
    assert int(np.asarray(out.alive).sum()) == 40
    np.testing.assert_allclose(
        np.asarray(out.weight)[:40], 1.0 / 40, rtol=1e-6
    )
    assert np.all(np.asarray(out.weight)[40:] == 0)


def test_circular_mean_cov():
    """Theta wrap in mean/cov (particle_filter.cpp:191-220)."""
    rng = np.random.default_rng(3)
    n = 512
    p = _mk_particles(n, rng)
    # angles clustered around pi (wrap boundary)
    th = np.pi + rng.standard_normal(n).astype(np.float32) * 0.1
    p = p.replace(theta=jnp.asarray(th))
    mean = np.asarray(stats_mod.mean_likelihood(p, jnp.asarray(n)))
    assert abs(abs(mean[2]) - np.pi) < 0.05
    cov = np.asarray(stats_mod.compute_mean_cov(p, jnp.asarray(n)))
    assert cov[2, 2] < 0.05  # wrapped variance, not ~pi^2


def _make_map(tmp_path=None):
    maps = make_world()
    grid = build_grid(maps, resolution=1.0, trunc_m=50.0)
    params = MapParams(map_path="", num_classes=3, resolution=1.0)
    tdm = TopDownMap(params)
    tdm.grid = grid
    tdm.class_maps_binary = maps
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    return tdm, maps


def test_end_to_end_convergence():
    """Minimum slice: synthetic world, unknown theta + position, fixed
    scale; the filter must localize within a few px after a short drive."""
    tdm, maps = _make_map()
    scale_gt = 2.0
    psi_gt = 0.7
    gt_pos = np.array([60.0, 105.0], np.float32)  # on the road strip

    params = FilterParams(
        pos_cov=0.1,
        theta_cov=math.pi / 100,
        regularization=0.02,
        fixed_scale=scale_gt,
        class_weights=[0.1, 1.5, 3.0],
        force_on_map=True,
    )
    pf = ParticleFilter(
        2048, tdm, params, seed=0, theta_bins=100, chunk_size=512
    )
    assert pf.num_particles() == 2048

    flut = np.arange(256, dtype=np.int32)
    res = 1.0  # m per range bin; 25 bins -> 50 m max range
    ang_res = 2 * np.pi / 100

    errs = []
    for step in range(15):
        pts = generate_scan_points(
            maps, gt_pos, psi_gt, scale_gt, max_range_m=25.0,
            n_pad=8192, seed=step,
        )
        scan = render_semantic_polar(
            jnp.asarray(pts), jnp.asarray(flut), res, ang_res, 3, 100, 25
        )
        trans = np.array([1.5, 0.0], np.float32)  # body-frame step (m)
        pf.propagate(trans, 0.0)
        pf.update(scan, res)
        gt_pos = gt_pos + (rot2d(psi_gt) @ trans) * scale_gt
        ml = pf.mean_likelihood()
        errs.append(np.linalg.norm(ml[:2] - gt_pos))

    ml = pf.mean_likelihood()
    pos_err_px = np.linalg.norm(ml[:2] - gt_pos)
    th_err = abs(np.arctan2(np.sin(ml[2] - psi_gt), np.cos(ml[2] - psi_gt)))
    assert pos_err_px < 8.0, (pos_err_px, errs)
    assert th_err < 0.3, (ml[2], psi_gt)
