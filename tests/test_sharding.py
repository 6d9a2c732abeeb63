"""Multi-chip sharded step on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest


def test_dryrun_multichip_8():
    """Runs the driver's dryrun in a FRESH process, exactly as the
    driver invokes it.  In-process it aborts flakily at the perf-shaped
    step when ~90 suite tests' worth of XLA-CPU state has accumulated
    (SIGABRT inside block_until_ready; passes standalone and in any
    smaller batch) - subprocess isolation both mirrors the real
    invocation and keeps the suite robust to that pressure."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__ as ge; ge.dryrun_multichip(8)",
        ],
        cwd=root,
        env=env,
        capture_output=True,
        text=True,
        timeout=1500,
    )
    assert p.returncode == 0, p.stdout + p.stderr
    assert "perf-shaped sharded conv step OK" in p.stdout, p.stdout


def test_sharded_matches_single_chip_weights():
    """The sharded step's weight post-processing must match the
    single-chip math (same psum'd statistics)."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 virtual devices")
    import __graft_entry__ as ge
    from top_down_renderer_tpu.parallel.sharding import (
        make_mesh,
        make_sharded_step,
        shard_filter_state,
    )

    n = 128 * 4
    (state, packed, map_size, stencil, scan, res, params) = (
        ge._synthetic_setup(n, h=64, w=64, seed=3)
    )
    mesh = make_mesh(4)
    sh_state = shard_filter_state(state, mesh)
    step = make_sharded_step(
        mesh, params, num_classes=3, map_resolution=1.0,
        theta_bins=100, n_max=n, chunk_size=128,
    )
    motion = jnp.zeros(5, jnp.float32)  # tx ty omega dist gate
    out = step(sh_state, packed, map_size, stencil, scan, res, motion)
    # invariants: weights normalized over alive, alive prefix-contiguous
    w = np.asarray(out.particles.weight)
    alive = np.asarray(out.particles.alive)
    assert abs(w.sum() - 1.0) < 1e-4
    n_active = int(out.n_active)
    assert np.all(alive[:n_active]) and not np.any(alive[n_active:])
    # all resampled positions must come from the original particle set
    src = np.asarray(state.particles.init_px)
    dst = np.asarray(out.particles.init_px)[alive]
    assert np.isin(
        dst.round(4).view([("x", "f4"), ("y", "f4")]),
        src.round(4).view([("x", "f4"), ("y", "f4")]),
    ).all()


def _mini_world_pf(mesh=None, n=64, seed=0, use_fast=True,
                   pos_cov=0.0, theta_cov=0.0):
    from top_down_renderer_tpu.config import FilterParams, MapParams
    from top_down_renderer_tpu.filter.filter import ParticleFilter
    from top_down_renderer_tpu.maps.map import TopDownMap, build_grid

    c = 3
    maps_bin = np.ones((c, 96, 96), np.float32)
    maps_bin[1, 44:52, :] = 0.0
    maps_bin[2, 30:38, 60:68] = 0.0
    tdm = TopDownMap(
        __import__("top_down_renderer_tpu.config", fromlist=["MapParams"])
        .MapParams(map_path="", num_classes=c, resolution=1.0)
    )
    tdm.grid = build_grid(maps_bin, 1.0, 50.0)
    tdm.class_maps_binary = maps_bin
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    params = FilterParams(
        fixed_scale=1.0, class_weights=[0.5] + [1.5] * (c - 1),
        force_on_map=True, init_pos_px_x=40.0, init_pos_px_y=48.0,
        init_pos_px_cov=6.0, init_pos_deg_theta=0.0, init_pos_deg_cov=5.0,
        pos_cov=pos_cov, theta_cov=theta_cov,
    )
    return ParticleFilter(
        n, tdm, params, seed=seed, chunk_size=n, mesh=mesh,
        use_fast=use_fast,
    )


def test_particle_filter_mesh_conv_fast_path():
    """The public ParticleFilter(mesh=...) API must dispatch the
    row-sharded conv cost field and keep the filter invariants."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(2)
    pf = _mini_world_pf(mesh=mesh, pos_cov=0.05, theta_cov=0.01)
    rng = np.random.default_rng(1)
    scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for _ in range(3):
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf.update(scan, 1.0)
    assert len(pf._sharded_fns) >= 1, "conv fast path never dispatched"
    w = np.asarray(pf.state.particles.weight)
    alive = np.asarray(pf.state.particles.alive)
    assert abs(w.sum() - 1.0) < 1e-4
    n_active = int(pf.state.n_active)
    assert np.all(alive[:n_active]) and not np.any(alive[n_active:])
    assert pf.mean_likelihood().shape == (4,)


def test_mesh_fast_step_matches_single_chip_ml_state():
    """With zero motion noise the sharded conv fast step and the
    single-chip conv fast step score identical particle sets; the
    pre-resample max-weight state (ml_state) must agree."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    pf_s = _mini_world_pf(mesh=None, seed=7)
    mesh = make_mesh(2)
    pf_m = _mini_world_pf(mesh=mesh, seed=7)
    rng = np.random.default_rng(2)
    scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for pf in (pf_s, pf_m):
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf.update(scan, 1.0)
    assert len(pf_m._sharded_fns) == 1
    np.testing.assert_allclose(
        pf_s.max_likelihood(), pf_m.max_likelihood(), rtol=1e-4,
        atol=1e-5,
    )


def test_mesh_direct_conv_fast_path(monkeypatch):
    """Above the folded-kernel byte gate the mesh dispatch must take the
    row-sharded DIRECT conv field (use_s2d=False), not fall to the exact
    gather - and must match the single-chip direct-conv step bit-for-bit
    on the pre-resample max-weight state (zero motion noise)."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.filter import conv_score as cs
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    monkeypatch.setattr(cs, "K4_MAX_BYTES", 0)  # force the direct path
    pf_s = _mini_world_pf(mesh=None, seed=7)
    pf_m = _mini_world_pf(mesh=make_mesh(2), seed=7)
    rng = np.random.default_rng(3)
    scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for pf in (pf_s, pf_m):
        pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
        pf.update(scan, 1.0)
    assert len(pf_m._sharded_fns) == 1, "direct fast path not dispatched"
    key = next(iter(pf_m._sharded_fns))
    assert key[4] is False, f"expected use_s2d=False key, got {key}"
    np.testing.assert_allclose(
        pf_s.max_likelihood(), pf_m.max_likelihood(), rtol=1e-4,
        atol=1e-5,
    )


def test_mesh_propagate_composes_multiple_calls():
    """Two propagate() calls between updates must compose in mesh mode
    (rotate the second body-frame translation by the first omega), not
    overwrite - with zero noise the deferred fused motion must land the
    particles exactly where per-call single-chip application does."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    pf_s = _mini_world_pf(mesh=None, seed=7)
    pf_m = _mini_world_pf(mesh=make_mesh(2), seed=7)
    rng = np.random.default_rng(4)
    scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for pf in (pf_s, pf_m):
        pf.propagate(np.array([1.0, 0.0], np.float32), np.pi / 2)
        pf.propagate(np.array([2.0, 0.0], np.float32), 0.0)
        pf.update(scan, 1.0)
    np.testing.assert_allclose(
        pf_s.max_likelihood(), pf_m.max_likelihood(), rtol=1e-4,
        atol=1e-5,
    )


def test_mesh_update_without_propagate_keeps_scale():
    """An update() with no pending propagate must not diffuse unfrozen
    scales (single-chip skips propagate entirely; the fused mesh step
    gates the dist->0 sigma floor to zero)."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    import __graft_entry__ as ge
    from top_down_renderer_tpu.parallel.sharding import (
        make_mesh,
        make_sharded_step,
        shard_filter_state,
    )

    n = 128 * 2
    (state, packed, map_size, stencil, scan, res, params) = (
        ge._synthetic_setup(n, h=64, w=64, seed=5)
    )
    state = state.replace(scale_frozen=jnp.asarray(False))
    mesh = make_mesh(2)
    sh_state = shard_filter_state(state, mesh)
    step = make_sharded_step(
        mesh, params, num_classes=3, map_resolution=1.0,
        theta_bins=100, n_max=n, chunk_size=128,
    )
    motion = jnp.zeros(5, jnp.float32)  # no pending propagate: gate=0
    out = step(sh_state, packed, map_size, stencil, scan, res, motion)
    # resampled scales must all come from the (pre-update) scale set,
    # which was uniform 2.0 - any diffusion would have perturbed them
    alive = np.asarray(out.particles.alive)
    np.testing.assert_allclose(
        np.asarray(out.particles.scale)[alive], 2.0, rtol=0, atol=0
    )


def test_node_mesh_devices_plumbing():
    """RuntimeParams.mesh_devices builds the filter on a mesh through
    the node constructor."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.config import (
        ClassConfig, MapConfig, RuntimeParams,
    )
    from top_down_renderer_tpu.runtime.node import TopDownRenderNode

    color_lut = np.full((256, 3), 255, np.uint8)
    color_lut[0], color_lut[1] = (0, 100, 0), (255, 0, 0)
    cc = ClassConfig(
        color_lut=color_lut,
        class_to_flattened=[0, 1],
        flattened_to_class=[0, 1],
        exclusivity=[True, True],
        loc_weight=[0.5, 1.5],
    )
    import tempfile, os
    from PIL import Image

    maps = np.ones((2, 64, 64), np.float32)
    maps[1, 28:36, :] = 0.0
    maps[0] = 1.0 - (1.0 - maps[1])
    img = np.zeros((64, 64, 3), np.uint8)
    img[...] = (0, 100, 0)
    img[maps[1, ::-1] == 0] = (255, 0, 0)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "w.png")
        Image.fromarray(img).save(p)
        mc = MapConfig(raster_path=p, resolution=1.0)
        rt = RuntimeParams(particle_count=32, mesh_devices=2,
                           theta_bins=100, range_bins=25)
        node = TopDownRenderNode(cc, mc, rt)
    assert node.filter.mesh is not None
    pts = np.zeros((256, 4), np.float32)
    pts[:64, 0] = np.linspace(1, 8, 64)
    pts[:64, 3] = 1
    node.pc_callback(0.0, pts)
    assert node.filter.state.step is not None
    assert int(node.filter.state.step) == 1


def _mini_world_pf_unknown_scale(mesh=None, n=128, seed=0):
    """Unknown-scale mini world: fixed_scale<0 initializes the 10
    discrete log-spaced scale hypotheses (particle_filter.cpp:19-25),
    which _fast_mode routes to the multi-bucket crop path."""
    from top_down_renderer_tpu.config import FilterParams, MapParams
    from top_down_renderer_tpu.filter.filter import ParticleFilter
    from top_down_renderer_tpu.maps.map import TopDownMap, build_grid

    c = 3
    maps_bin = np.ones((c, 96, 96), np.float32)
    maps_bin[1, 44:52, :] = 0.0
    maps_bin[2, 30:38, 60:68] = 0.0
    tdm = TopDownMap(MapParams(map_path="", num_classes=c,
                               resolution=1.0))
    tdm.grid = build_grid(maps_bin, 1.0, 50.0)
    tdm.class_maps_binary = maps_bin
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    params = FilterParams(
        fixed_scale=-1.0, class_weights=[0.5] + [1.5] * (c - 1),
        force_on_map=True, init_pos_px_x=48.0, init_pos_px_y=48.0,
        init_pos_px_cov=6.0,
        init_pos_deg_theta=float("inf"),  # no theta prior: init flavor
        pos_cov=0.0, theta_cov=0.0,
    )
    return ParticleFilter(
        n, tdm, params, seed=seed, chunk_size=n, mesh=mesh,
        use_fast=True,
    )


def test_mesh_multi_path_matches_single_chip():
    """The unknown-scale regime must run the K-bucket crop path ON THE
    MESH (crop scorer over each device's local particle shard,
    sharding.make_sharded_step_multi) - not fall to the sharded exact
    gather - and must match the single-device multi step on the
    pre-resample max-weight state (identical particle sets: zero motion
    pending, same seed)."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 virtual devices")
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    pf_s = _mini_world_pf_unknown_scale(mesh=None, seed=11)
    pf_m = _mini_world_pf_unknown_scale(mesh=make_mesh(2), seed=11)
    rng = np.random.default_rng(5)
    scan = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for pf in (pf_s, pf_m):
        pf.update(scan, 1.0)
    multi_keys = [k for k in pf_m._sharded_fns if k[0] == "multi"]
    assert multi_keys, "mesh multi path never dispatched"
    assert multi_keys[0][1] == "init"
    np.testing.assert_allclose(
        pf_s.max_likelihood(), pf_m.max_likelihood(), rtol=1e-4,
        atol=1e-5,
    )
    # second update: all particles now have init -> tracked flavor,
    # still on the mesh multi path (scale not yet frozen)
    scan2 = jnp.asarray(rng.random((3, 100, 25)).astype(np.float32))
    for pf in (pf_s, pf_m):
        pf.update(scan2, 1.0)
    modes = {k[1] for k in pf_m._sharded_fns if k[0] == "multi"}
    assert "tracked" in modes, "tracked multi flavor never dispatched"
    np.testing.assert_allclose(
        pf_s.max_likelihood(), pf_m.max_likelihood(), rtol=1e-4,
        atol=1e-5,
    )
