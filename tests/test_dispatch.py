"""Host-side dispatch logic: shift-window derivation and fast-mode
selection (pure host code)."""

import numpy as np
import jax.numpy as jnp

from top_down_renderer_tpu.config import FilterParams, MapParams
from top_down_renderer_tpu.filter.filter import ParticleFilter
from top_down_renderer_tpu.maps.map import TopDownMap, build_grid
from util_synthetic import make_world


def _pf(fixed_scale=2.0, n=256):
    maps = make_world()
    tdm = TopDownMap(MapParams(map_path="", num_classes=3, resolution=1.0))
    tdm.grid = build_grid(maps, 1.0, 50.0)
    tdm.class_maps_binary = maps
    tdm.have_map = True
    tdm.sample_pts_polar(100, 25)
    pf = ParticleFilter(
        n, tdm,
        FilterParams(fixed_scale=fixed_scale, class_weights=[1, 1, 1]),
        chunk_size=n, use_fast=True,
    )
    return pf


def _set_smask(pf, shifts):
    sm = np.zeros(pf.theta_bins, bool)
    sm[shifts] = True
    pf.state = pf.state.replace(smask=jnp.asarray(sm))


def test_shift_window_narrow_band():
    pf = _pf()
    _set_smask(pf, [10, 11, 12, 13])
    s0, ww = pf._shift_window()
    assert ww == 16
    # window covers [10, 13] with margin
    covered = [(s0 + j) % 100 for j in range(ww)]
    for s in (10, 11, 12, 13):
        assert s in covered


def test_shift_window_wraparound():
    pf = _pf()
    _set_smask(pf, [97, 98, 99, 0, 1, 2])
    s0, ww = pf._shift_window()
    assert ww == 16
    covered = [(s0 + j) % 100 for j in range(ww)]
    for s in (97, 98, 99, 0, 1, 2):
        assert s in covered


def test_shift_window_turn_margin():
    pf = _pf()
    _set_smask(pf, [50])
    pf._last_omega = 1.0  # big turn -> ~16-bin margin each side
    s0, ww = pf._shift_window()
    assert ww >= 64
    covered = [(s0 + j) % 100 for j in range(ww)]
    for s in range(50 - 16, 50 + 17):
        assert s % 100 in covered


def test_shift_window_spread_full():
    pf = _pf()
    _set_smask(pf, list(range(0, 100, 3)))
    s0, ww = pf._shift_window()
    assert ww == 100


def test_fast_mode_selection():
    pf = _pf(fixed_scale=2.0)
    # scale 2, res 0.5 -> f=1 -> mo 24; clustered road init -> conv
    out = pf._fast_mode(0.5)
    assert out is not None
    mode, mo, scale, path, region, s0, ww, mip = out
    assert mode in ("tracked", "init")
    assert scale == 2.0
    assert mip == 1
    # unfrozen scale -> multi-bucket path (the 10 discrete init
    # hypotheses cluster into slots; K padded to 12)
    pf2 = _pf(fixed_scale=-1.0)
    out2 = pf2._fast_mode(0.5)
    assert out2 is not None and out2[3] == "multi"
    _, _, _, _, slots, levels, bmi, kp = out2
    assert kp == 12 and len(slots) == 12
    assert len(bmi) == 12 and max(bmi) < len(levels)


def test_fast_mode_mip_fallback():
    """scale*res beyond every crop/conv bucket -> mip-crop dispatch with
    the smallest power-of-2 level whose f/mip fits a bucket."""
    from top_down_renderer_tpu.filter import conv_score as cs
    from top_down_renderer_tpu.filter import crop_score as crop

    pf = _pf(fixed_scale=2.0)
    # f = 2*2 = 4 -> mip 4 brings f_eff to 1.0 (mo 24)
    out = pf._fast_mode(2.0)
    assert out is not None
    mode, mo, scale, path, region, s0, ww, mip = out
    assert path == "crop" and mip == 4 and mo == 24
    assert cs.pick_crop_size(scale * 2.0 / mip, 25, crop.MO_BUCKETS) == mo
    # f = 20 -> mip 32 (f_eff 0.625)
    out = pf._fast_mode(10.0)
    assert out is not None
    _, mo, _, path, _, _, _, mip = out
    assert path == "crop" and mip == 32 and mo == 24
    # mip maps are cached per (version, level)
    pm4 = pf._get_padded_maps(4)
    assert pf._get_padded_maps(4) is pm4
    g = pf.map.grid.dist
    assert pm4.hp == (g.shape[0] + 3) // 4 + 2 * cs.MAP_PAD
    pf._map_version += 1
    pf._maps_cache.clear()
    assert pf._get_padded_maps(4) is not pm4


def test_conv_region_must_fit_padded_map():
    """A clustered cloud on a SMALL map must not select a conv region
    whose (region + kernel - 1) block exceeds the padded map (the conv
    scorer's dynamic_slice would be unsatisfiable); it falls back to the
    crop path or exact."""
    from top_down_renderer_tpu.filter import conv_score as cs

    pf = _pf()  # world is 200x200 -> padded ~328
    pm = pf._get_padded_maps()
    out = pf._fast_mode(0.5)
    assert out is not None
    _mode, mo, _scale, path, region, _s0, _ww, _mip = out
    if path == "conv":
        dr, dc = cs.conv_dims(mo)
        assert region + dr - 1 <= pm.hp
        assert region + dc - 1 <= pm.wp


def test_warmup_skips_oversized_regions():
    """warmup() on a small map must not trace conv variants that cannot
    fit (they would raise at trace time)."""
    pf = _pf()
    pf.use_fast = True
    # regions far beyond the padded map: should be filtered, not crash
    pf.warmup(0.5, regions=(1024, 2048), windows=(16,), modes=("tracked",))


def test_propagate_defers_and_composes():
    """propagate() is deferred in every mode: queries between
    propagate() and update() see the pre-propagate particles, and
    successive calls compose (rotate the second body-frame translation
    by the first omega)."""
    pf = _pf()
    before = np.asarray(pf.state.particles.d_m).copy()
    pf.propagate(np.array([1.0, 0.0], np.float32), np.pi / 2)
    np.testing.assert_array_equal(
        np.asarray(pf.state.particles.d_m), before
    )
    pf.propagate(np.array([2.0, 0.0], np.float32), 0.0)
    trans, omega, dist = pf._pending_motion
    # t1 + R(pi/2) t2 = (1, 0) + (0, 2)
    np.testing.assert_allclose(trans, [1.0, 2.0], atol=1e-6)
    assert abs(omega - np.pi / 2) < 1e-6
    assert abs(dist - 3.0) < 1e-6
    # host application consumes the pending motion
    pf._apply_pending_motion()
    assert pf._pending_motion is None
    moved = np.asarray(pf.state.particles.d_m)
    assert not np.allclose(moved, before)


def test_pose_stats_matches_separate_calls():
    """The fused per-publish pair equals the individual jitted stats."""
    pf = _pf()
    ml, cov = pf.pose_stats()
    np.testing.assert_allclose(ml, pf.mean_likelihood(), rtol=1e-6)
    np.testing.assert_allclose(
        cov, pf.compute_mean_cov(), rtol=1e-5, atol=1e-6
    )


def test_scale_host_mirrors():
    """scale()/is_scale_frozen never touch the device once mirrored."""
    pf = _pf(fixed_scale=-1.0)
    assert not pf.is_scale_frozen and pf.scale() == -1.0
    pf.freeze_scale()
    assert pf.is_scale_frozen
    geo = float(
        np.exp(np.log(np.asarray(pf.state.particles.scale)[
            np.asarray(pf.state.particles.alive)]).mean())
    )
    assert abs(pf.scale() - geo) / geo < 1e-5


def test_multi_saturating_gate_dead_slot_clamps():
    """A scale outlier past the weight gate (scale > 10^scale_log_max)
    whose bucket saturates even the coarsest mip must NOT drop the step to the
    exact gather: its weight is zeroed by weight_from_cost regardless
    of cost, so the slot is clamped onto the coarsest level."""
    import jax.numpy as jnp

    pf = _pf(fixed_scale=-1.0)
    p = pf.state.particles
    scales = np.full(p.scale.shape, 2.0, np.float32)
    scales[:8] = 100.0  # past gate_hi = 10^1, saturates mip-128 at res 1
    pf.state = pf.state.replace(
        particles=p.replace(scale=jnp.asarray(scales))
    )
    out = pf._multi_mode(1.0)
    assert out is not None and out[3] == "multi", pf._slow_reason
    slots = out[4]
    # the saturating slot was clamped to a representable scale
    assert np.max(slots) < 100.0

    # negative control: a saturating slot INSIDE the gate still falls
    # back (scoring it clamped would corrupt live weights)
    scales2 = np.full(p.scale.shape, 1.0, np.float32)
    scales2[:8] = 8.0  # inside the gate; saturates at res 16
    pf.state = pf.state.replace(
        particles=p.replace(scale=jnp.asarray(scales2))
    )
    out2 = pf._multi_mode(16.0)
    assert out2 is None
    assert "saturates" in (pf._slow_reason or "")
