"""Scoring-regime benchmark: particle-filter steps/s on one GPU.

Times full filter steps (propagate + score + weights + resample + GMM
cadence) at 102,400 particles on a 1024^2 6-class synthetic map with a
100 x 25 polar scan, in one scoring regime chosen by BENCH_* variables:

  BENCH_N, BENCH_STEPS, BENCH_MAP   particles, timed steps, map side
  BENCH_EXTENT   cloud extent in px (0 = spread over the whole map)
  BENCH_THETA_SPREAD  heading half-width (0 = uniform headings)
  BENCH_SCALE, BENCH_RES   scale (px/m) and range resolution (m/bin)
  BENCH_MODE     tracked | init
  BENCH_MULTI=1  unknown scale: the 10 discrete scale hypotheses
  BENCH_EXACT=1  score with the exact gather instead of the fast path
  BENCH_AB=1     time the fast path and the exact gather in one
                 process, in the order fast, exact, exact, fast

Prints one JSON line per timed run, each naming the device.  Refuses to
run on a backend other than the GPU unless BENCH_CPU=1 (a CPU number is
not a device measurement).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def _env(name, default):
    return type(default)(os.environ.get(name, default))


def build_cell(exact: bool):
    """(step(state) -> state, initial state, label) for the regime the
    BENCH_* variables select."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from top_down_renderer_tpu.config import FilterParams
    from top_down_renderer_tpu.filter import conv_score as cs
    from top_down_renderer_tpu.filter import crop_score as crop
    from top_down_renderer_tpu.filter import multiscale as ms
    from top_down_renderer_tpu.filter.filter import (
        make_update_step,
        make_update_step_fast,
        make_update_step_multiscale,
    )
    from top_down_renderer_tpu.filter.particles import propagate

    n = _env("BENCH_N", 102400)
    hw = _env("BENCH_MAP", 1024)
    chunk = _env("BENCH_CHUNK", 4096)
    # converged-regime operating point: fixed scale 2 px/m, range res
    # 0.5 m/bin (range_scale_min) -> f = 1.0
    scale = _env("BENCH_SCALE", 2.0)
    res_v = _env("BENCH_RES", 0.5)
    mode = os.environ.get("BENCH_MODE", "tracked")
    multi = os.environ.get("BENCH_MULTI", "0") == "1"
    c = 6
    theta_bins, range_bins = 100, 25
    # converged-tracking cloud: clustered in a ~100 px region (the
    # adaptive particle count + resampling concentrate the cloud after
    # convergence)
    extent = _env("BENCH_EXTENT", 100)
    theta_spread = _env("BENCH_THETA_SPREAD", 0.15)
    (state, packed, map_size, stencil, scan, _res, _params) = (
        ge._synthetic_setup(
            n, h=hw, w=hw, c=c, theta_bins=theta_bins,
            range_bins=range_bins,
            cluster=(hw // 2, hw // 2, extent) if extent > 0 else None,
            theta_spread=(0.7, theta_spread)
            if theta_spread > 0 else None,
        )
    )
    res = jnp.asarray(res_v, jnp.float32)
    p = state.particles
    if multi:
        # the reference's 10 discrete scale hypotheses
        # (particle_filter.cpp:19-25)
        hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
        p = p.replace(scale=jnp.asarray(hyp[np.arange(n) % 10]))
        state = state.replace(scale_frozen=jnp.asarray(False))
        params = FilterParams(
            fixed_scale=-1.0, class_weights=[1.0] * c, force_on_map=True
        )
    else:
        p = p.replace(scale=jnp.full((n,), scale, jnp.float32))
        params = FilterParams(
            fixed_scale=scale, class_weights=[1.0] * c,
            force_on_map=True,
        )
    state = state.replace(
        particles=p.replace(
            have_init=jnp.full((n,), mode == "tracked", dtype=bool)
        )
    )
    prop = jax.jit(
        lambda st, sub: propagate(
            st.particles, sub, jnp.asarray([1.0, 0.0], jnp.float32),
            jnp.asarray(0.01, jnp.float32), params, st.scale_frozen,
        )
    )

    def with_propagate(update):
        def step(st):
            key, sub = jax.random.split(st.key)
            st = st.replace(particles=prop(st, sub), key=key)
            return update(st)

        return step

    if exact:
        upd = make_update_step(
            params, grid_num_classes=c, map_resolution=1.0,
            theta_bins=theta_bins, n_max=n, gmm_every=10,
            chunk_size=chunk,
        )
        step = with_propagate(
            lambda st: upd(st, packed, map_size, stencil, scan, res)
        )
        return step, state, "exact"
    if multi:
        mo = ms.multi_mo()
        fmax = mo / (range_bins - 1)
        mips = tuple(ms.mip_for_f(float(s) * res_v, fmax) for s in hyp)
        levels = tuple(sorted(set(mips)))
        bmi = tuple(levels.index(m) for m in mips)
        upd = make_update_step_multiscale(
            params, grid_num_classes=c, map_resolution=1.0,
            theta_bins=theta_bins, n_max=n, mode=mode,
            bucket_mip_idx=bmi, mo=mo, gmm_every=10,
        )
        pyr = ms.build_pyramid_maps(packed, levels)
        slots = jnp.asarray(hyp)
        step = with_propagate(
            lambda st: upd(st, pyr, map_size, stencil, scan, res, slots)
        )
        return step, state, f"multi-{mode}-k10-mo{mo}-mips{levels}"
    mip = 1
    mo = cs.pick_crop_size(scale * res_v, range_bins, crop.MO_BUCKETS)
    if mo is None:
        # exploration regime: mip-crop (filter.py dispatch)
        for mip in (2, 4, 8, 16, 32):
            mo = cs.pick_crop_size(
                scale * res_v / mip, range_bins, crop.MO_BUCKETS
            )
            if mo is not None:
                break
    region = (
        cs.pick_region(extent + 16) if extent > 0 and mip == 1 else None
    )
    path = "conv" if region else "crop"
    s0, ww = 0, theta_bins
    if path == "conv":
        mo = cs.pick_crop_size(
            scale * res_v, range_bins, cs.MO_BUCKETS_CONV
        )
        if theta_spread > 0 and mode == "tracked":
            # shift window: the theta band + noise/turn margin (the
            # runtime dispatch derives this from FilterState.smask)
            span = int(np.ceil(theta_spread * theta_bins / np.pi)) + 1
            need = span + 1 + 2 * 4
            ww = next(
                (w_ for w_ in (16, 32, 64) if need <= w_), theta_bins
            )
            s0 = int(
                round((0.7 - theta_spread) * theta_bins / (2 * np.pi))
                - 4
            ) % theta_bins
    upd = make_update_step_fast(
        params, grid_num_classes=c, map_resolution=1.0,
        theta_bins=theta_bins, n_max=n, mode=mode, mo=mo,
        gmm_every=10, path=path, region=region or 0, window_w=ww,
        mip=mip,
    )
    maps = cs.build_padded_maps(packed[::mip, ::mip])
    motion = jnp.asarray([1.0, 0.0, 0.01, 1.0, 1.0], jnp.float32)

    def step(st):
        # the fused fast step folds propagate into the same dispatch
        return upd(
            st, maps, map_size, stencil, scan, res, s0=s0, motion=motion
        )

    label = f"{path}-mo{mo}" + (f"-mip{mip}" if mip > 1 else "")
    return step, state, label


def time_steps(step, state0, steps):
    """(seconds per step, final state): two warm-up steps, then `steps`
    steps fenced by block_until_ready."""
    import jax
    import jax.numpy as jnp

    st = jax.tree.map(jnp.copy, state0)  # fast steps donate the state
    for _ in range(2):
        st = step(st)
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    for _ in range(steps):
        st = step(st)
    jax.block_until_ready(st)
    return (time.perf_counter() - t0) / steps, st


def main():
    import jax

    from top_down_renderer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    if os.environ.get("BENCH_CPU", "0") == "1":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(
            f"bench.py: backend is {jax.default_backend()!r}, not the "
            "GPU; set BENCH_CPU=1 to run on the CPU anyway"
        )
    enable_compile_cache()
    steps = _env("BENCH_STEPS", 50)
    n = _env("BENCH_N", 102400)
    if os.environ.get("BENCH_AB", "0") == "1":
        order = (False, True, True, False)
    else:
        order = (os.environ.get("BENCH_EXACT", "0") == "1",)
    cells = {}
    dev = jax.devices()[0]
    for exact in order:
        if exact not in cells:
            t0 = time.perf_counter()
            step, state0, label = build_cell(exact)
            cells[exact] = (step, state0, label, time.perf_counter() - t0)
        step, state0, label, setup_s = cells[exact]
        dt, st = time_steps(step, state0, steps)
        w = np.asarray(st.particles.weight)
        print(
            json.dumps(
                {
                    "metric": f"pf_steps_per_s_at_{n}_particles",
                    "value": 1.0 / dt,
                    "unit": "steps/s",
                    "step_ms": 1000.0 * dt,
                    "path": label,
                    "finite": bool(np.isfinite(w).all()),
                    "setup_s": setup_s,
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                    },
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
