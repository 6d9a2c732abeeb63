"""Multi-device scaling: the particle axis over a device mesh.

The reference's only parallel axis is thread-parallel particle scoring
(std::for_each(std::execution::par, ...), particle_filter.cpp:104-105,
TBB-backed per CMakeLists.txt:160).  The equivalent here: particles
are a sharded array axis over a 1-D device mesh ('data').  Per step:

  propagate / score            - embarrassingly parallel, zero comms
  conv cost field (fast path)  - field ROWS sharded: each device convs
                                 its slice of the region, one all_gather
                                 of the small f32 field (~2 MB), then
                                 per-particle reads are local
  weight statistics            - scalar psums over 'data'
  systematic resampling        - one all_gather of the compact SoA state
                                 (8 floats/particle; ~3 MB at 100k), then
                                 each shard fills its own slice
  GMM / adaptive count         - computed redundantly per shard from the
                                 gathered copy (deterministic, tiny)

Implemented with shard_map + explicit collectives so the comm pattern is
exactly what's written - no GSPMD guessing around the chunked gather.
Reached through the public API via ParticleFilter(mesh=...).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import (
    FilterState,
    GMMState,
    Particles,
)
from top_down_renderer_tpu.filter import gmm as gmm_mod
from top_down_renderer_tpu.filter.filter import (
    compute_weights,
    pose_bbox,
    select_init_cost,
    weight_from_cost,
)
from top_down_renderer_tpu.filter.particles import propagate
from top_down_renderer_tpu.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    shift_mask,
)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def _particle_spec(axis: str):
    return Particles(
        init_px=P(axis),
        d_m=P(axis),
        theta=P(axis),
        scale=P(axis),
        have_init=P(axis),
        weight=P(axis),
        last_dist=P(axis),
        alive=P(axis),
    )


def _state_spec(axis: str):
    return FilterState(
        particles=_particle_spec(axis),
        n_active=P(),
        scale_frozen=P(),
        frozen_scale=P(),
        ml_state=P(),
        gmm=GMMState(means=P(), covs=P(), k=P()),
        key=P(),
        step=P(),
        bbox=P(),
        smask=P(),
    )


def shard_filter_state(state: FilterState, mesh: Mesh, axis: str = "data"):
    """Place a FilterState on the mesh: particle arrays sharded, scalars
    and GMM replicated."""
    spec = _state_spec(axis)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, spec
    )


def _pad_class_weights(params: FilterParams, num_classes: int):
    cw = np.asarray(params.class_weights, dtype=np.float32)
    if cw.size < num_classes:
        cw = np.concatenate(
            [cw, np.ones(num_classes - cw.size, np.float32)]
        )
    return jnp.asarray(cw[:num_classes])


def _sharded_tail(
    state: FilterState,
    p: Particles,
    w_raw: jnp.ndarray,
    key: jnp.ndarray,
    k_rs: jnp.ndarray,
    k_gmm: jnp.ndarray,
    axis: str,
    n_max: int,
    n_local: int,
    k_max: int,
    gmm_every: int,
    theta_bins: int,
) -> FilterState:
    """Post-scoring pipeline with explicit collectives: psum'd weight
    statistics, one all_gather resample, redundant GMM, pmin/pmax bbox,
    psum smask.  Matches filter.update_tail semantics
    (particle_filter.cpp:107-187)."""
    my = jax.lax.axis_index(axis)
    psum = lambda x: jax.lax.psum(x, axis)
    isnan = jnp.isnan(w_raw)
    valid = p.alive & ~isnan
    total = psum(jnp.sum(jnp.where(valid, w_raw, 0.0)))
    num_valid = psum(jnp.sum(valid.astype(jnp.float32)))
    mean = total / jnp.maximum(num_valid, 1.0)
    under = valid & (w_raw < mean)
    num_under = psum(jnp.sum(under.astype(jnp.float32)))
    bot_var = psum(
        jnp.sum(jnp.where(under, (w_raw - mean) ** 2, 0.0))
    ) / jnp.maximum(num_under, 1.0)
    bottom = jnp.sqrt(bot_var)
    degenerate = (total == 0) | (num_under < 1)
    w = jnp.where(p.alive & isnan, mean - bottom, w_raw)
    w = jnp.where(degenerate, 1.0, w)
    w = jnp.where(p.alive, w, 0.0)
    w = w / psum(jnp.sum(w))
    d = jnp.minimum(p.last_dist * 5.0, 1.0)
    na = jnp.maximum(state.n_active.astype(jnp.float32), 1.0)
    w = jnp.where(p.alive, d * w + (1.0 - d) / na, 0.0)
    w = w / psum(jnp.sum(w))

    # --- gather global compact state for resampling + GMM: the 10
    #     per-particle fields ride ONE all_gather (40 B/particle) ---
    from top_down_renderer_tpu.filter.resample import (
        _systematic_indices,
        pack_fields,
        unpack_fields,
    )

    packed_local = jnp.concatenate(
        [
            pack_fields(p),
            w[:, None],
            p.alive.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )  # (n_local, 10)
    g10 = jax.lax.all_gather(packed_local, axis, tiled=True)
    w_g = g10[:, 8]

    # max-weight particle state captured pre-resample (replicated;
    # matches the reference's surviving pointer,
    # particle_filter.cpp:144-149)
    g = unpack_fields(g10[:, :8], w_g, g10[:, 9] > 0.5)
    ml_state = g.ml_state()[jnp.argmax(w_g)]

    # adaptive count + GMM (redundant per shard, deterministic)
    n_new = gmm_mod.adaptive_particle_count(
        state.gmm, state.n_active, n_max
    )

    # --- systematic resample: this shard fills slots
    #     [my*n_local, (my+1)*n_local) ---
    shift = jax.random.uniform(k_rs)  # same key on all shards
    i = my * n_local + jnp.arange(n_local, dtype=jnp.int32)
    j_all = _systematic_indices(w_g, n_new, state.n_active, shift)
    j = jax.lax.dynamic_slice(j_all, (my * n_local,), (n_local,))
    alive = i < n_new
    new_p = unpack_fields(
        jnp.take(g10[:, :8], j, axis=0),
        jnp.where(alive, 1.0 / jnp.maximum(n_new, 1), 0.0).astype(
            jnp.float32
        ),
        alive,
    )

    def do_gmm(_):
        # GMM over the POST-resample set (matches update_tail): the
        # full resampled state is reconstructed from the replicated
        # gather via j_all - no extra collective - so slots beyond
        # the old n_active never leak stale resample leftovers into
        # the strided sampler.
        full_alive = jnp.arange(n_max) < n_new
        full_new = unpack_fields(
            jnp.take(g10[:, :8], j_all, axis=0),
            jnp.where(
                full_alive, 1.0 / jnp.maximum(n_new, 1), 0.0
            ).astype(jnp.float32),
            full_alive,
        )
        return gmm_mod.compute_gmm(
            full_new,
            n_new,
            state.gmm.k,
            k_gmm,
            k_max=k_max,
        )

    new_gmm = jax.lax.cond(
        state.step % gmm_every == 0,
        do_gmm,
        lambda _: state.gmm,
        operand=None,
    )

    local_bb = pose_bbox(new_p)
    smask_local = shift_mask(
        rotation_shift(new_p.theta, theta_bins), new_p.alive, theta_bins
    )
    smask = jax.lax.psum(smask_local.astype(jnp.int32), axis) > 0
    bbox = jnp.concatenate(
        [
            jax.lax.pmin(local_bb[:2], axis),
            jax.lax.pmax(local_bb[2:], axis),
        ]
    )
    return state.replace(
        particles=new_p,
        n_active=n_new,
        ml_state=ml_state,
        gmm=new_gmm,
        key=key,
        step=state.step + 1,
        bbox=bbox,
        smask=smask,
    )


def make_sharded_step(
    mesh: Mesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    k_max: int = 8,
    gmm_every: int = 1,
    chunk_size: int = 2048,
    axis: str = "data",
):
    """Build the jitted multi-device step (exact-gather scoring): propagate
    + update in one compiled program.  n_max must divide evenly by the
    mesh size."""
    n_dev = mesh.devices.size
    assert n_max % n_dev == 0, "n_max must be divisible by mesh size"
    n_local = n_max // n_dev
    local_chunk = math.gcd(n_local, chunk_size)
    class_weights = _pad_class_weights(params, num_classes)

    def step_fn(
        state: FilterState,
        packed_map: jnp.ndarray,
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        motion: jnp.ndarray,  # (5,) tx, ty, omega, dist, gate
    ) -> FilterState:
        my = jax.lax.axis_index(axis)
        p = state.particles  # local shard (n_local)

        # --- propagate: per-device noise stream ---
        key, k_prop, k_rs, k_gmm = jax.random.split(state.key, 4)
        p = propagate(
            p,
            jax.random.fold_in(k_prop, my),
            motion[:2],
            motion[2],
            params,
            state.scale_frozen,
            dist=motion[3],
            noise_gate=motion[4],
        )

        # --- score (local, chunked) ---
        costs_all, _ = score_all_rotations(
            packed_map,
            stencil,
            scan,
            class_weights,
            p.pose_px(),
            p.scale,
            res,
            num_classes=num_classes,
            map_resolution=map_resolution,
            chunk_size=local_chunk,
        )
        w_raw, new_theta, have_init = compute_weights(
            costs_all, p, params, map_size_scaled, theta_bins
        )
        p = p.replace(theta=new_theta, have_init=have_init)
        return _sharded_tail(
            state, p, w_raw, key, k_rs, k_gmm, axis, n_max, n_local,
            k_max, gmm_every, theta_bins,
        )

    state_spec = _state_spec(axis)
    sharded = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(
            state_spec,
            P(),  # packed_map replicated
            P(),
            P(),  # stencil
            P(),  # scan
            P(),
            P(),  # motion
        ),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_step_multi(
    mesh: Mesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    bucket_mip_idx,
    mo: int | None = None,
    k_max: int = 8,
    gmm_every: int = 1,
    axis: str = "data",
):
    """Multi-device unknown-scale step: K scale buckets scored by the
    crop scorer (filter/multiscale.py) on each device's local particle
    shard against the replicated mip pyramid - the regime the
    reference's TBB pool parallelizes uniformly
    (particle_filter.cpp:104-105) scales the same way here.  The small
    per-bucket kernel build is recomputed per device: cheaper than
    communicating it.

    The deferred propagate is applied EAGERLY on the sharded state
    before dispatch (exactly like the single-device multi path: slot
    clustering must see post-diffusion scales), so this step carries no
    motion stage; tail semantics match _sharded_tail."""
    from top_down_renderer_tpu.filter import multiscale as ms
    from top_down_renderer_tpu.filter.filter import make_multi_cost

    n_dev = mesh.devices.size
    assert n_max % n_dev == 0, "n_max must be divisible by mesh size"
    n_local = n_max // n_dev
    class_weights = _pad_class_weights(params, num_classes)
    if mo is None:
        mo = ms.multi_mo()
    cost_fn = make_multi_cost(
        params, class_weights, mode, bucket_mip_idx, map_resolution, mo
    )

    def step_fn(
        state: FilterState,
        pyr,  # multiscale.PyramidMaps (replicated)
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        slot_vals: jnp.ndarray,
    ) -> FilterState:
        p = state.particles  # local shard (n_local)
        key, k_rs, k_gmm = jax.random.split(state.key, 3)
        cost, new_theta = cost_fn(p, pyr, stencil, scan, res, slot_vals)
        p = p.replace(
            theta=new_theta, have_init=jnp.ones_like(p.have_init)
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        return _sharded_tail(
            state, p, w_raw, key, k_rs, k_gmm, axis, n_max, n_local,
            k_max, gmm_every, theta_bins,
        )

    state_spec = _state_spec(axis)
    sharded = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(
            state_spec,
            P(),  # pyramid replicated (spec broadcasts over the pytree)
            P(),
            P(),  # stencil
            P(),  # scan
            P(),
            P(),  # slot_vals
        ),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_step_fast(
    mesh: Mesh,
    params: FilterParams,
    num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init"
    mo: int = 24,
    region: int = 128,
    window_w: int = 100,
    map_pad: int = 64,
    map_hp: int = 0,
    map_wp: int = 0,
    k_max: int = 8,
    gmm_every: int = 1,
    axis: str = "data",
    use_s2d: bool = True,
):
    """Multi-device conv cost-field step (the converged fast path): field
    ROWS are sharded over the mesh - each device convs its slice of the
    region and one all_gather assembles the small f32 field - so the
    dominant matmul work scales 1/n_dev.  The particle axis stays sharded
    end-to-end (propagate, field reads, weights, resample collectives
    as in make_sharded_step).

    Requires a uniform particle scale.  use_s2d picks the formulation:
    True = space-to-depth phase fold over padded4d (below the
    conv_score.K4_MAX_BYTES kernel gate); False = DIRECT conv over
    padded3d (large kernels, e.g. full-window tracked at mo 48) - the
    same gate the single-device path applies (conv_score.py make_conv_
    scorer), so mesh mode never silently drops to the exact gather.
    The direct path requires region % n_dev == 0 (ParticleFilter's
    dispatch enforces it)."""
    from top_down_renderer_tpu.filter import conv_score as cs

    n_dev = mesh.devices.size
    assert n_max % n_dev == 0, "n_max must be divisible by mesh size"
    n_local = n_max // n_dev
    class_weights = _pad_class_weights(params, num_classes)
    num_rot = params.num_rot_search
    s_out_t = 2 * window_w + 1
    s_out_i = 2 * num_rot + 1
    # mixed have_init: both column sets ride ONE conv (kernels
    # concatenated along the output axis)
    s_out = {"tracked": s_out_t, "init": s_out_i,
             "mixed": s_out_t + s_out_i}[mode]
    dr, dc = cs.conv_dims(mo)
    f4 = cs.F_S2D
    dye, dxe = cs.s2d_extent(dr), cs.s2d_extent(dc)
    nyb = region // f4 + 1
    nxb = region // f4 + 1
    nybl = -(-nyb // n_dev)  # folded field rows per device
    if use_s2d:
        assert n_dev <= 16, "fold_map_s2d margin sized for <= 16 devices"
    else:
        assert region % n_dev == 0, (
            "direct conv row-sharding needs region % n_dev == 0"
        )
    rl = max(region // n_dev, 1)  # direct field rows per device

    def step_fn(
        state: FilterState,
        mapbuf: jnp.ndarray,  # padded4d (s2d) | padded3d (direct)
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        motion: jnp.ndarray,  # (5,) tx, ty, omega, dist, gate
        s0: jnp.ndarray,
    ) -> FilterState:
        my = jax.lax.axis_index(axis)
        p = state.particles
        key, k_prop, k_rs, k_gmm = jax.random.split(state.key, 4)
        p = propagate(
            p,
            jax.random.fold_in(k_prop, my),
            motion[:2],
            motion[2],
            params,
            state.scale_frozen,
            dist=motion[3],
            noise_gate=motion[4],
        )
        th, r, _ = stencil.shape
        f = p.scale[0] * res  # uniform by contract
        if mode == "mixed":
            kernel = jnp.concatenate(
                [
                    cs.build_conv_kernel(
                        scan, class_weights, stencil, f, mo, "tracked",
                        num_rot, window_w, s0,
                    ),
                    cs.build_conv_kernel(
                        scan, class_weights, stencil, f, mo, "init",
                        num_rot, window_w, s0,
                    ),
                ],
                axis=-1,
            )
        else:
            kernel = cs.build_conv_kernel(
                scan, class_weights, stencil, f, mo, mode, num_rot,
                window_w, s0,
            )
        center_px = p.pose_px()
        cy = jnp.round(center_px[:, 1] / map_resolution).astype(
            jnp.int32
        ) + map_pad
        cx = jnp.round(center_px[:, 0] / map_resolution).astype(
            jnp.int32
        ) + map_pad
        big = jnp.int32(1 << 30)
        oy = jnp.clip(
            jax.lax.pmin(jnp.min(jnp.where(p.alive, cy, big)), axis),
            dr // 2,
            map_hp - (region + dr - 1) + dr // 2,
        )
        ox = jnp.clip(
            jax.lax.pmin(jnp.min(jnp.where(p.alive, cx, big)), axis),
            dc // 2,
            map_wp - (region + dc - 1) + dc // 2,
        )
        y0 = oy - dr // 2
        x0 = ox - dc // 2
        iy = jnp.clip(cy - oy, 0, region - 1)
        ix = jnp.clip(cx - ox, 0, region - 1)
        if use_s2d:
            k4 = cs.fold_kernel_s2d(kernel)
            ys4, roy = y0 // f4, y0 % f4
            xs4, rox = x0 // f4, x0 % f4
            # this device's slice of the folded field rows; explicit
            # im2col + matmul like cost_field_s2d_k4
            c4 = f4 * f4 * cs.C_PAD
            block = jax.lax.dynamic_slice(
                mapbuf,
                (ys4 + my * nybl, xs4, 0),
                (nybl + dye - 1, nxb + dxe - 1, c4),
            )
            pat = jnp.stack(
                [
                    jax.lax.slice(
                        block, (dy, dx, 0), (dy + nybl, dx + nxb, c4)
                    )
                    for dy in range(dye)
                    for dx in range(dxe)
                ],
                axis=2,
            ).reshape(nybl * nxb, dye * dxe * c4)
            out_loc = jnp.dot(
                pat,
                k4.reshape(dye * dxe * c4, -1),
                preferred_element_type=jnp.float32,
            ).reshape(nybl, nxb, 16 * s_out)  # (nybl, nxb, 16*s_out)
            out4 = jax.lax.all_gather(out_loc, axis, tiled=True)
            rows2d = out4.reshape(-1, s_out)
            jy = iy + roy
            jx = ix + rox
            cell = (
                ((jy // f4) * nxb + jx // f4) * 16
                + (jy % f4) * f4
                + jx % f4
            )
        else:
            # direct conv over this device's rl field rows of padded3d
            block = jax.lax.dynamic_slice(
                mapbuf,
                (y0 + my * rl, x0, 0),
                (rl + dr - 1, region + dc - 1, cs.C_PAD),
            )
            out_loc = jax.lax.conv_general_dilated(
                block[None].astype(jnp.bfloat16),
                kernel,
                window_strides=(1, 1),
                padding="VALID",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.float32,
            )[0]  # (rl, region, s_out)
            field = jax.lax.all_gather(out_loc, axis, tiled=True)
            rows2d = field.reshape(-1, s_out)
            cell = iy * region + ix
        # ONE (n_local, s_out) row gather feeds both column sets
        rows = rows2d[cell]
        lane = jnp.arange(s_out, dtype=jnp.int32)[None, :]

        def tracked_cost(off):
            s = rotation_shift(p.theta, th)
            local = jnp.clip((s - s0) % th, 0, window_w - 1)
            num = jnp.sum(
                jnp.where(lane == off + local[:, None], rows, 0.0), 1
            )
            den = jnp.sum(
                jnp.where(
                    lane == off + window_w + local[:, None], rows, 0.0
                ),
                1,
            )
            kf = rows[:, off + 2 * window_w] / (th * r)
            c = num / den
            return jnp.where(kf < 0.5, jnp.nan, c)

        def init_cost(off):
            nums = rows[:, off : off + num_rot]
            dens = rows[:, off + num_rot : off + 2 * num_rot]
            kf = rows[:, off + 2 * num_rot] / (th * r)
            costs = nums / dens
            costs = jnp.where(kf[:, None] < 0.5, jnp.nan, costs)
            return select_init_cost(costs, num_rot)

        if mode == "tracked":
            cost, new_theta = tracked_cost(0), p.theta
        elif mode == "init":
            cost, new_theta = init_cost(0)
        else:  # mixed: per-particle select between the two column sets
            cost_t = tracked_cost(0)
            cost_i, theta_i = init_cost(s_out_t)
            cost = jnp.where(p.have_init, cost_t, cost_i)
            new_theta = jnp.where(p.have_init, p.theta, theta_i)
        p = p.replace(
            theta=new_theta, have_init=jnp.ones_like(p.have_init)
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        return _sharded_tail(
            state, p, w_raw, key, k_rs, k_gmm, axis, n_max, n_local,
            k_max, gmm_every, theta_bins,
        )

    state_spec = _state_spec(axis)
    sharded = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(
            state_spec,
            P(),  # padded4d replicated
            P(),
            P(),
            P(),
            P(),
            P(),  # motion
            P(),  # s0
        ),
        out_specs=state_spec,
        check_vma=False,
    )
    return jax.jit(sharded)
