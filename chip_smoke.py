#!/usr/bin/env python3
"""GPU smoke check: the localization node's main path on one card.

Phases (any failure exits non-zero and prints no result line):

  device  the JAX backend must be the GPU; prints the card's name and
          power limit (nvidia-smi).
  parity  every scoring dispatch the node can take, at benchmark width
          (102,400 particles, 1024^2 6-class map, 100 x 25 polar scan):
          conv tracked / init, crop spread tracked / init, crop mip-4,
          multi (10 scale hypotheses) init / tracked - each compared
          with the exact-gather reference.
  node    a TopDownRenderNode (RuntimeParams defaults: 20,000
          particles; motion priors on) driven through pc_callback on
          the generated 1536^2 city world (2 px/m, seed 0): global init
          until tracking at known scale, then a short unknown-scale
          drive.  Fails on a pose error above its bound or on any
          logged exact-gather fallback.
  mesh    (only with --devices 4) ParticleFilter(mesh=make_mesh(4)) on
          the conv and multi paths at 102,400 particles against the
          single-device step with a deterministic motion.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

Run: python chip_smoke.py [--devices 4]
"""

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_BENCH = 102400
MAP_BENCH = 1024
TH, R = 100, 25

# parity bounds for the bf16 fast paths against the exact gather (f32 at
# precision "highest"): relative cost error over particles whose known
# fraction is >= 0.5 on both paths.  The fast paths sample at
# round(center) + round(offset) where the exact path rounds the sum, so
# some stencil points differ by a one-pixel shift: that, not bf16,
# dominates the error on random-texture maps.
TOL_MEDIAN = 1e-2
TOL_P99 = 5e-2
# ML pose and theta search: the fast path's best particle, and each
# particle's searched rotation, must score (exactly) within TOL_P99 of
# the exact best - near-ties may swap within the error bound
TOL_ARGMIN_SHARE = 0.98
TOL_ML_GAP = TOL_P99
# node drive: mean position error after convergence (meters)
TOL_NODE_ERR_M = 10.0
PRECISION = (
    "fast path: bf16 map windows x bf16 kernel, f32 accumulation; "
    "reference: exact gather, f32 at matmul precision highest"
)


def phases_for(devices: int):
    return ["mesh"] if devices == 4 else ["device", "parity", "node"]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.replace("\n", " | ")


def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
            "not the GPU"
        )
    return jax


# ---------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------


def _world(n, seed=0, cluster=None, theta_spread=None):
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge

    return ge._synthetic_setup(
        n, h=MAP_BENCH, w=MAP_BENCH, c=6, theta_bins=TH, range_bins=R,
        seed=seed, cluster=cluster, theta_spread=theta_spread,
    )


def _exact_costs(packed, stencil, scan, cw, center_px, scale, res,
                 map_resolution=1.0):
    import jax
    import jax.numpy as jnp

    from top_down_renderer_tpu.filter.scoring import score_all_rotations

    n = center_px.shape[0]
    chunk = min(4096, n)
    pad = -n % chunk
    center_px = jnp.pad(center_px, ((0, pad), (0, 0)))
    scale = jnp.pad(scale, (0, pad), constant_values=1.0)
    with jax.default_matmul_precision("highest"):
        costs, kf = score_all_rotations(
            packed, stencil, scan, cw, center_px, scale, res,
            num_classes=6, map_resolution=map_resolution,
            chunk_size=chunk,
        )
    return np.asarray(costs)[:n], np.asarray(kf)[:n]


def _compare(label, mode, cost, theta, p, costs_e, kf_e, dt_ms, card):
    """Print and check one dispatch's agreement with the exact costs."""
    from top_down_renderer_tpu.filter.scoring import (
        rotation_shift,
        search_shifts,
    )

    n = cost.shape[0]
    ssh = np.asarray(search_shifts(TH, 40))
    if mode == "tracked":
        s = np.asarray(rotation_shift(p.theta, TH))
        ref = costs_e[np.arange(n), s]
    else:
        ce = np.where(np.isnan(costs_e[:, ssh]), np.inf, costs_e[:, ssh])
        ref = ce.min(axis=1)
    ok = (kf_e >= 0.5) & np.isfinite(ref) & np.isfinite(cost)
    ok &= cost < 1e30
    if ok.sum() < 0.5 * n:
        print(json.dumps({"phase": "parity", "dispatch": label,
                          "scored": int(ok.sum()), "ok": False}))
        return False
    rel = np.abs(cost[ok] - ref[ok]) / np.abs(ref[ok])
    med, p99 = float(np.median(rel)), float(np.quantile(rel, 0.99))
    # ML pose: the fast path's lowest-cost particle, scored exactly
    i_fast = int(np.argmin(np.where(ok, cost, np.inf)))
    ml_gap = float((ref[i_fast] - ref[ok].min()) / ref[ok].min())
    res = {
        "phase": "parity", "dispatch": label, "particles": n,
        "scored": int(ok.sum()), "cost_rel_median": med,
        "cost_rel_p99": p99, "ml_gap": ml_gap,
        "tol": {"median": TOL_MEDIAN, "p99": TOL_P99,
                "ml_gap": TOL_ML_GAP},
        "precision": PRECISION, "score_ms": dt_ms, "card": card,
    }
    good = med < TOL_MEDIAN and p99 < TOL_P99 and ml_gap < TOL_ML_GAP
    if mode == "init":
        k = np.round(np.asarray(theta) / (2 * np.pi / 40)).astype(int)
        chosen = ce[np.arange(n), k % 40]
        share = float(np.mean(
            np.abs(chosen[ok] - ref[ok]) <= TOL_P99 * np.abs(ref[ok])
        ))
        res["argmin_share"] = share
        res["tol"]["argmin_share"] = TOL_ARGMIN_SHARE
        good &= share >= TOL_ARGMIN_SHARE
    res["ok"] = bool(good)
    print(json.dumps(res), flush=True)
    return good


def _timed(fn, *args):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, 1000.0 * (time.perf_counter() - t0) / reps


def phase_parity(card):
    import jax
    import jax.numpy as jnp

    from top_down_renderer_tpu.config import FilterParams
    from top_down_renderer_tpu.filter import conv_score as cs
    from top_down_renderer_tpu.filter import crop_score as crop
    from top_down_renderer_tpu.filter import multiscale as ms
    from top_down_renderer_tpu.filter.filter import (
        make_multi_cost,
        make_update_step_fast,
    )

    good = True
    cw = jnp.ones(6, jnp.float32)

    def fast_case(label, mode, path, scale, res_v, cluster, spread, s0,
                  ww, mip=1):
        (state, packed, _, stencil, scan, _, _) = _world(
            N_BENCH, seed=1, cluster=cluster,
            theta_spread=(0.7, spread) if spread else None,
        )
        p = state.particles.replace(
            scale=jnp.full((N_BENCH,), scale, jnp.float32),
            have_init=jnp.full((N_BENCH,), mode == "tracked"),
        )
        f = scale * res_v
        if path == "conv":
            mo = cs.pick_crop_size(f, R, cs.MO_BUCKETS_CONV)
            region = cs.pick_region(cluster[2] + 16)
        else:
            mo = cs.pick_crop_size(f / mip, R, crop.MO_BUCKETS)
            region = 0
        params = FilterParams(fixed_scale=scale, class_weights=[1.0] * 6)
        score = jax.jit(make_update_step_fast(
            params, 6, 1.0, TH, N_BENCH, mode, mo=mo, path=path,
            region=region, window_w=ww, mip=mip,
        )._score_impl)
        maps = cs.build_padded_maps(packed[::mip, ::mip])
        res = jnp.asarray(res_v, jnp.float32)
        (cost, theta), dt = _timed(
            score, p, maps, stencil, scan, res, jnp.asarray(s0, jnp.int32)
        )
        # mip paths score the mip-strided map: so does the reference
        costs_e, kf_e = _exact_costs(
            packed[::mip, ::mip], stencil, scan, cw, p.pose_px(),
            p.scale, res / mip, map_resolution=float(mip),
        )
        return _compare(label, mode, np.asarray(cost), theta, p,
                        costs_e, kf_e, dt, card)

    # converged cloud (100 px, narrow heading band): conv cost field
    s0 = int(round((0.7 - 0.15) * TH / (2 * np.pi)) - 4) % TH
    good &= fast_case("conv_tracked", "tracked", "conv", 2.0, 0.5,
                      (MAP_BENCH // 2, MAP_BENCH // 2, 100), 0.15, s0, 16)
    good &= fast_case("conv_init", "init", "conv", 2.0, 0.5,
                      (MAP_BENCH // 2, MAP_BENCH // 2, 100), 0.15, 0, TH)
    # spread cloud, uniform headings: crop windows
    good &= fast_case("crop_spread_tracked", "tracked", "crop", 2.0, 0.5,
                      None, None, 0, TH)
    good &= fast_case("crop_spread_init", "init", "crop", 2.0, 0.5,
                      None, None, 0, TH)
    # coarse range resolution: mip-4 crop
    good &= fast_case("crop_mip4", "tracked", "crop", 2.0, 2.0,
                      None, None, 0, TH, mip=4)

    # unknown scale: the 10 discrete hypotheses, one bucket each
    (state, packed, _, stencil, scan, _, _) = _world(N_BENCH, seed=2)
    hyp = (10.0 ** (np.arange(10) / 10.0)).astype(np.float32)
    scale = hyp[np.arange(N_BENCH) % 10]
    res_v = 0.5
    mo = ms.multi_mo(float(hyp[-1] / hyp[0]))
    mips = tuple(ms.mip_for_f(float(s) * res_v, mo / (R - 1)) for s in hyp)
    levels = tuple(sorted(set(mips)))
    bmi = tuple(levels.index(m) for m in mips)
    pyr = ms.build_pyramid_maps(packed, levels)
    res = jnp.asarray(res_v, jnp.float32)
    params = FilterParams(fixed_scale=-1.0, class_weights=[1.0] * 6)
    for mode in ("init", "tracked"):
        p = state.particles.replace(
            scale=jnp.asarray(scale),
            have_init=jnp.full((N_BENCH,), mode == "tracked"),
        )
        cost_fn = jax.jit(make_multi_cost(
            params, cw, mode, bmi, 1.0, mo
        ))
        (cost, theta), dt = _timed(
            cost_fn, p, pyr, stencil, scan, res, jnp.asarray(hyp)
        )
        cost = np.asarray(cost)
        # reference per bucket: the exact gather on the bucket's mip
        # level at the bucket's f (what the multi path approximates)
        costs_e = np.zeros((N_BENCH, TH), np.float32)
        kf_e = np.zeros(N_BENCH, np.float32)
        for k, m in enumerate(mips):
            sel = np.flatnonzero(np.arange(N_BENCH) % 10 == k)
            ce, ke = _exact_costs(
                packed[::m, ::m], stencil, scan, cw,
                p.pose_px()[sel], jnp.full(len(sel), hyp[k]),
                res / m, map_resolution=float(m),
            )
            costs_e[sel], kf_e[sel] = ce, ke
        good &= _compare(f"multi_{mode}", mode, cost, theta, p, costs_e,
                         kf_e, dt, card)
    return good


# ---------------------------------------------------------------------
# node drive
# ---------------------------------------------------------------------


class _FallbackLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.records = []

    def emit(self, record):
        if "exact-gather" in record.getMessage():
            self.records.append(record.getMessage())


def _city_node(unknown_scale, seed):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from city_bag import CLASS_COLORS, CLASS_NAMES

    from top_down_renderer_tpu.config import (
        ClassConfig,
        MapConfig,
        RuntimeParams,
    )
    from top_down_renderer_tpu.runtime.node import TopDownRenderNode

    color_lut = np.full((256, 3), 255, np.uint8)
    for i, col in enumerate(CLASS_COLORS):
        color_lut[i] = col
    cc = ClassConfig(
        color_lut=color_lut,
        class_to_flattened=list(range(len(CLASS_NAMES))),
        flattened_to_class=list(range(len(CLASS_NAMES))),
        exclusivity=[True] * len(CLASS_NAMES),
        loc_weight=[0.1, 1.0, 2.5, 1.5, 2.0, 2.0],
    )
    overrides = dict(regularization=0.02, pos_cov=0.1, force_on_map=True)
    if unknown_scale:
        overrides["fixed_scale"] = -1.0
    # the map arrives as a class-index image (dynamic map ingestion)
    return TopDownRenderNode(
        cc, MapConfig(dynamic=True, resolution=2.0),
        RuntimeParams(use_motion_prior=True),
        filter_overrides=overrides, seed=seed,
    )


def _drive(node, maps, bag, traj, scale_px_m, n_scans):
    from top_down_renderer_tpu.runtime.node import PoseStamped

    h, w = maps.shape[1:]
    ind = np.zeros((h, w), np.uint8)
    for cls in (0, 3, 4, 5, 2, 1):  # back-to-front class priority
        ind[maps[cls] == 0] = cls
    scale = max(node.filter.scale(), 0.0)
    pose_xy = np.array([w / 2, h / 2]) / scale if scale > 0 else np.zeros(2)
    node.aerial_map_callback(0.0, np.ascontiguousarray(ind[::-1]), pose_xy)
    errs, conv_at = [], None
    t0 = time.perf_counter()
    for i in range(n_scans):
        stamp = float(bag.scan_stamps[i])
        node.motion_prior_callback(PoseStamped(
            stamp=stamp, position=bag.prior_pos[i],
            orientation=bag.prior_quat[i],
        ))
        node.pc_callback(stamp, bag.scan(i))
        if node.is_converged and conv_at is None:
            conv_at = i
        ml, _cov = node.filter.pose_stats()
        errs.append(float(np.linalg.norm(ml[:2] - traj[i])) / scale_px_m)
    wall = time.perf_counter() - t0
    return np.asarray(errs), conv_at, wall


def phase_node(card):
    sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
    from city_bag import make_bag, make_city, make_drive

    log = _FallbackLog()
    logging.getLogger("top_down_renderer_tpu.filter.filter").addHandler(log)
    scale_px_m, dt = 2.0, 0.2
    t0 = time.perf_counter()
    maps, ys, xs = make_city(1536, 1536, seed=0)
    n_known, n_unknown = 100, 40
    traj, psi = make_drive(ys, xs, n_known, 8.0 * dt * scale_px_m, 0)
    bag = make_bag(maps, traj, psi, scale_px_m, dt=dt, seed=0)
    print(json.dumps({"phase": "node", "world_s":
                      time.perf_counter() - t0}), flush=True)
    good = True
    for unknown in (False, True):
        node = _city_node(unknown, seed=0)
        n = n_unknown if unknown else n_known
        errs, conv_at, wall = _drive(node, maps, bag, traj, scale_px_m, n)
        counts = dict(node.filter.dispatch_counts)
        tail = errs[conv_at:] if conv_at is not None else errs[-10:]
        res = {
            "phase": "node", "scale": "unknown" if unknown else "known",
            "particles": node.filter.n_max, "scans": n,
            "converged_at_scan": conv_at,
            "mean_err_m_after_conv": float(tail.mean()),
            "final_err_m": float(errs[-1]),
            "scale_est": node.filter.scale(),
            "dispatch_counts": counts, "fallbacks": len(log.records),
            "wall_s": wall, "ms_per_scan": 1000.0 * wall / n,
            "card": card,
        }
        ok = np.isfinite(errs).all() and not log.records
        ok &= counts.get("exact", 0) == 0
        if unknown:
            # the pre-freeze phase must ride the multi path
            ok &= counts.get("multi", 0) > 0
        else:
            res["tol_mean_err_m"] = TOL_NODE_ERR_M
            ok &= conv_at is not None
            ok &= float(tail.mean()) < TOL_NODE_ERR_M
        res["ok"] = bool(ok)
        print(json.dumps(res), flush=True)
        good &= ok
    return good


# ---------------------------------------------------------------------
# mesh (four devices)
# ---------------------------------------------------------------------


def _mesh_world(unknown_scale):
    from top_down_renderer_tpu.config import FilterParams, MapParams
    from top_down_renderer_tpu.maps.map import TopDownMap, build_grid

    rng = np.random.default_rng(0)
    c = 6
    maps_bin = (rng.random((c, MAP_BENCH, MAP_BENCH)) > 0.15).astype(
        np.float32
    )
    mid = MAP_BENCH // 2
    maps_bin[1, mid - 12 : mid + 12, :] = 0.0  # a road strip at the prior
    tdm = TopDownMap(MapParams(map_path="", num_classes=c, resolution=1.0))
    tdm.grid = build_grid(maps_bin, 1.0, 50.0)
    tdm.class_maps_binary = maps_bin
    tdm.have_map = True
    tdm.sample_pts_polar(TH, R)
    params = FilterParams(
        fixed_scale=-1.0 if unknown_scale else 2.0,
        class_weights=[0.5] + [1.5] * (c - 1), force_on_map=True,
        # a tight prior keeps the cloud inside one conv region from the
        # first step (the mesh serves crop dispatches with the exact
        # gather)
        init_pos_px_x=float(mid), init_pos_px_y=float(mid),
        init_pos_px_cov=10.0,
        init_pos_deg_theta=float("inf") if unknown_scale else 40.0,
        init_pos_deg_cov=5.0, pos_cov=0.0, theta_cov=0.0,
    )
    return tdm, params


def phase_mesh(card):
    import jax
    import jax.numpy as jnp

    from top_down_renderer_tpu.filter.filter import ParticleFilter
    from top_down_renderer_tpu.parallel.sharding import make_mesh

    good = True
    rng = np.random.default_rng(3)
    scan = jnp.asarray(rng.random((6, TH, R)).astype(np.float32))
    for label, unknown in (("conv", False), ("multi", True)):
        out = {}
        for where in ("single", "mesh"):
            tdm, params = _mesh_world(unknown)
            pf = ParticleFilter(
                N_BENCH, tdm, params, seed=7, chunk_size=4096,
                use_fast=True,
                mesh=make_mesh(4) if where == "mesh" else None,
            )
            # one step from the same seeded state: the noise-free motion
            # leaves both filters scoring the same particle set (the
            # resampling streams differ between the two step kinds)
            t0 = time.perf_counter()
            pf.propagate(np.array([1.0, 0.0], np.float32), 0.0)
            pf.update(scan, 0.5)
            jax.block_until_ready(pf.state)
            out[where] = (pf, time.perf_counter() - t0)
        pf_s, pf_m = out["single"][0], out["mesh"][0]
        paths = {k[0] if k[0] == "multi" else "conv" for k in pf_m._sharded_fns}
        ml_s, ml_m = pf_s.max_likelihood(), pf_m.max_likelihood()
        mp_s, mp_m = pf_s.mean_likelihood(), pf_m.mean_likelihood()
        d_ml = float(np.max(np.abs(ml_s[:2] - ml_m[:2])))
        d_mean = float(np.max(np.abs(mp_s[:2] - mp_m[:2])))
        # the sharded reductions sum in another order, so near-tied
        # particles may swap the argmax: agreement is the ML pose within
        # a pixel and the weighted mean within a pixel
        ok = label in paths and d_ml < 1.0 and d_mean < 1.0
        ok &= pf_m.dispatch_counts.get("exact", 0) == 0
        res = {
            "phase": "mesh", "dispatch": label, "devices": 4,
            "particles": pf_m.n_max, "ml_single": ml_s.tolist(),
            "ml_mesh": ml_m.tolist(), "ml_abs_diff_px": d_ml,
            "mean_abs_diff_px": d_mean, "tol_px": 1.0,
            "mesh_counts": dict(pf_m.dispatch_counts),
            "wall_s_single": out["single"][1],
            "wall_s_mesh": out["mesh"][1], "card": card, "ok": bool(ok),
        }
        print(json.dumps(res), flush=True)
        good &= ok
    return good


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)
    jax = require_gpu()
    if len(jax.devices()) < args.devices:
        raise SystemExit(
            f"chip_smoke: {args.devices} devices asked, "
            f"{len(jax.devices())} found"
        )
    sys.path.insert(0, ROOT)
    from top_down_renderer_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    card = card_line()
    print(f"card: {card}", flush=True)
    good = True
    for phase in phases_for(args.devices):
        t0 = time.perf_counter()
        if phase == "parity":
            good &= phase_parity(card)
        elif phase == "node":
            good &= phase_node(card)
        elif phase == "mesh":
            good &= phase_mesh(card)
        print(json.dumps({"phase": phase, "seconds":
                          time.perf_counter() - t0}), flush=True)
        if not good:
            raise SystemExit(f"chip_smoke: phase {phase} failed")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
