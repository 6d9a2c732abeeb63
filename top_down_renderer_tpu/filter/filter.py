"""The particle filter: one fused, functional, jitted step.

Capability port of ParticleFilter (/root/reference/src/particle_filter.cpp)
with StateParticle scoring folded in.  Where the reference fans out with
std::for_each(std::execution::par, ...) over shared_ptr particles guarded
by mutexes (particle_filter.cpp:104-105, particle_filter.h:45,64), here the
particle axis is a batched array dimension inside one compiled step - and
the one axis you shard over a device mesh to scale out (see parallel/).

Step structure (update(), parity with particle_filter.cpp:94-189 +
state_particle.cpp:157-213):
  score all rotations (one matmul) -> per-particle tracked / theta-search
  cost selection -> weight = 1/(cost+reg) with force-on-map + scale-range
  gates -> NaN repair to (mean - bottom_stddev) -> distance regularization
  -> adaptive particle count from GMM ellipse areas -> systematic resample
  -> (periodically) GMM refresh.
"""

from __future__ import annotations

import collections
import functools
import logging
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import (
    FilterState,
    GMMState,
    Particles,
    SemanticMapGrid,
)
from top_down_renderer_tpu.filter import gmm as gmm_mod
from top_down_renderer_tpu.filter import particles as particles_mod
from top_down_renderer_tpu.filter import stats as stats_mod
from top_down_renderer_tpu.filter.resample import systematic_resample
from top_down_renderer_tpu.filter.scoring import (
    rotation_shift,
    score_all_rotations,
    search_shifts,
    shift_mask,
)

FLT_MAX = float(np.finfo(np.float32).max)

logger = logging.getLogger(__name__)


def weight_from_cost(
    cost: jnp.ndarray,
    particles: Particles,
    params: FilterParams,
    map_size_scaled: jnp.ndarray,
) -> jnp.ndarray:
    """cost -> raw weight with the reference's gates
    (state_particle.cpp:163-176, 212): force-on-map and scale-range
    zero the weight before the 1/(cost+regularization) conversion."""
    weight = 1.0 / (cost + params.regularization)
    center = particles.pose_px()
    if params.force_on_map:
        off = (
            (center[:, 0] < 0)
            | (center[:, 1] < 0)
            | (center[:, 0] > map_size_scaled[0])
            | (center[:, 1] > map_size_scaled[1])
        )
        weight = jnp.where(off, 0.0, weight)
    if params.fixed_scale < 0:
        bad_scale = (
            particles.scale < 10.0**params.scale_log_min
        ) | (particles.scale > 10.0**params.scale_log_max)
        weight = jnp.where(bad_scale, 0.0, weight)
    return weight


def select_init_cost(
    cost_search: jnp.ndarray, num_rot: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Theta-search argmin with the reference's NaN semantics
    (state_particle.cpp:195-206): NaN never beats FLT_MAX, so an
    all-unknown window keeps best_cost=FLT_MAX / best_theta=0."""
    cost_search = jnp.where(
        jnp.isnan(cost_search), FLT_MAX, cost_search
    )
    k_best = jnp.argmin(cost_search, axis=1)
    best_cost = jnp.min(cost_search, axis=1)
    best_theta = k_best.astype(jnp.float32) * (
        2.0 * math.pi / num_rot
    )
    return best_cost, best_theta


def compute_weights(
    costs_all: jnp.ndarray,
    particles: Particles,
    params: FilterParams,
    map_size_scaled: jnp.ndarray,
    theta_bins: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Select per-particle cost (tracked rotation or 40-way search) and
    convert to raw weights with the reference's gates.

    Returns (weight_raw (N,), new_theta (N,), have_init (N,) all-True).

    Parity: state_particle.cpp:157-213.  In the search branch, NaN costs
    never beat FLT_MAX, so an all-unknown window yields best_cost=FLT_MAX
    (weight ~ 0, not NaN) and best_theta=0 - quirk preserved.
    """
    n, th = costs_all.shape

    # tracked: single rotation at the particle's theta (:208-210)
    s_tracked = rotation_shift(particles.theta, theta_bins)
    cost_tracked = jnp.take_along_axis(
        costs_all, s_tracked[:, None], axis=1
    )[:, 0]

    # uninitialized: search num_rot rotations, adopt argmin (:195-206)
    ssh = search_shifts(theta_bins, params.num_rot_search)
    best_cost, best_theta = select_init_cost(
        costs_all[:, ssh], params.num_rot_search
    )

    have = particles.have_init
    cost = jnp.where(have, cost_tracked, best_cost)
    new_theta = jnp.where(have, particles.theta, best_theta)
    weight = weight_from_cost(cost, particles, params, map_size_scaled)
    return weight, new_theta, jnp.ones_like(have)


def postprocess_weights(
    weight_raw: jnp.ndarray,
    last_dist: jnp.ndarray,
    alive: jnp.ndarray,
    n_active: jnp.ndarray,
) -> jnp.ndarray:
    """NaN repair + normalization + distance-based regularization.

    Parity: particle_filter.cpp:107-142.
    """
    isnan = jnp.isnan(weight_raw)
    valid = alive & ~isnan
    vf = valid.astype(jnp.float32)
    total = jnp.sum(jnp.where(valid, weight_raw, 0.0))
    num_valid = jnp.sum(vf)
    mean = total / jnp.maximum(num_valid, 1.0)

    under = valid & (weight_raw < mean)
    num_under = jnp.sum(under.astype(jnp.float32))
    bot_var = jnp.sum(
        jnp.where(under, (weight_raw - mean) ** 2, 0.0)
    ) / jnp.maximum(num_under, 1.0)
    bottom_stddev = jnp.sqrt(bot_var)

    degenerate = (total == 0) | (num_under < 1)
    repaired = jnp.where(alive & isnan, mean - bottom_stddev, weight_raw)
    w = jnp.where(degenerate, 1.0, repaired)
    w = jnp.where(alive, w, 0.0)
    w = w / jnp.sum(w)

    # distance regularization toward uniform (:137-142)
    d = jnp.minimum(last_dist * 5.0, 1.0)
    na = jnp.maximum(n_active.astype(jnp.float32), 1.0)
    w = jnp.where(alive, d * w + (1.0 - d) / na, 0.0)
    return w / jnp.sum(w)


def pose_bbox(p: Particles) -> jnp.ndarray:
    """(4,) min_x, min_y, max_x, max_y over alive particles."""
    pose = p.pose_px()
    big = jnp.float32(1e30)
    mn = jnp.min(
        jnp.where(p.alive[:, None], pose, big), axis=0
    )
    mx = jnp.max(
        jnp.where(p.alive[:, None], pose, -big), axis=0
    )
    return jnp.concatenate([mn, mx])


def update_tail(
    state: FilterState,
    p: Particles,
    w_raw: jnp.ndarray,
    n_max: int,
    k_max: int,
    gmm_every: int,
    theta_bins: int = 100,
):
    """Shared post-scoring pipeline: weight post-processing, adaptive
    count, systematic resample, periodic GMM (particle_filter.cpp:
    107-187, 245-318)."""
    w = postprocess_weights(w_raw, p.last_dist, p.alive, state.n_active)
    # capture the max-weight particle's state BEFORE resampling (the
    # reference keeps a pointer to the old particle that survives the
    # swap, particle_filter.cpp:144-149)
    ml_state = p.ml_state()[jnp.argmax(w)]
    n_new = gmm_mod.adaptive_particle_count(
        state.gmm, state.n_active, n_max
    )
    key, k_rs, k_gmm = jax.random.split(state.key, 3)
    new_particles = systematic_resample(p, w, n_new, state.n_active, k_rs)

    def do_gmm(_):
        return gmm_mod.compute_gmm(
            new_particles, n_new, state.gmm.k, k_gmm, k_max=k_max
        )

    new_gmm = jax.lax.cond(
        state.step % gmm_every == 0,
        do_gmm,
        lambda _: state.gmm,
        operand=None,
    )
    smask = shift_mask(
        rotation_shift(new_particles.theta, theta_bins),
        new_particles.alive,
        theta_bins,
    )
    return state.replace(
        particles=new_particles,
        n_active=n_new,
        ml_state=ml_state,
        gmm=new_gmm,
        key=key,
        step=state.step + 1,
        bbox=pose_bbox(new_particles),
        smask=smask,
    )


def _pad_class_weights(params, grid_num_classes):
    cw = np.asarray(params.class_weights, dtype=np.float32)
    if cw.size < grid_num_classes:
        cw = np.concatenate(
            [cw, np.ones(grid_num_classes - cw.size, np.float32)]
        )
    return jnp.asarray(cw[:grid_num_classes])


def make_tail_fn(
    params: FilterParams, n_max: int, k_max: int, gmm_every: int,
    theta_bins: int = 100, with_snapshot: bool = False,
):
    """Jitted post-scoring tail, shared by every scoring mode (keeps the
    per-mode compile small).  with_snapshot also returns the packed
    host-snapshot vector from the same dispatch (see _snapshot_vec)."""

    @jax.jit
    def tail(
        state: FilterState,
        cost: jnp.ndarray,
        new_theta: jnp.ndarray,
        map_size_scaled: jnp.ndarray,
    ):
        p = state.particles.replace(
            theta=new_theta,
            have_init=jnp.ones_like(state.particles.have_init),
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        out = update_tail(
            state, p, w_raw, n_max, k_max, gmm_every, theta_bins
        )
        if with_snapshot:
            return out, _snapshot_vec(out)
        return out

    return tail


def make_update_step_fast(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    mo: int = 24,
    k_max: int = 8,
    gmm_every: int = 1,
    path: str = "crop",  # "crop" (per-particle windows) | "conv"
    region: int = 128,
    window_w: int = 100,
    mip: int = 1,
    with_snapshot: bool = False,
):
    """Update using a fast scoring path (uniform scale): propagate +
    scoring + the shared tail compiled as ONE jit (one dispatch per
    scan).  res and scale are traced (f = scale*res changes without
    recompile); only the crop bucket mo (and conv region) are static.

    path="crop": per-particle map windows (crop_score.py) - any spatial
    spread.  path="conv": one cost field over the particle bounding
    region - much faster when the cloud is clustered (the converged
    regime).

    mip > 1 (crop path only) scores against a 'mip'-strided subsample
    of the map: the caller passes the matching subsampled PaddedMaps and
    the scorer sees f/mip at resolution map_resolution*mip.  This covers
    the exploration regime (scale*res beyond the finest crop bucket,
    /root/reference/src/state_particle.cpp:195-206 at coarse range
    scales) with a documented NN-granularity approximation of 'mip' px
    instead of 1 px."""
    from top_down_renderer_tpu.filter import conv_score as cs
    from top_down_renderer_tpu.filter import crop_score as crop

    class_weights = _pad_class_weights(params, grid_num_classes)
    if path == "conv":
        if mode in ("tracked", "mixed"):
            conv_tracked = cs.make_conv_scorer(
                mo, region, "tracked", params.num_rot_search,
                map_resolution, window_w=window_w,
            )
        if mode in ("init", "mixed"):
            conv_init = cs.make_conv_scorer(
                mo, region, "init", params.num_rot_search,
                map_resolution, window_w=window_w,
            )

    def _score_tracked(p, maps, stencil, scan, f, s0):
        if path == "conv":
            num, den, kf = conv_tracked(
                maps.padded3d, maps.padded4d, maps.pad, stencil,
                scan, class_weights, p.pose_px(), p.theta, f,
                p.alive, s0,
                padded4d_i8=maps.padded4d_i8, qinv=maps.qinv4d,
            )
        else:
            num, den, kf = crop.score_tracked(
                maps, stencil, scan, class_weights, p.pose_px(),
                p.theta, f / mip, mo, map_resolution * mip,
            )
        cost = num / den
        return jnp.where(kf < 0.5, jnp.nan, cost)

    def _score_init(p, maps, stencil, scan, f):
        if path == "conv":
            nums, dens, kf = conv_init(
                maps.padded3d, maps.padded4d, maps.pad, stencil, scan,
                class_weights, p.pose_px(), p.theta, f, p.alive,
            )
        else:
            nums, dens, kf = crop.score_init(
                maps, stencil, scan, class_weights, p.pose_px(),
                f / mip, mo, params.num_rot_search,
                map_resolution * mip,
            )
        costs = nums / dens
        costs = jnp.where(kf[:, None] < 0.5, jnp.nan, costs)
        return select_init_cost(costs, params.num_rot_search)

    def score_impl(
        particles: Particles,
        maps,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        s0: jnp.ndarray,
    ):
        p = particles
        f = p.scale[0] * res  # uniform by contract
        if mode == "tracked":
            return (
                _score_tracked(p, maps, stencil, scan, f, s0), p.theta
            )
        if mode == "init":
            return _score_init(p, maps, stencil, scan, f)
        # mixed have_init (e.g. a mid-run partial reinit): both flavors
        # in one step + the exact path's per-particle select
        # (compute_weights, state_particle.cpp:188-210) - two fast
        # scoring passes instead of a fall to the exact gather
        cost_t = _score_tracked(p, maps, stencil, scan, f, s0)
        cost_i, theta_i = _score_init(p, maps, stencil, scan, f)
        have = p.have_init
        return (
            jnp.where(have, cost_t, cost_i),
            jnp.where(have, p.theta, theta_i),
        )

    # donate the state: the filter's caller never reads the
    # pre-step state after update() (pose_stats keys its prefetch
    # cache on object identity; _fast_mode's host reads complete
    # before this dispatch), so XLA can write particle buffers
    # in place instead of allocating a fresh ~4 MB set per step
    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(
        state: FilterState,
        maps,
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        s0: jnp.ndarray,
        motion: jnp.ndarray,  # (5,) tx ty omega dist gate
    ) -> FilterState:
        # deferred propagate folded in (one dispatch per scan)
        key, k_prop = jax.random.split(state.key)
        p0 = particles_mod.propagate(
            state.particles,
            k_prop,
            motion[:2],
            motion[2],
            params,
            state.scale_frozen,
            dist=motion[3],
            noise_gate=motion[4],
        )
        state = state.replace(particles=p0, key=key)
        cost, new_theta = score_impl(p0, maps, stencil, scan, res, s0)
        p = p0.replace(
            theta=new_theta,
            have_init=jnp.ones_like(p0.have_init),
        )
        w_raw = weight_from_cost(cost, p, params, map_size_scaled)
        out = update_tail(
            state, p, w_raw, n_max, k_max, gmm_every, theta_bins
        )
        if with_snapshot:
            # the host snapshot rides the same dispatch (one jit
            # call per scan instead of step + pack)
            return out, _snapshot_vec(out)
        return out

    def update(
        state: FilterState,
        maps,
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        s0: int = 0,
        motion=None,
    ) -> FilterState:
        if motion is None:
            motion = jnp.zeros(5, jnp.float32)
        return step(
            state, maps, map_size_scaled, stencil, scan, res,
            jnp.asarray(s0, jnp.int32), motion,
        )

    update._score_impl = score_impl  # test seam (parity checks)
    return update


def make_multi_cost(
    params: FilterParams,
    class_weights: jnp.ndarray,
    mode: str,  # "tracked" | "init" | "mixed"
    bucket_mip_idx: Tuple[int, ...],
    map_resolution: float,
    mo: int,
):
    """Unknown-scale scoring (filter/multiscale.py): returns
    cost_fn(particles, pyr, stencil, scan, res, slot_vals) ->
    (cost (N,), new_theta (N,)) with the exact path's per-particle
    tracked / theta-search select (compute_weights,
    state_particle.cpp:188-210)."""
    from top_down_renderer_tpu.filter import multiscale as ms

    if mode in ("tracked", "mixed"):
        scorer_t = ms.make_score_tracked_multi(
            bucket_mip_idx, map_resolution, mo
        )
    if mode in ("init", "mixed"):
        scorer_i = ms.make_score_init_multi(
            bucket_mip_idx, params.num_rot_search, map_resolution, mo
        )

    def cost_fn(p, pyr, stencil, scan, res, slot_vals):
        def tracked_cost():
            num, den, kf = scorer_t(
                pyr, stencil, scan, class_weights, p.pose_px(),
                p.theta, p.scale, slot_vals, res,
            )
            return jnp.where(kf < 0.5, jnp.nan, num / den)

        def init_cost():
            nums, dens, kf = scorer_i(
                pyr, stencil, scan, class_weights, p.pose_px(),
                p.scale, slot_vals, res,
            )
            costs = jnp.where(kf[:, None] < 0.5, jnp.nan, nums / dens)
            return select_init_cost(costs, params.num_rot_search)

        if mode == "tracked":
            return tracked_cost(), p.theta
        if mode == "init":
            return init_cost()
        cost_t = tracked_cost()
        cost_i, theta_i = init_cost()
        return (
            jnp.where(p.have_init, cost_t, cost_i),
            jnp.where(p.have_init, p.theta, theta_i),
        )

    return cost_fn


def make_update_step_multiscale(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    mode: str,  # "tracked" | "init" | "mixed"
    bucket_mip_idx: Tuple[int, ...],
    mo: int | None = None,
    k_max: int = 8,
    gmm_every: int = 1,
    tail_fn=None,
):
    """Update step for the unknown-scale regime: K scale buckets through
    ONE crop pass (filter/multiscale.py).  slot_vals (the bucket scale
    values) are traced, so 2%-per-step scale diffusion
    (state_particle.cpp:71-74) re-uses the compiled step; only the
    bucket count and the bucket->mip assignment are static.  The
    deferred propagate is applied before this step (slot clustering
    needs the post-diffusion scales), so scoring and the shared tail
    are two dispatches."""
    from top_down_renderer_tpu.filter import multiscale as ms

    class_weights = _pad_class_weights(params, grid_num_classes)
    if tail_fn is None:
        tail_fn = make_tail_fn(
            params, n_max, k_max, gmm_every, theta_bins
        )
    if mo is None:
        mo = ms.multi_mo()
    score = jax.jit(
        make_multi_cost(
            params, class_weights, mode, bucket_mip_idx,
            map_resolution, mo,
        )
    )

    def update(
        state: FilterState,
        pyr,
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
        slot_vals: jnp.ndarray,
    ) -> FilterState:
        cost, new_theta = score(
            state.particles, pyr, stencil, scan, res, slot_vals
        )
        return tail_fn(state, cost, new_theta, map_size_scaled)

    return update


def make_update_step(
    params: FilterParams,
    grid_num_classes: int,
    map_resolution: float,
    theta_bins: int,
    n_max: int,
    k_max: int = 8,
    gmm_every: int = 1,
    chunk_size: int = 2048,
):
    """Build the jitted functional update step (exact-gather scoring).
    Returns update(state, packed_map, map_size_scaled, stencil, scan,
    res) -> FilterState."""

    class_weights = _pad_class_weights(params, grid_num_classes)

    @jax.jit
    def update(
        state: FilterState,
        packed_map: jnp.ndarray,
        map_size_scaled: jnp.ndarray,
        stencil: jnp.ndarray,
        scan: jnp.ndarray,
        res: jnp.ndarray,
    ) -> FilterState:
        p = state.particles
        costs_all, _kf = score_all_rotations(
            packed_map,
            stencil,
            scan,
            class_weights,
            p.pose_px(),
            p.scale,
            res,
            num_classes=grid_num_classes,
            map_resolution=map_resolution,
            chunk_size=chunk_size,
        )
        w_raw, new_theta, have_init = compute_weights(
            costs_all, p, params, map_size_scaled, theta_bins
        )
        p = p.replace(theta=new_theta, have_init=have_init)
        return update_tail(
            state, p, w_raw, n_max, k_max, gmm_every, theta_bins
        )

    return update


# packed host-snapshot layout (_pack_host_snapshot)
_SNAP_BBOX = slice(0, 4)
_SNAP_NACT = 4
_SNAP_ML = slice(5, 9)
_SNAP_COV = slice(9, 25)
_SNAP_SMASK = slice(25, None)


def _snapshot_vec(state: FilterState) -> jnp.ndarray:
    """Every tiny per-step host-read value in ONE device vector, so the
    node loop pays one device->host transfer per scan instead of five.
    Layout: bbox[4],
    n_active, mean-likelihood state[4], mean cov[16], smask[Th]."""
    ml, cov = stats_mod.pose_stats(state.particles, state.n_active)
    return jnp.concatenate(
        [
            state.bbox.astype(jnp.float32).reshape(4),
            state.n_active.astype(jnp.float32).reshape(1),
            ml.astype(jnp.float32).reshape(4),
            cov.astype(jnp.float32).reshape(16),
            state.smask.astype(jnp.float32).reshape(-1),
        ]
    )


@jax.jit
def _pack_host_snapshot(state):
    return _snapshot_vec(state)


class ParticleFilter:
    """Host-facing wrapper with the reference's ParticleFilter API
    (particle_filter.h:24-41).

    mesh: a 1-D jax.sharding.Mesh scales the filter over several devices
    (particle axis sharded; conv cost-field rows sharded - see
    parallel/sharding.py).  In mesh mode propagate() is deferred into
    the fused sharded step that the next update() runs (queries between
    propagate and update see the pre-propagate particles)."""

    def __init__(
        self,
        n_max: int,
        tdmap,  # maps.map.TopDownMap
        params: FilterParams,
        seed: int = 0,
        theta_bins: int = 100,
        gmm_every: int = 10,
        chunk_size: int = 2048,
        use_fast: str | bool = "auto",
        mesh=None,
    ):
        # gmm_every=10 is the node-rate equivalent of the reference's
        # 1 Hz GMM background thread (particle_filter.cpp:245-250) at
        # its 10 Hz KITTI scan rate; RuntimeParams.gmm_every and
        # bench.py use the same default.
        # pad N to a chunk multiple (static-shape requirement)
        chunk_size = min(chunk_size, n_max)
        n_max = ((n_max + chunk_size - 1) // chunk_size) * chunk_size
        self.mesh = mesh
        if mesh is not None:
            # also a mesh-size multiple so the particle axis shards evenly
            n_dev = int(mesh.devices.size)
            n_max = ((n_max + n_dev - 1) // n_dev) * n_dev
        self.n_max = n_max
        self.map = tdmap
        self.params = params
        self.theta_bins = theta_bins
        self.chunk_size = chunk_size
        self.gmm_every = gmm_every
        self.seed = seed
        self.state: Optional[FilterState] = None
        self._update_fn = None
        self._last_map_center = np.zeros(2, dtype=np.int64)
        # fast scoring paths (conv_score.py, crop_score.py,
        # multiscale.py); the CPU backend keeps the exact gather unless
        # asked (or on a mesh, whose crop/mip dispatches fall back to
        # the sharded exact step in update())
        if use_fast == "auto":
            use_fast = (
                mesh is not None
                or jax.default_backend() not in ("cpu",)
            )
        self.use_fast = bool(use_fast)
        self._fast_fns = {}
        self._sharded_fns = {}
        self._pending_motion = None
        self._snap_pending = None
        self._maps_cache = {}
        self._pyramid_cache = {}
        self._map_version = 0
        self._all_have_init = False
        self._last_omega = 0.0
        self._last_dist_m = 0.0
        # host mirrors of the freeze state: an eager device read
        # (bool(state.scale_frozen), particles.scale[0]) waits for the
        # device, and these only change via freeze_scale()
        self._scale_frozen_host = False
        self._frozen_scale_cache = -1.0
        self._slow_reason = None  # last logged exact-gather fallback
        # scoring dispatches taken by update(), per path
        self.dispatch_counts = collections.Counter()

        if tdmap.have_map:
            self.initialize_particles()

    # -- lifecycle -----------------------------------------------------
    def initialize_particles(self) -> None:
        """particle_filter.cpp:19-84 (metric-init conversion included,
        :27-53)."""
        params = self.params
        g = self.map.grid
        map_size_scaled = np.array(
            [g.width, g.height], dtype=np.float32
        ) * self.map.resolution

        if params.fixed_scale >= 0 and math.isfinite(params.init_pos_m_x):
            center = np.asarray(g.map_center)
            px = params.init_pos_m_x * params.fixed_scale + center[0]
            py = params.init_pos_m_y * params.fixed_scale + center[1]
            if not (0 <= px < g.width and 0 <= py < g.height):
                print("[tdr] No map received for input loc")
                return
            good = False
            for dx in range(-4, 5):
                for dy in range(-4, 5):
                    if 1 in self.map.get_classes_at_point((px + dx, py + dy)):
                        good = True
                        break
                if good:
                    break
            if not good:
                print("[tdr] No road in map at init location")
                return
            params.init_pos_px_x = float(px)
            params.init_pos_px_y = float(py)

        self._all_have_init = False
        parts, n_active = particles_mod.initialize_particles(
            self.n_max,
            np.asarray(g.road_ok),
            map_size_scaled,
            self.map.resolution,
            params,
            seed=self.seed,
        )
        frozen = params.fixed_scale >= 0
        self._scale_frozen_host = frozen
        self._frozen_scale_cache = (
            params.fixed_scale if frozen else -1.0
        )
        key = jax.random.PRNGKey(self.seed)
        # seed smask from the actual initial thetas (same derivation as
        # update_tail) so a theta prior narrows the very first tracked
        # step's shift window - all-ones would force a full-window conv
        # kernel variant that is immediately abandoned
        smask0 = shift_mask(
            rotation_shift(parts.theta, self.theta_bins),
            parts.alive,
            self.theta_bins,
        )
        self.state = FilterState(
            particles=parts,
            n_active=jnp.asarray(n_active, dtype=jnp.int32),
            scale_frozen=jnp.asarray(frozen),
            frozen_scale=jnp.asarray(
                params.fixed_scale if frozen else -1.0, dtype=jnp.float32
            ),
            ml_state=parts.ml_state()[0],
            gmm=GMMState.init(8),
            key=key,
            step=jnp.asarray(0, dtype=jnp.int32),
            bbox=pose_bbox(parts),
            smask=smask0,
        )
        if self.mesh is not None:
            from top_down_renderer_tpu.parallel.sharding import (
                make_sharded_step,
            )

            self._update_fn = make_sharded_step(
                self.mesh,
                params,
                num_classes=g.num_classes,
                map_resolution=self.map.resolution,
                theta_bins=self.theta_bins,
                n_max=self.n_max,
                gmm_every=self.gmm_every,
                chunk_size=self.chunk_size,
            )
        else:
            self._update_fn = make_update_step(
                params,
                g.num_classes,
                self.map.resolution,
                self.theta_bins,
                self.n_max,
                gmm_every=self.gmm_every,
                chunk_size=self.chunk_size,
            )
        # initial GMM (particle_filter.cpp:81)
        key, k_gmm = jax.random.split(key)
        self.state = self.state.replace(
            key=key,
            gmm=gmm_mod.compute_gmm(
                parts, self.state.n_active, jnp.asarray(1), k_gmm
            ),
        )
        if self.mesh is not None:
            from top_down_renderer_tpu.parallel.sharding import (
                shard_filter_state,
            )

            self.state = shard_filter_state(self.state, self.mesh)

    def reinitialize_fraction(
        self, frac: float, seed: int | None = None
    ) -> None:
        """Redraw a random subset of the alive particles at fresh road
        positions with NO theta prior (have_init=False) - a global
        relocalization kick (the recovery the reference gets from its
        road-rejection-sampling StateParticle ctor,
        state_particle.cpp:20-32, when particles are re-created).

        The resulting population has MIXED have_init, which the next
        update() scores with mode="mixed" on the fast paths (tracked +
        theta-search flavors in one step, per-particle select) instead
        of falling to the exact gather."""
        if self.state is None or frac <= 0.0:
            return
        rng = np.random.default_rng(
            self.seed + 104729 if seed is None else seed
        )
        p = self.state.particles
        alive = np.asarray(p.alive)
        idx_alive = np.flatnonzero(alive)
        k = int(round(frac * idx_alive.size))
        if k == 0:
            return
        idx = rng.choice(idx_alive, size=k, replace=False)
        g = self.map.grid
        map_size_scaled = np.array(
            [g.width, g.height], np.float32
        ) * self.map.resolution
        pos = particles_mod._sample_positions_on_road(
            rng, k, np.asarray(g.road_ok), map_size_scaled,
            self.map.resolution, self.params,
        )
        jidx = jnp.asarray(idx)
        parts = p.replace(
            init_px=p.init_px.at[jidx].set(
                jnp.asarray(pos, jnp.float32)
            ),
            d_m=p.d_m.at[jidx].set(0.0),
            theta=p.theta.at[jidx].set(0.0),
            have_init=p.have_init.at[jidx].set(False),
        )
        self.state = self.state.replace(
            particles=parts,
            bbox=pose_bbox(parts),
            # fresh thetas invalidate the device-tracked shift window
            smask=jnp.ones_like(self.state.smask),
        )
        self._all_have_init = False

    # -- step ----------------------------------------------------------
    def propagate(self, trans, omega) -> None:
        """Record a body-frame motion; applied at the next update().

        Deferred in EVERY mode (single-chip fast paths fold the
        propagate into the fused step - one dispatch per scan; the mesh
        step always did).  Successive calls COMPOSE (rotate the new
        body-frame translation by the accumulated omega, sum omegas and
        noise-scaling distances), so per-odometry-tick propagation
        matches per-call application.  Queries between propagate() and
        update() see the pre-propagate particles."""
        if self.state is None:
            return
        t = np.asarray(trans, dtype=np.float64).reshape(-1)
        d = float(np.hypot(t[0], t[1]))
        # accumulate since the last update() for the shift-window margin
        # (several propagate calls per update is a supported pattern,
        # particle_filter.h:27)
        self._last_omega += float(omega)
        self._last_dist_m += d
        t2 = np.asarray(trans, np.float32).reshape(2)
        if self._pending_motion is None:
            self._pending_motion = (t2, float(omega), d)
        else:
            t0, o0, d0 = self._pending_motion
            c, s = math.cos(o0), math.sin(o0)
            t_rot = np.asarray(
                [c * t2[0] - s * t2[1], s * t2[0] + c * t2[1]],
                np.float32,
            )
            self._pending_motion = (
                t0 + t_rot, o0 + float(omega), d0 + d
            )

    def _pop_motion(self) -> np.ndarray:
        """(5,) tx ty omega dist gate for the fused step."""
        if self._pending_motion is not None:
            trans, omega, dist = self._pending_motion
            self._pending_motion = None
            return np.asarray(
                [trans[0], trans[1], omega, dist, 1.0], np.float32
            )
        return np.zeros(5, np.float32)

    def _apply_pending_motion(self) -> None:
        """Propagate for paths without a fused motion stage (exact
        gather, multi-scale) - ONE jitted dispatch instead of one per
        jnp op of the motion model."""
        if self._pending_motion is None:
            return
        trans, omega, dist = self._pending_motion
        self._pending_motion = None
        if not hasattr(self, "_propagate_jit"):
            params = self.params

            @jax.jit
            def _prop(particles, key, motion, scale_frozen):
                k2, sub = jax.random.split(key)
                parts = particles_mod.propagate(
                    particles, sub, motion[:2], motion[2], params,
                    scale_frozen, dist=motion[3],
                )
                return parts, k2

            self._propagate_jit = _prop
        motion = np.asarray(
            [trans[0], trans[1], omega, dist], np.float32
        )
        parts, key = self._propagate_jit(
            self.state.particles, self.state.key,
            jnp.asarray(motion), self.state.scale_frozen,
        )
        self.state = self.state.replace(particles=parts, key=key)

    def _slow_path(self, reason: str):
        """The exact gather is far slower than the fast paths at large
        particle counts - never take it silently.  Logs once per
        distinct reason per dispatch-state change."""
        if reason != self._slow_reason:
            self._slow_reason = reason
            logger.warning(
                "falling back to exact-gather scoring: %s", reason
            )
        return None

    def _fast_mode(self, res: float):
        """Host-side fast-path dispatch: returns (mode, d, scale) or None.

        The fast path requires a uniform particle scale (fixed or frozen),
        a crop bucket covering scale*res, and a homogeneous have_init
        (all -> tracked flavor, none -> theta-search flavor)."""
        if not self.use_fast:
            return None
        from top_down_renderer_tpu.filter import conv_score as cs
        from top_down_renderer_tpu.filter import crop_score as crop

        if self.params.fixed_scale > 0:
            scale = self.params.fixed_scale
        elif self._scale_frozen_host:
            scale = self._frozen_scale_cache
        else:
            # unknown scale: K-bucket multi-scale crop path (the
            # reference's 10 discrete scale hypotheses,
            # particle_filter.cpp:19-25, stay clustered until freeze)
            return self._multi_mode(res)
        range_bins = self.map.stencil.shape[1]
        mo_crop = cs.pick_crop_size(
            scale * res, range_bins, crop.MO_BUCKETS
        )
        mo_conv = cs.pick_crop_size(
            scale * res, range_bins, cs.MO_BUCKETS_CONV
        )
        mip = 1
        if self._all_have_init:
            mode = "tracked"
        else:
            # pre-first-update: every particle either has a prior theta
            # or none do (initialize_particles sets have_init
            # uniformly); a mid-run PARTIAL reinit yields "mixed", which
            # runs both fast flavors + a per-particle select instead of
            # falling to the exact gather
            have = np.asarray(self.state.particles.have_init)
            alive = np.asarray(self.state.particles.alive)
            if np.all(have[alive]):
                mode = "tracked"
            elif not np.any(have[alive]):
                mode = "init"
            else:
                mode = "mixed"

        # clustered cloud -> conv cost-field path (bbox kept on device)
        region = None
        if self.n_active_host() > 0 and mo_conv is not None:
            snap = self._host_snapshot()
            bb = snap[_SNAP_BBOX] / self.map.resolution
            extent = int(
                np.ceil(max(bb[2] - bb[0], bb[3] - bb[1]))
            ) + 2
            region = cs.pick_region(extent)
            if region is not None:
                # the conv block (region + kernel - 1)^2 must fit the
                # padded map; small maps fall back to the crop path
                dr, dc = cs.conv_dims(mo_conv)
                pm = self._get_padded_maps()
                if (region + dr - 1 > pm.hp) or (region + dc - 1 > pm.wp):
                    region = None
        if region is not None:
            if mode == "mixed":
                # the device-tracked smask predates the partial reinit
                # (fresh thetas aren't in it): full shift window
                s0, ww = 0, self.theta_bins
            else:
                s0, ww = self._shift_window()
            self._slow_reason = None
            return (mode, mo_conv, scale, "conv", region, s0, ww, 1)
        if mo_crop is None:
            # exploration regime (scale*res beyond every crop bucket, or
            # a cloud too spread for any conv region): score against a
            # 2^k-strided mip of the map; NN granularity degrades to
            # 'mip' px - the coarse-to-fine tradeoff the reference pays
            # in time instead (its theta-search sweep,
            # state_particle.cpp:195-206, at coarse range scales)
            for mip in (2, 4, 8, 16, 32):
                mo_crop = cs.pick_crop_size(
                    scale * res / mip, range_bins, crop.MO_BUCKETS
                )
                if mo_crop is not None:
                    break
            else:
                return self._slow_path(
                    "scale*res=%.3g exceeds every crop bucket even at "
                    "mip 32" % (scale * res)
                )
        self._slow_reason = None
        return (
            mode, mo_crop, scale, "crop", 0, 0, self.theta_bins, mip
        )

    def _multi_mode(self, res: float):
        """Unknown-scale dispatch: cluster the alive scales into <=
        MAX_BUCKETS slots and route to the K-bucket crop path.  Returns
        a 'multi'-tagged tuple (mode, None, None, 'multi', slot_vals,
        mip levels, bucket->level idx, K_padded) or None (exact
        gather)."""
        from top_down_renderer_tpu.filter import multiscale as ms

        # the pending propagate diffuses scales up to ~2%/step; apply it
        # BEFORE clustering so slot assignment and the <=SCALE_RTOL
        # quantization guarantee hold for the scales actually scored
        self._apply_pending_motion()
        if self._all_have_init:
            mode = "tracked"
        else:
            have = np.asarray(self.state.particles.have_init)
            alive_m = np.asarray(self.state.particles.alive)
            if np.all(have[alive_m]):
                mode = "tracked"
            elif not np.any(have[alive_m]):
                mode = "init"
            else:
                mode = "mixed"
        p = self.state.particles
        alive = np.asarray(p.alive)
        scales = np.asarray(p.scale)[alive]
        if scales.size == 0:
            return self._slow_path("no alive particles with scale > 0")
        # rtol ladder: post-freeze-adjacent populations diffuse into
        # more than MAX_BUCKETS slots at the base rtol; coarser slots
        # (quantization error rtol*(range_bins-1) px) beat the
        # exact-gather fall
        slots = rtol = None
        for rt in ms.RTOL_LADDER:
            slots = ms.cluster_scales(scales, rtol=rt)
            if slots is not None:
                rtol = rt
                break
        if slots is None:
            # diffuse continuum: exact gather
            return self._slow_path(
                "alive scales form a continuum (> %d clusters even at "
                "rtol %.2g)" % (ms.MAX_BUCKETS, ms.RTOL_LADDER[-1])
            )
        # pad K to a few static sizes so buckets dying off as the scale
        # posterior sharpens doesn't recompile at every count
        k = len(slots)
        kp = next(
            x for x in ms.BUCKET_PAD if k <= x
        )
        slots_p = np.concatenate(
            [slots, np.full(kp - k, slots[-1], np.float32)]
        )
        # every slot's stencil must fit the static mo crop bucket:
        # offsets reach (range_bins-1) * slot*(1+rtol)*res/mip px, so
        # pick each slot's mip against fmax = mo/(range_bins-1) with
        # the slot's rtol spread inflated in (the +1 px crop margin
        # absorbs the base rtol but not the ladder's coarser rungs).  A
        # slot that saturates even ms.MAX_MIP drops the whole dispatch to
        # the exact gather - the crop window would silently alias.
        range_bins = self.map.stencil.shape[1]
        # adaptive precision: coarse mo while the posterior spans
        # many hypotheses, fine mo once <=2 adjacent ones remain (see
        # ms.multi_mo).  Robust p2/p98 spread: a lone straggler at a
        # dead hypothesis must not hold the whole population at coarse
        # precision (it still gets scored - its slot stays in the
        # table - it just doesn't vote on the precision phase).
        lo, hi = np.percentile(scales, [2.0, 98.0])
        spread = float(hi / max(lo, 1e-20))
        mo = ms.multi_mo(spread)
        fmax = mo / max(range_bins - 1, 1)
        # the +1 px crop margin absorbs the BASE rtol spread; ladder
        # rungs beyond it inflate f so the mip choice stays safe
        infl = (1.0 + rtol) / (1.0 + ms.SCALE_RTOL)
        # a slot that saturates even ms.MAX_MIP normally drops the whole
        # dispatch to the exact gather (the crop window would silently
        # alias) - but when EVERY particle in the slot sits above the
        # scale gate (slot*(1-rtol) > 10^scale_log_max), their weights
        # are zeroed by weight_from_cost regardless of cost, so the
        # slot is scored at a clamped scale on the coarsest level
        # instead of stalling the step on the exact gather (observed in
        # earlier unknown-scale drives: one diffusion outlier past scale
        # 30 cost 2-3 exact-gather steps per run)
        gate_hi = 10.0 ** self.params.scale_log_max
        s_cap = fmax * ms.MAX_MIP / (infl * res)
        mips_l = []
        for i, s in enumerate(slots_p):
            m = ms.mip_for_f(float(s) * infl * res, fmax)
            if m is None:
                if float(s) * (1.0 - rtol) > gate_hi:
                    slots_p[i] = s_cap
                    m = ms.MAX_MIP
                else:
                    return self._slow_path(
                        "a scale bucket saturates even the mip-%d "
                        "pyramid level" % ms.MAX_MIP
                    )
            mips_l.append(m)
        mips = tuple(mips_l)
        levels = tuple(sorted(set(mips)))
        bmi = tuple(levels.index(m) for m in mips)
        self._slow_reason = None
        return (mode, mo, None, "multi", slots_p, levels, bmi, kp)

    def _get_pyramid_maps(self, levels):
        from top_down_renderer_tpu.filter import multiscale as ms

        key = (self._map_version, levels)
        if key not in self._pyramid_cache:
            self._pyramid_cache[key] = ms.build_pyramid_maps(
                self.map.grid.dist, levels
            )
        return self._pyramid_cache[key]

    def _get_multi_fn(self, mode: str, bmi, mo: int):
        key = ("multi", mode, len(bmi), bmi, mo)
        if key not in self._fast_fns:
            if not hasattr(self, "_tail_fn"):
                self._tail_fn = make_tail_fn(
                    self.params, self.n_max, 8, self.gmm_every,
                    self.theta_bins, with_snapshot=True,
                )
            self._fast_fns[key] = make_update_step_multiscale(
                self.params,
                self.map.grid.num_classes,
                self.map.resolution,
                self.theta_bins,
                self.n_max,
                mode,
                bmi,
                mo=mo,
                gmm_every=self.gmm_every,
                tail_fn=self._tail_fn,
            )
        return self._fast_fns[key]

    def _shift_window(self):
        """Smallest circular shift window covering the live shifts (from
        the device-tracked smask), padded for this step's rotation delta
        and theta noise, bucketed to {16, 32, 64, theta_bins}."""
        th = self.theta_bins
        sm = self._host_snapshot()[_SNAP_SMASK] > 0.5
        present = np.nonzero(sm)[0]
        if len(present) == 0 or len(present) == th:
            return 0, th
        # largest circular gap between consecutive present shifts
        ext = np.concatenate([present, [present[0] + th]])
        gaps = np.diff(ext)
        gi = int(np.argmax(gaps))
        span = th - int(gaps[gi])  # covered arc (bins - 1)
        start = int(present[(gi + 1) % len(present)])
        # pad by this step's rotation delta plus 3 sigma of the theta
        # noise (stddev = theta_cov * dist, particles.propagate), so
        # noise-tail particles on longer steps aren't clamped to the
        # window edge and scored at a wrong rotation
        noise3 = 3.0 * self.params.theta_cov * self._last_dist_m
        margin = int(
            np.ceil(abs(self._last_omega) * th / (2 * np.pi))
        ) + max(3, int(np.ceil(noise3 * th / (2 * np.pi))))
        need = span + 1 + 2 * margin
        for ww in (16, 32, 64):
            if need <= ww:
                s0 = (start - margin - (ww - need) // 2) % th
                return int(s0), ww
        return 0, th

    def _get_padded_maps(self, mip: int = 1):
        """Zero-padded device map copies at a mip level ('mip'-strided
        subsample; level 1 = full resolution).  Cached per (map version,
        level); update_map clears the cache."""
        from top_down_renderer_tpu.filter import conv_score as cs

        key = (self._map_version, mip)
        if key not in self._maps_cache:
            dist = self.map.grid.dist
            if mip > 1:
                dist = dist[::mip, ::mip]
            self._maps_cache[key] = cs.build_padded_maps(dist)
        return self._maps_cache[key]

    def _get_fast_fn(
        self, mode: str, mo: int, path: str = "crop", region: int = 0,
        window_w: int = 100, mip: int = 1,
    ):
        key = (mode, mo, path, region, window_w, mip)
        if key not in self._fast_fns:
            self._fast_fns[key] = make_update_step_fast(
                self.params,
                self.map.grid.num_classes,
                self.map.resolution,
                self.theta_bins,
                self.n_max,
                mode,
                mo=mo,
                gmm_every=self.gmm_every,
                path=path,
                region=region,
                window_w=window_w,
                mip=mip,
                with_snapshot=True,
            )
        return self._fast_fns[key]

    def warmup(
        self,
        res: float,
        regions=(64, 128, 256),
        windows=(16, 100),
        modes=("tracked", "init"),
    ) -> None:
        """Precompile fast-path variants for a deployment operating
        point, so first-touch compiles land before the first scan (the
        persistent compilation cache makes warmup a one-time cost)."""
        if self.state is None or not self.use_fast:
            return
        from top_down_renderer_tpu.filter import conv_score as cs
        from top_down_renderer_tpu.filter import crop_score as crop

        scale = (
            self.params.fixed_scale
            if self.params.fixed_scale > 0
            else float(self.state.particles.scale[0])
        )
        range_bins = self.map.stencil.shape[1]
        g = self.map.grid
        map_size_scaled = (
            jnp.asarray([g.width, g.height], dtype=jnp.float32)
            * self.map.resolution
        )
        dummy_scan = jnp.zeros(
            (g.num_classes, self.theta_bins, range_bins), jnp.float32
        )
        stencil = jnp.asarray(self.map.stencil)
        res_j = jnp.asarray(res, jnp.float32)

        def warm(fn, mip=1):
            # the fast step donates its state argument: run on a copy
            fn(
                jax.tree.map(jnp.copy, self.state),
                self._get_padded_maps(mip),
                map_size_scaled,
                stencil,
                dummy_scan,
                res_j,
            )

        if (
            self.params.fixed_scale <= 0
            and not self._scale_frozen_host
        ):
            # unknown-scale regime: precompile the K-bucket multi path
            # for the CURRENT population
            fast = self._fast_mode(res)
            if fast is not None and fast[3] == "multi":
                _, mo_m, _, _, slots, levels, bmi, _kp = fast
                for m in modes:
                    self._get_multi_fn(m, bmi, mo_m)(
                        self.state,
                        self._get_pyramid_maps(levels),
                        map_size_scaled,
                        stencil,
                        dummy_scan,
                        res_j,
                        jnp.asarray(slots, jnp.float32),
                    )
            return
        mo = cs.pick_crop_size(
            scale * res, range_bins, cs.MO_BUCKETS_CONV
        )
        if mo is not None:
            dr, dc = cs.conv_dims(mo)
            pm = self._get_padded_maps()
            regs = [
                r for r in regions
                if r + dr - 1 <= pm.hp and r + dc - 1 <= pm.wp
            ]
            for mode in modes:
                for region in regs:
                    for ww in windows if mode == "tracked" else (100,):
                        warm(
                            self._get_fast_fn(mode, mo, "conv", region, ww)
                        )
        # crop / mip-crop variant for the same operating point (the
        # spread-cloud regime the dispatch falls to before convergence)
        mip = 1
        mo_crop = cs.pick_crop_size(
            scale * res, range_bins, crop.MO_BUCKETS
        )
        if mo_crop is None:
            for mip in (2, 4, 8, 16, 32):
                mo_crop = cs.pick_crop_size(
                    scale * res / mip, range_bins, crop.MO_BUCKETS
                )
                if mo_crop is not None:
                    break
        if mo_crop is not None:
            for mode in modes:
                warm(
                    self._get_fast_fn(
                        mode, mo_crop, "crop", 0, self.theta_bins, mip
                    ),
                    mip,
                )

    def _get_sharded_fast_fn(
        self, mode: str, mo: int, region: int, window_w: int,
        use_s2d: bool = True,
    ):
        pm = self._get_padded_maps()
        key = (mode, mo, region, window_w, use_s2d, self._map_version)
        if key not in self._sharded_fns:
            from top_down_renderer_tpu.parallel.sharding import (
                make_sharded_step_fast,
            )

            self._sharded_fns[key] = make_sharded_step_fast(
                self.mesh,
                self.params,
                num_classes=self.map.grid.num_classes,
                map_resolution=self.map.resolution,
                theta_bins=self.theta_bins,
                n_max=self.n_max,
                mode=mode,
                mo=mo,
                region=region,
                window_w=window_w,
                map_pad=pm.pad,
                map_hp=pm.hp,
                map_wp=pm.wp,
                gmm_every=self.gmm_every,
                use_s2d=use_s2d,
            )
        return self._sharded_fns[key]

    def _get_sharded_multi_fn(self, mode: str, bmi, mo: int):
        key = ("multi", mode, len(bmi), bmi, mo)
        if key not in self._sharded_fns:
            from top_down_renderer_tpu.parallel.sharding import (
                make_sharded_step_multi,
            )

            self._sharded_fns[key] = make_sharded_step_multi(
                self.mesh,
                self.params,
                num_classes=self.map.grid.num_classes,
                map_resolution=self.map.resolution,
                theta_bins=self.theta_bins,
                n_max=self.n_max,
                mode=mode,
                bucket_mip_idx=bmi,
                mo=mo,
                gmm_every=self.gmm_every,
            )
        return self._sharded_fns[key]

    def _update_sharded(self, scan, res_j, map_size_scaled, stencil):
        """Mesh-mode step: fused propagate + update on the sharded state.
        Conv-eligible dispatches run the row-sharded cost field; multi
        (unknown-scale) dispatches run the crop scorer on each device's
        local particle shard; everything else falls back to the sharded
        exact-gather step.

        Dispatch runs BEFORE the motion pop: the multi path applies the
        deferred propagate eagerly (slot clustering needs post-diffusion
        scales), after which _pop_motion returns the zero/gate-0 motion
        whose fused propagate is a no-op (last_dist preserved,
        particles.propagate)."""
        from top_down_renderer_tpu.filter import conv_score as cs

        fast = self._fast_mode(float(res_j))
        motion_j = jnp.asarray(self._pop_motion())
        if fast is not None and fast[3] == "multi":
            mode, mo_m, _, _, slots, levels, bmi, _kp = fast
            self.dispatch_counts["multi"] += 1
            self.state = self._get_sharded_multi_fn(mode, bmi, mo_m)(
                self.state,
                self._get_pyramid_maps(levels),
                map_size_scaled,
                stencil,
                scan,
                res_j,
                jnp.asarray(slots, jnp.float32),
            )
            return
        if fast is not None and fast[3] == "conv":
            mode, mo, _scale, _path, region, s0, ww, _mip = fast
            s_out = {
                "tracked": 2 * ww + 1,
                "init": 2 * self.params.num_rot_search + 1,
                # mixed rides one conv with both column sets
                "mixed": 2 * ww + 2 * self.params.num_rot_search + 2,
            }[mode]
            dr, dc = cs.conv_dims(mo)
            k4_bytes = (
                16 * s_out * cs.s2d_extent(dr) * cs.s2d_extent(dc)
                * 128 * 2
            )
            use_s2d = k4_bytes <= cs.K4_MAX_BYTES
            n_dev = int(self.mesh.devices.size)
            # the direct (unfolded) sharded field needs the region rows
            # to split evenly; otherwise (non-pow2 meshes) exact gather
            if use_s2d or region % n_dev == 0:
                fn = self._get_sharded_fast_fn(
                    mode, mo, region, ww, use_s2d
                )
                self.dispatch_counts["conv"] += 1
                pm = self._get_padded_maps()
                self.state = fn(
                    self.state,
                    pm.padded4d if use_s2d else pm.padded3d,
                    map_size_scaled,
                    stencil,
                    scan,
                    res_j,
                    motion_j,
                    jnp.asarray(s0, jnp.int32),
                )
                return
        self.dispatch_counts["exact"] += 1
        self.state = self._update_fn(
            self.state, self.map.grid.dist, map_size_scaled, stencil,
            scan, res_j, motion_j,
        )

    def _device_consts(self):
        """(map_size_scaled, stencil) as device arrays, cached per map
        version (no per-step host->device upload)."""
        key = self._map_version
        cached = getattr(self, "_device_consts_cache", None)
        if cached is None or cached[0] != key:
            g = self.map.grid
            mss = (
                jnp.asarray([g.width, g.height], dtype=jnp.float32)
                * self.map.resolution
            )
            cached = (key, mss, jnp.asarray(self.map.stencil))
            self._device_consts_cache = cached
        return cached[1], cached[2]

    def update(self, scan, res) -> None:
        """scan: (C, Theta, R) polar semantic render; res: range m/bin."""
        if self.state is None or self.n_active_host() == 0:
            return
        g = self.map.grid
        map_size_scaled, stencil = self._device_consts()
        scan = jnp.asarray(scan, dtype=jnp.float32)
        res_j = jnp.asarray(res, dtype=jnp.float32)
        if self.mesh is not None:
            self._update_sharded(scan, res_j, map_size_scaled, stencil)
            self._all_have_init = True
            self._last_omega = 0.0
            self._last_dist_m = 0.0
            self._prefetch_dispatch_state()
            return
        fast = self._fast_mode(float(res))
        if fast is not None and fast[3] == "multi":
            mode, mo_m, _, _, slots, levels, bmi, _kp = fast
            self.dispatch_counts["multi"] += 1
            self._apply_pending_motion()
            out = self._get_multi_fn(mode, bmi, mo_m)(
                self.state,
                self._get_pyramid_maps(levels),
                map_size_scaled,
                stencil,
                scan,
                res_j,
                jnp.asarray(slots, jnp.float32),
            )
        elif fast is not None:
            mode, mo, _scale, path, region, s0, ww, mip = fast
            self.dispatch_counts[
                path if mip == 1 else f"{path}-mip{mip}"
            ] += 1
            # the deferred propagate rides the same dispatch as
            # scoring + tail
            out = self._get_fast_fn(
                mode, mo, path, region, ww, mip
            )(
                self.state,
                self._get_padded_maps(mip),
                map_size_scaled,
                stencil,
                scan,
                res_j,
                s0=s0,
                motion=jnp.asarray(self._pop_motion()),
            )
        else:
            self.dispatch_counts["exact"] += 1
            self._apply_pending_motion()
            out = self._update_fn(
                self.state, g.dist, map_size_scaled, stencil, scan, res_j
            )
        # fast steps return the host snapshot from their own dispatch
        snap_vec = None
        if isinstance(out, tuple):
            out, snap_vec = out
        self.state = out
        # every scoring path sets have_init=True for all particles
        self._all_have_init = True
        self._last_omega = 0.0
        self._last_dist_m = 0.0
        self._prefetch_dispatch_state(snap_vec)

    def _prefetch_dispatch_state(self, snap_vec=None) -> None:
        """Dispatch + async-prefetch ONE packed vector holding every
        tiny value the next step's dispatch and the node's publish read
        (bbox, n_active, ml, cov, smask): each eager device read waits
        for the device on its own, so five separate reads per scan
        serialize the node loop.  One pack + one transfer per step
        (the fused fast step returns the vector from its own dispatch,
        passed in as snap_vec); consumers go through _host_snapshot
        (one blocking wait, then a host-cache read)."""
        st = self.state
        try:
            vec = (
                snap_vec if snap_vec is not None
                else _pack_host_snapshot(st)
            )
            vec.copy_to_host_async()
            self._snap_pending = [st, vec, None]
            if self.params.fixed_scale <= 0:
                # the multi-path clustering needs the full scale vector
                st.particles.scale.copy_to_host_async()
        except (AttributeError, TypeError):
            self._snap_pending = None  # non-jax arrays (test stubs)

    def _host_snapshot(self) -> np.ndarray:
        """Host copy of the packed per-step snapshot (see
        _prefetch_dispatch_state); layout _SNAP_*.  At most one blocking
        device fetch per step."""
        pend = getattr(self, "_snap_pending", None)
        if pend is not None and pend[0] is self.state:
            if pend[2] is None:
                pend[2] = np.asarray(pend[1])
                self._snap_last_host = pend[2]
            return pend[2]
        st = self.state
        vec = _pack_host_snapshot(st)
        out = np.asarray(vec)
        self._snap_pending = [st, vec, out]
        self._snap_last_host = out
        return out

    def _host_snapshot_nowait(self):
        """The freshest COMPLETED snapshot without blocking: the
        in-flight step's vector if its transfer already landed, else
        the previous step's host copy (None before the first fetch).
        Consumers accept one step of staleness in exchange for not
        waiting on the in-flight step."""
        pend = getattr(self, "_snap_pending", None)
        if pend is not None and pend[0] is self.state:
            if pend[2] is not None:
                return pend[2]
            try:
                ready = pend[1].is_ready()
            except AttributeError:
                ready = True
            if ready:
                pend[2] = np.asarray(pend[1])
                self._snap_last_host = pend[2]
                return pend[2]
        return getattr(self, "_snap_last_host", None)

    def pose_stats_nowait(self):
        """(ml, cov) from the freshest completed snapshot, or None if
        nothing has completed yet (see _host_snapshot_nowait)."""
        snap = self._host_snapshot_nowait()
        if snap is None:
            return None
        return (
            snap[_SNAP_ML].astype(np.float64),
            snap[_SNAP_COV].reshape(4, 4).astype(np.float64),
        )

    def publish_stats(self, block: bool = True):
        """(ml, cov, n_active) for the node's publish path from ONE
        snapshot read.  block=False returns the freshest COMPLETED
        snapshot (<= one step stale) instead of waiting for the
        in-flight step; None if nothing has completed yet."""
        snap = (
            self._host_snapshot() if block
            else self._host_snapshot_nowait()
        )
        if snap is None:
            return None
        return (
            snap[_SNAP_ML].astype(np.float64),
            snap[_SNAP_COV].reshape(4, 4).astype(np.float64),
            int(snap[_SNAP_NACT]),
        )

    def n_active_host(self) -> int:
        return int(self._host_snapshot()[_SNAP_NACT])

    # -- queries (particle_filter.h:29-41) -----------------------------
    def mean_likelihood(self) -> np.ndarray:
        return np.asarray(
            stats_mod.mean_likelihood(
                self.state.particles, self.state.n_active
            )
        )

    def compute_mean_cov(self) -> np.ndarray:
        return np.asarray(
            stats_mod.compute_mean_cov(
                self.state.particles, self.state.n_active
            )
        )

    def pose_stats(self):
        """(mean_likelihood (4,), mean_cov (4,4)) for the node's
        per-publish pair; normally pre-dispatched + host-prefetched by
        _prefetch_dispatch_state so this is a host-cache read."""
        snap = self._host_snapshot()
        return (
            snap[_SNAP_ML].astype(np.float64),
            snap[_SNAP_COV].reshape(4, 4).astype(np.float64),
        )

    def max_likelihood(self) -> np.ndarray:
        return np.asarray(self.state.ml_state)

    def compute_cov(self) -> np.ndarray:
        return np.asarray(
            stats_mod.compute_cov(
                self.state.particles,
                self.state.ml_state,
                self.state.n_active,
            )
        )

    def get_gmm(self):
        g = self.state.gmm
        k = int(g.k)
        return np.asarray(g.means)[:k], np.asarray(g.covs)[:k]

    def freeze_scale(self) -> None:
        """Geometric-mean scale lock (particle_filter.cpp:343-357)."""
        if self.state is None or self._scale_frozen_host:
            return
        p = self.state.particles
        m = np.asarray(p.alive, dtype=np.float64)
        logs = np.where(
            m > 0, np.log(np.maximum(np.asarray(p.scale), 1e-30)), 0.0
        )
        geo_mean = float(np.exp(logs.sum() / max(m.sum(), 1.0)))
        self.state = self.state.replace(
            particles=p.replace(
                scale=jnp.full_like(p.scale, geo_mean)
            ),
            scale_frozen=jnp.asarray(True),
            frozen_scale=jnp.asarray(geo_mean, dtype=jnp.float32),
        )
        self._scale_frozen_host = True
        self._frozen_scale_cache = geo_mean
        print(f"[tdr] scale converged and locked to {geo_mean}")

    @property
    def is_scale_frozen(self) -> bool:
        return self._scale_frozen_host if self.state else False

    def scale(self) -> float:
        """particle_filter.cpp:359-367."""
        if self.params.fixed_scale > 0:
            return self.params.fixed_scale
        if self.state is not None and self._scale_frozen_host:
            return self._frozen_scale_cache
        return -1.0

    def num_particles(self) -> int:
        return self.n_active_host() if self.state is not None else 0

    # -- dynamic map (particle_filter.cpp:320-341) ---------------------
    def update_map(self, ind_img, map_center) -> None:
        self.map.update_map(ind_img, map_center)
        self._map_version += 1
        self._maps_cache.clear()
        self._pyramid_cache.clear()
        delta = np.asarray(map_center) - self._last_map_center
        if self.state is not None:
            p = self.state.particles
            self.state = self.state.replace(
                particles=p.replace(
                    init_px=p.init_px
                    + jnp.asarray(delta, dtype=jnp.float32)[None, :]
                )
            )
        self._last_map_center = np.asarray(map_center, dtype=np.int64)
        if self.state is None or int(self.state.n_active) == 0:
            self.initialize_particles()
