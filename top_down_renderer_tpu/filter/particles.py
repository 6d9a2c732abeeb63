"""Particle initialization and motion propagation.

Parity ports of StateParticle's constructor and propagate
(/root/reference/src/state_particle.cpp:3-78) and
ParticleFilter::initializeParticles (/root/reference/src/particle_filter.cpp:
19-84).

Initialization runs on the host in numpy (it happens once per map, and the
reference's rejection-sample-until-on-road loop is exactly reproducible
there); propagation is a jitted per-particle kernel with counter-based RNG
replacing the reference's shared mt19937.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from top_down_renderer_tpu.config import FilterParams
from top_down_renderer_tpu.core.grids import Particles


def _sample_positions_on_road(
    rng: np.random.Generator,
    n: int,
    road_ok: np.ndarray,
    map_size_xy: np.ndarray,
    resolution: float,
    params: FilterParams,
) -> np.ndarray:
    """Vectorized rejection sampling of positions whose containing pixel
    passes the road check (state_particle.cpp:20-32)."""
    h, w = road_ok.shape
    out = np.zeros((n, 2), dtype=np.float32)
    todo = np.arange(n)
    max_rounds = 10000 if road_ok.any() else 0
    for _ in range(max_rounds):
        m = len(todo)
        if m == 0:
            break
        if params.init_pos_px_x > 0:
            cand = rng.standard_normal((m, 2)) * params.init_pos_px_cov
            cand[:, 0] += params.init_pos_px_x
            cand[:, 1] += params.init_pos_px_y
            cand[:, 0] = np.clip(cand[:, 0], 0, map_size_xy[0])
            cand[:, 1] = np.clip(cand[:, 1], 0, map_size_xy[1])
        else:
            cand = rng.random((m, 2)) * map_size_xy[None, :]
        cx = (cand[:, 0] / resolution).astype(np.int64)
        cy = (cand[:, 1] / resolution).astype(np.int64)
        ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        ok_idx = np.where(ok)[0]
        ok[ok_idx] = road_ok[cy[ok_idx], cx[ok_idx]]
        out[todo[ok]] = cand[ok]
        todo = todo[~ok]
    if len(todo):
        # no road anywhere reachable - fall back to uniform (the reference
        # would spin forever in its while(true) loop; we degrade gracefully)
        print(
            "[tdr] warning: no road found for "
            f"{len(todo)} particles; falling back to uniform init"
        )
        out[todo] = rng.random((len(todo), 2)) * map_size_xy[None, :]
    return out


def initialize_particles(
    n_max: int,
    road_ok: np.ndarray,
    map_size_xy: np.ndarray,
    resolution: float,
    params: FilterParams,
    seed: int = 0,
) -> Tuple[Particles, int]:
    """Build the initial particle set.

    Parity: particle_filter.cpp:19-84 - when scale is unknown, positions are
    sampled in groups of num_at_scale=10 sharing one prototype position and
    theta, with scales 10^{0, 0.1, ..., 0.9} (:57-70); when scale is fixed,
    every particle gets fixed_scale.

    Returns (particles, n_active).
    """
    rng = np.random.default_rng(seed)
    num_at_scale = 10 if params.fixed_scale < 0 else 1
    n_groups = n_max // num_at_scale
    n_active = n_groups * num_at_scale

    proto_pos = _sample_positions_on_road(
        rng, n_groups, road_ok, np.asarray(map_size_xy), resolution, params
    )

    if math.isfinite(params.init_pos_deg_theta):
        proto_theta = (
            rng.standard_normal(n_groups) * params.init_pos_deg_cov
            + params.init_pos_deg_theta
        ) * (math.pi / 180.0)
        have_init = True
    else:
        proto_theta = np.zeros(n_groups)
        have_init = False

    init_px = np.zeros((n_max, 2), dtype=np.float32)
    theta = np.zeros(n_max, dtype=np.float32)
    scale = np.ones(n_max, dtype=np.float32)

    idx = np.arange(n_active)
    g = idx // num_at_scale
    init_px[:n_active] = proto_pos[g]
    theta[:n_active] = proto_theta[g]
    if params.fixed_scale < 0:
        s = (idx % num_at_scale) / float(num_at_scale)
        scale[:n_active] = np.power(10.0, s)
    else:
        scale[:] = params.fixed_scale

    alive = np.zeros(n_max, dtype=bool)
    alive[:n_active] = True
    weight = np.where(alive, 1.0 / n_active, 0.0).astype(np.float32)

    particles = Particles(
        init_px=jnp.asarray(init_px),
        d_m=jnp.zeros((n_max, 2), dtype=jnp.float32),
        theta=jnp.asarray(theta),
        scale=jnp.asarray(scale),
        have_init=jnp.full((n_max,), have_init, dtype=bool),
        weight=jnp.asarray(weight),
        last_dist=jnp.zeros(n_max, dtype=jnp.float32),
        alive=jnp.asarray(alive),
    )
    return particles, n_active


def propagate(
    particles: Particles,
    key: jax.Array,
    trans: jnp.ndarray,
    omega: jnp.ndarray,
    params: FilterParams,
    scale_frozen: jnp.ndarray,
    dist=None,
    noise_gate=None,
) -> Particles:
    """Motion model (StateParticle::propagate, state_particle.cpp:57-78).

    trans: (2,) body-frame translation (m); omega: scalar yaw delta.
    Noise is scaled by the step's travel distance; scale receives
    multiplicative noise N(1, min(2/dist, 0.02)) unless frozen (:71-74).

    dist: optional override of the noise-scaling distance - the mesh
    path composes several deferred propagate() calls into one fused
    motion and passes the SUMMED per-call distance so noise magnitudes
    match per-call application.  noise_gate: optional 0/1 scalar
    multiplying the scale-noise sigma - 0 when the fused step runs with
    no user propagate() at all, so update-only mesh steps don't apply
    the dist->0 sigma floor of 0.02 that single-chip update() (which
    skips propagate entirely) never applies.
    """
    n = particles.n_max

    c, s = jnp.cos(particles.theta), jnp.sin(particles.theta)
    tg_x = c * trans[0] - s * trans[1]
    tg_y = s * trans[0] + c * trans[1]
    if dist is None:
        dist = jnp.sqrt(trans[0] ** 2 + trans[1] ** 2)

    last_pos = particles.d_m
    noise = jax.random.normal(key, (n, 4))  # one fused RNG draw
    noise_pos = noise[:, :2] * (params.pos_cov * dist)
    new_d_m = (
        particles.d_m + jnp.stack([tg_x, tg_y], axis=-1) + noise_pos
    )
    new_theta = (
        particles.theta
        + noise[:, 2] * (params.theta_cov * dist)
        + omega
    )

    scale_sigma = jnp.minimum(2.0 / jnp.maximum(dist, 1e-20), 0.02)
    if noise_gate is not None:
        scale_sigma = scale_sigma * noise_gate
    scale_noise = 1.0 + noise[:, 3] * scale_sigma
    new_scale = jnp.where(
        scale_frozen, particles.scale, particles.scale * scale_noise
    )

    last_dist = jnp.linalg.norm(last_pos - new_d_m, axis=-1)
    if noise_gate is not None:
        # gate 0 = a fused update step with NO user propagate() call:
        # keep the previous per-particle travel distance (the distance
        # regularization input, particle_filter.cpp:137-142) instead of
        # zeroing it, matching an update that skips propagate entirely
        last_dist = jnp.where(
            noise_gate > 0, last_dist, particles.last_dist
        )
    return particles.replace(
        d_m=new_d_m,
        theta=new_theta,
        scale=new_scale,
        last_dist=last_dist,
    )
