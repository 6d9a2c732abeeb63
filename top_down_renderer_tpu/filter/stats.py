"""Posterior statistics over the particle set.

Parity ports of ParticleFilter::{meanLikelihood, computeMeanCov,
computeCov} (/root/reference/src/particle_filter.cpp:191-236): unweighted
averages over the (alive) particle set, with circular handling of theta.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from top_down_renderer_tpu.core.grids import Particles
from top_down_renderer_tpu.core.geometry import wrap_angle

# These run once per published pose; jitted so they are one dispatch
# each instead of op-by-op eager execution.


@jax.jit
def mean_likelihood(
    particles: Particles, n_active: jnp.ndarray
) -> jnp.ndarray:
    """(4,) mean of mlState over alive particles; theta is the circular
    mean atan2(mean sin, mean cos) (particle_filter.cpp:191-203)."""
    ml = particles.ml_state()  # (N, 4)
    m = particles.alive.astype(jnp.float32)
    cnt = jnp.maximum(n_active.astype(jnp.float32), 1.0)
    mean = jnp.sum(ml * m[:, None], axis=0) / cnt
    cos_s = jnp.sum(jnp.cos(ml[:, 2]) * m) / cnt
    sin_s = jnp.sum(jnp.sin(ml[:, 2]) * m) / cnt
    return mean.at[2].set(jnp.arctan2(sin_s, cos_s))


def _cov_around(
    particles: Particles, center: jnp.ndarray, n_active: jnp.ndarray
) -> jnp.ndarray:
    ml = particles.ml_state()
    d = ml - center[None, :]
    d = d.at[:, 2].set(wrap_angle(d[:, 2]))
    m = particles.alive.astype(jnp.float32)
    d = d * m[:, None]
    cov = d.T @ d
    return cov / jnp.maximum(n_active.astype(jnp.float32) - 1.0, 1.0)


@jax.jit
def compute_mean_cov(
    particles: Particles, n_active: jnp.ndarray
) -> jnp.ndarray:
    """4x4 covariance about the mean-likelihood state
    (particle_filter.cpp:205-220)."""
    return _cov_around(particles, mean_likelihood(particles, n_active),
                       n_active)


@jax.jit
def pose_stats(
    particles: Particles, n_active: jnp.ndarray
):
    """(mean_likelihood (4,), mean_cov (4,4)) in ONE dispatch - the
    per-publish pair the node reads every scan."""
    mean = mean_likelihood(particles, n_active)
    return mean, _cov_around(particles, mean, n_active)


@jax.jit
def compute_cov(
    particles: Particles, ml_state: jnp.ndarray, n_active: jnp.ndarray
) -> jnp.ndarray:
    """4x4 covariance about the max-likelihood particle state (captured
    pre-resample, like the reference's surviving pointer;
    particle_filter.cpp:144-149, 226-236)."""
    return _cov_around(particles, ml_state, n_active)
