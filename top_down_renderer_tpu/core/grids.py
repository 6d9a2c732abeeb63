"""Core array types (pytrees).

Structure-of-arrays redesign of the reference's per-object state:
  - SemanticMapGrid  <- TopDownMap's class_maps_/geo_maps_/class_mask_
                        (top_down_map.h:77-79), fused into channel-last
                        device arrays so one gather reads all channels.
  - Particles        <- std::vector<shared_ptr<StateParticle>> with State
                        fields (state_particle.h:9-17), as fixed-size SoA
                        with an alive mask (fixed shapes for XLA).
  - FilterState      <- ParticleFilter's mutable members
                        (particle_filter.h:43-74), functional.

All shapes are static; "dynamic particle count" is an n_active scalar plus
masking, replacing the reference's vector resizing
(particle_filter.cpp:151-169).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from top_down_renderer_tpu.core import struct


@struct.dataclass
class SemanticMapGrid:
    """Device-resident semantic map: per-class truncated distance fields.

    dist:  (H, W, C_pad) float32/bfloat16 - truncated L2 EDT per flattened
           class, multiplied by resolution, 0 at class pixels and unknown
           cells (parity: computeDists, top_down_map.cpp:289-326).
           Channels beyond num_classes are zero padding (channel-last layout
           so one gather at (y, x) reads every class in a single vector).
    geo_dist: (H, W, 2_pad) same for the 2-channel geometric map
           (ground / elevated; getGeoRasterMap top_down_map.cpp:410-427).
    mask:  (H, W) uint8 - 1 where no class is known (unknown space),
           0 elsewhere (top_down_map.cpp:294-299,321).
    road_ok: (H, W) bool - True where getClassesAtPoint would report
           class 1 "road" (dist < 1 after EDT - includes the reference's
           unknown-cells-count-as-road quirk since dist==0 there;
           top_down_map.cpp:159-170 with state_particle.cpp:28-31).
    resolution: map scale factor (Params.resolution, always 1 in reference).
    map_center: (2,) int32 px (top_down_map.cpp:11, updateMap :146).
    num_classes: static int.
    """

    dist: jnp.ndarray
    geo_dist: jnp.ndarray
    mask: jnp.ndarray
    road_ok: jnp.ndarray
    map_center: jnp.ndarray
    resolution: float = struct.field(pytree_node=False, default=1.0)
    num_classes: int = struct.field(pytree_node=False, default=6)

    @property
    def height(self) -> int:
        return self.dist.shape[0]

    @property
    def width(self) -> int:
        return self.dist.shape[1]

    def size_px(self):
        """(width, height) in px*resolution units (TopDownMap::size scaled),
        matching `map->size().cast<float>() * map->resolution()`
        (state_particle.cpp:11)."""
        return (
            jnp.array([self.width, self.height], dtype=jnp.float32)
            * self.resolution
        )


@struct.dataclass
class Particles:
    """SoA particle state; State struct parity (state_particle.h:9-17).

    All arrays have leading dim N (static max particle count).
    """

    init_px: jnp.ndarray  # (N, 2) float32: init_x_px, init_y_px
    d_m: jnp.ndarray  # (N, 2) float32: dx_m, dy_m
    theta: jnp.ndarray  # (N,) float32
    scale: jnp.ndarray  # (N,) float32, px/m
    have_init: jnp.ndarray  # (N,) bool
    weight: jnp.ndarray  # (N,) float32 (normalized after update)
    last_dist: jnp.ndarray  # (N,) float32 (state_particle.cpp:76-77)
    alive: jnp.ndarray  # (N,) bool: index < n_active

    @property
    def n_max(self) -> int:
        return self.theta.shape[0]

    def pose_px(self) -> jnp.ndarray:
        """(N, 2) pixel-space position: init + d_m * scale
        (StateParticle::mlState, state_particle.cpp:98-102)."""
        return self.init_px + self.d_m * self.scale[:, None]

    def ml_state(self) -> jnp.ndarray:
        """(N, 4): x_px, y_px, theta, scale."""
        pose = self.pose_px()
        return jnp.stack(
            [pose[:, 0], pose[:, 1], self.theta, self.scale], axis=-1
        )


@struct.dataclass
class GMMState:
    """GMM over particle poses (ParticleFilter::computeGMM outputs).

    means: (K_max, 3) - x_px, y_px, theta  (particle_filter.cpp:307-309)
    covs:  (K_max, 3, 3) - 2x2 position cov, [2,2]=1 (:310-314)
    k:     scalar int - current number of active gaussians
    """

    means: jnp.ndarray
    covs: jnp.ndarray
    k: jnp.ndarray

    @staticmethod
    def init(k_max: int) -> "GMMState":
        covs = jnp.tile(jnp.eye(3, dtype=jnp.float32), (k_max, 1, 1))
        return GMMState(
            means=jnp.zeros((k_max, 3), dtype=jnp.float32),
            covs=covs,
            k=jnp.array(1, dtype=jnp.int32),
        )


@struct.dataclass
class FilterState:
    """Full functional filter state (ParticleFilter members,
    particle_filter.h:43-74)."""

    particles: Particles
    n_active: jnp.ndarray  # scalar int32 <- num_particles_
    scale_frozen: jnp.ndarray  # scalar bool <- scale_frozen_
    frozen_scale: jnp.ndarray  # scalar f32: the frozen/fixed scale value
    # (4,) f32 x_px, y_px, theta, scale of the max-weight particle,
    # CAPTURED BEFORE RESAMPLING <- max_likelihood_particle_: the
    # reference keeps a pointer to the old particle that survives the
    # swap (particle_filter.cpp:144-147)
    ml_state: jnp.ndarray
    gmm: GMMState
    key: Any  # jax PRNG key <- the shared mt19937 (particle_filter.cpp:4-5)
    step: jnp.ndarray  # scalar int32 step counter
    # alive-pose bounding box (min_x, min_y, max_x, max_y) px, kept on
    # device so the host dispatch reads 16 bytes instead of the cloud
    bbox: jnp.ndarray = None
    # (theta_bins,) bool: rotation shifts present among alive particles
    # (lets the conv scorer build a kernel over just the live window)
    smask: jnp.ndarray = None
