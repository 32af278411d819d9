"""Particle systems (counterpart of clap_tpu/ops/particles.py; reference:
core/particle.{c,h}).

Batched SoA replacement for the reference's per-particle linked lists:
one (S systems, P particles, 3) position/velocity state per env, advanced
per frame. Semantics match particle.c:

- spawn on a hollow sphere shell [min_radius, radius] around the system
  center with 4 radial distributions (u, √u, ∛u, u^0.75 —
  particle.c:36-67)
- per-frame Euler step pos += velocity; respawn when the particle leaves
  radius² (particles_update particle.c:89-120)
- PARTICLES_MAX = 1024 per system (shader_constants.h:7)

Randomness comes from a ``torch.Generator`` passed per call; the state
holds no key. ``particles_advance`` is the deterministic body, which takes
its uniform draws as arguments (the JAX package draws from jax.random keys
threaded through its state, so the two streams differ).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PARTICLES_MAX = 1024

PART_DIST_LIN = 0
PART_DIST_SQRT = 1
PART_DIST_CBRT = 2
PART_DIST_POW075 = 3


class ParticleParams(NamedTuple):
    """Static per-system config, (S,) tensors."""

    active: torch.Tensor      # bool
    radius: torch.Tensor      # f32 shell outer radius
    min_radius: torch.Tensor  # f32 shell inner radius
    velocity: torch.Tensor    # f32 velocity scale
    dist: torch.Tensor        # int32 PART_DIST_*
    count: torch.Tensor       # int32 live particles (≤ P)


class ParticleState(NamedTuple):
    pos: torch.Tensor         # (..., S, P, 3) world positions
    vel: torch.Tensor         # (..., S, P, 3)


def _radial(u, dist):
    return torch.where(
        dist == PART_DIST_SQRT, torch.sqrt(u),
        torch.where(dist == PART_DIST_CBRT, torch.pow(u, 1.0 / 3.0),
                    torch.where(dist == PART_DIST_POW075,
                                torch.pow(u, 0.75), u)))


def _spawn(d, u, center, radius, min_radius, dist):
    """Shell points from direction draws d (..., 3) in [-1, 1) and radial
    draws u (...) in [0, 1)."""
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-6)
    r = min_radius + (radius - min_radius) * _radial(u, dist)
    return center + d * r[..., None]


def particle_draws(shape, generator=None, device=None):
    """One frame's uniform draws for (..., S, P) particles: spawn
    directions and velocities in [-1, 1), radial draws in [0, 1)."""
    def uni(*s):
        return torch.rand(*s, generator=generator, device=device)

    return uni(*shape, 3) * 2 - 1, uni(*shape), uni(*shape, 3) * 2 - 1


def particles_init(params: ParticleParams, centers,
                   generator=None) -> ParticleState:
    """Spawn all systems: centers (..., S, 3) → (..., S, P, 3)."""
    d, u, v = particle_draws((*centers.shape[:-1], PARTICLES_MAX),
                             generator, centers.device)
    pos = _spawn(d, u, centers[..., None, :], params.radius[:, None],
                 params.min_radius[:, None], params.dist[:, None])
    return ParticleState(pos=pos, vel=v * params.velocity[:, None, None])


def particles_advance(params: ParticleParams, st: ParticleState, centers,
                      spawn_dir, spawn_u, spawn_vel) -> ParticleState:
    """particles_update (particle.c:89-120) with the draws given: respawn
    escapees, Euler step. centers: (..., S, 3) current system centers."""
    c = centers[..., None, :]
    d = st.pos - c
    escaped = torch.sum(d * d, -1) > (params.radius ** 2)[:, None]
    new_pos = _spawn(spawn_dir, spawn_u, c, params.radius[:, None],
                     params.min_radius[:, None], params.dist[:, None])
    new_vel = spawn_vel * params.velocity[:, None, None]
    pos = torch.where(escaped[..., None], new_pos, st.pos)
    vel = torch.where(escaped[..., None], new_vel, st.vel)
    return ParticleState(pos=pos + vel, vel=vel)


def particles_update(params: ParticleParams, st: ParticleState, centers,
                     generator=None) -> ParticleState:
    """particles_update (particle.c:89-120), drawing from ``generator``."""
    draws = particle_draws(st.pos.shape[:-1], generator, st.pos.device)
    return particles_advance(params, st, centers, *draws)
