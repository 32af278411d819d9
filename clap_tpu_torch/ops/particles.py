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
- billboarding transposes the view rotation at render time
  (particle.c:93-100): ``billboard_matrix``; ``particle_clip_quads`` makes
  the camera-facing quads of the instanced draw as a triangle stream

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


def billboard_matrix(view):
    """Camera-facing model rotation (particle.c:93-100): the transpose of
    the view rotation in a 4×4, for view (..., 4, 4)."""
    m = torch.eye(4, dtype=view.dtype, device=view.device).expand(
        view.shape).clone()
    m[..., :3, :3] = view[..., :3, :3].transpose(-1, -2)
    return m


def _xform(m, v):
    """m (..., 4, 4) applied to points v (..., P[, K], 3) with w = 1, each
    row summed in pairs as the JAX package's einsum is on the CPU."""
    m = m.reshape(m.shape[:-2] + (1,) * (v.dim() - m.dim() + 1)
                  + m.shape[-2:])
    x, y, z = (v[..., i, None] for i in range(3))
    return (m[..., 0] * x + m[..., 1] * y) + (m[..., 2] * z + m[..., 3])


# quad corners in view space, in units of the size: 00, 10, 01, 11
_CORNERS = [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [-1.0, 1.0, 0.0],
            [1.0, 1.0, 0.0]]


def particle_clip_quads(pos, size, cam_view, cam_proj, active=None):
    """Camera-facing billboard quads as a clip-space triangle stream (the
    instanced particle draw, particle.c:122-125 + particle.vert): each
    particle becomes two triangles spanning ±size in view space.

    pos (B, P, 3) world positions (systems flattened); size a number,
    (P,) or (B, P); cam_view (B, 4, 4); cam_proj (4, 4) or (B, 4, 4);
    active (P,) or (B, P) bool. Returns (tri_verts (B, 6P, 4) clip
    coordinates, faces (2P, 3) int32, valid (B, 2P), owner (2P,) particle
    index)."""
    from .. import mathx as mx

    B, P = pos.shape[:2]
    dev = pos.device
    vp = _xform(cam_view, pos)[..., :3]                       # (B, P, 3)
    s = (size if torch.is_tensor(size)
         else mx.const(float(size), dev, pos.dtype)).expand(B, P)
    corners = vp[..., None, :] + mx.const(_CORNERS, dev, pos.dtype) \
        * s[..., None, None]                                  # (B, P, 4, 3)
    proj = cam_proj if cam_proj.dim() == 3 else cam_proj.expand(B, 4, 4)
    clip = _xform(proj, corners)                              # (B, P, 4, 4)
    # CCW in view space (y up): (00, 10, 01) and (10, 11, 01)
    tris = clip[:, :, mx.const([0, 1, 2, 1, 3, 2], dev, torch.long)]
    valid = torch.ones((B, P), dtype=torch.bool, device=dev) \
        if active is None else active.expand(B, P)
    owner = torch.arange(P, dtype=torch.int32,
                         device=dev).repeat_interleave(2)
    faces = torch.arange(P * 6, dtype=torch.int32, device=dev).reshape(-1, 3)
    return (tris.reshape(B, P * 6, 4), faces, valid.repeat_interleave(2, -1),
            owner)
