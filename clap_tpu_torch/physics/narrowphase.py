"""Batched narrowphase: capsule/ray vs heightfield + triangle soup
(counterpart of clap_tpu/physics/narrowphase.py).

Contact convention: ``normal`` points from the obstacle toward the body
(the push-out direction); ``depth > 0`` means penetration. Every function
takes queries with arbitrary leading batch dims (envs, bodies, probes).
The static triangle soup is shared by all envs, ``(T, 3, 3)``, or per env,
``(B, T, 3, 3)``, when collision follows its entity (the env axis then
leads the queries' batch dims); its validity mask may be per env,
``(B, T)``, when collision follows entity visibility.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from .heightfield import (CONTACT_PATCH, Heightfield, hf_face_normal,
                          hf_face_plane_patch, hf_height, hf_patch)
from .shapes import capsule_triangle_contact, ray_triangle

INF = float("inf")
HF_NEIGH = 2  # heightfield cells on each side of the capsule cell


class StaticWorld(NamedTuple):
    """Per-scene static collision geometry (shared across all envs)."""

    hf: Heightfield
    tris: torch.Tensor       # (T, 3, 3) world-space static triangles,
                             # or (B, T, 3, 3) per env
    tri_valid: torch.Tensor  # (T,) bool, or (B, T) per env
    tri_entity: torch.Tensor = None  # (T,) int32 owning entity per triangle
    hf_entity: torch.Tensor = None   # () int32 terrain's entity id


def make_world(hf: Heightfield, tris=None, tri_valid=None,
               tri_entity=None, hf_entity: int = 0) -> StaticWorld:
    """Build a StaticWorld on the heightfield's device; pads the trimesh
    soup so T >= 1."""
    dev = hf.heights.device
    if tris is None or len(tris) == 0:
        tris = torch.zeros((1, 3, 3), dtype=torch.float32, device=dev)
        tri_valid = torch.zeros((1,), dtype=torch.bool, device=dev)
        tri_entity = torch.full((1,), -1, dtype=torch.int32, device=dev)
    else:
        tris = torch.as_tensor(np.asarray(tris, np.float32), device=dev)
        T = tris.shape[0]
        tri_valid = torch.ones(T, dtype=torch.bool, device=dev) \
            if tri_valid is None else torch.as_tensor(tri_valid, device=dev)
        tri_entity = torch.zeros(T, dtype=torch.int32, device=dev) \
            if tri_entity is None else torch.as_tensor(
                np.asarray(tri_entity, np.int32), device=dev)
    return StaticWorld(hf=hf, tris=tris, tri_valid=tri_valid,
                       tri_entity=tri_entity,
                       hf_entity=torch.tensor(hf_entity, dtype=torch.int32,
                                              device=dev))


class Contacts(NamedTuple):
    """Fixed-capacity contact set (slots on the last axis)."""

    depth: torch.Tensor    # (..., C) penetration depth; <=0 → no contact
    normal: torch.Tensor   # (..., C, 3) obstacle → body
    point: torch.Tensor    # (..., C, 3) on obstacle surface
    valid: torch.Tensor    # (..., C) bool


_HF_SAMPLE_OFFS = (
    (0.0, 0.0),
    (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0),
    (0.707, 0.707), (0.707, -0.707), (-0.707, 0.707), (-0.707, -0.707),
)


def _tri_valid_for(world: StaticWorld, batch_shape):
    """tri_valid broadcast against queries of ``batch_shape``: a per-env
    (B, T) mask aligns with the leading env axis."""
    tv = world.tri_valid
    if tv.dim() == 1:
        return tv
    return tv.reshape(tv.shape[:1] + (1,) * (len(batch_shape) - 1)
                      + tv.shape[1:])


def _tris_for(world: StaticWorld, batch_shape):
    """The triangle soup broadcast against queries of ``batch_shape``:
    (T, 3, 3) as it is, per-env (B, T, 3, 3) as (B, 1, ..., T, 3, 3)
    aligned with the leading env axis."""
    t = world.tris
    if t.dim() == 3:
        return t
    return t.reshape(t.shape[:1] + (1,) * (len(batch_shape) - 1)
                     + t.shape[1:])


def hf_capsule_contacts(hf: Heightfield, p_bot, p_top, r, n_samples: int = 9,
                        patch=None, two_ended: bool = False):
    """Analytic capsule-vs-heightfield contacts: the exact face plane under
    ``n_samples`` points around the capsule axis, one plane contact each
    (×3 ends when ``two_ended``). p_bot/p_top (..., 3), r (...).

    ``patch``: optional (patch, gx0, gz0) from hf_patch whose batch dims
    are the query's leading dims (it may cover fewer trailing dims)."""
    offs = mx.const(_HF_SAMPLE_OFFS[:n_samples], p_bot.device)   # (S, 2)
    r = torch.as_tensor(r, dtype=torch.float32, device=p_bot.device)
    rs = r[..., None]
    if two_ended:
        ends = torch.stack([p_bot, 0.5 * (p_bot + p_top), p_top],
                           dim=-2)                            # (..., 3, 3)
        sx = (ends[..., :, None, 0] + offs[:, 0] * rs[..., None]).flatten(-2)
        sz = (ends[..., :, None, 2] + offs[:, 1] * rs[..., None]).flatten(-2)
        seg_pt = ends.repeat_interleave(n_samples, dim=-2)   # (..., 3S, 3)
    else:
        sx = p_bot[..., 0:1] + offs[:, 0] * rs
        sz = p_bot[..., 2:3] + offs[:, 1] * rs
        seg_pt = None
    if patch is None:
        mid = 0.5 * (p_bot + p_top)
        patch = hf_patch(hf, mid[..., 0], mid[..., 2],
                         8 if two_ended else CONTACT_PATCH)
    normal, h, inside = hf_face_plane_patch(hf, *patch, sx, sz)
    plane_pt = torch.stack([sx, h, sz], dim=-1)
    if seg_pt is None:
        seg_pt = torch.where(normal[..., 1:2] >= 0, p_bot[..., None, :],
                             p_top[..., None, :])
    dist = torch.sum(normal * (seg_pt - plane_pt), dim=-1)
    depth = torch.where(inside, rs - dist, -INF)
    point = seg_pt - normal * dist[..., None]
    return depth, normal, point, inside & (depth > 0)


def capsule_world_contacts(world: StaticWorld, p_bot, p_top, r,
                           n_samples: int = 9, patch=None,
                           two_ended: bool = False) -> Contacts:
    """All static-world contacts of capsules (segment p_bot→p_top,
    radius r): analytic heightfield planes + exact trimesh triangles.
    Slots: n_samples (×3 when two_ended) heightfield + T trimesh."""
    hd, hn, hp, hv = hf_capsule_contacts(world.hf, p_bot, p_top, r,
                                         n_samples, patch, two_ended)
    t = _tris_for(world, p_bot.shape[:-1])
    r = torch.as_tensor(r, dtype=torch.float32, device=p_bot.device)
    depth, normal, point = capsule_triangle_contact(
        p_bot[..., None, :], p_top[..., None, :], r[..., None],
        t[..., 0, :], t[..., 1, :], t[..., 2, :])
    tv = _tri_valid_for(world, p_bot.shape[:-1])
    depth = torch.where(tv, depth, -INF)
    valid = tv & (depth > 0)
    normal = normal.expand(depth.shape + (3,))
    point = point.expand(depth.shape + (3,))
    return Contacts(
        depth=torch.cat([hd, depth], dim=-1),
        normal=torch.cat([hn, normal], dim=-2),
        point=torch.cat([hp, point], dim=-2),
        valid=torch.cat([hv, valid.expand(depth.shape)], dim=-1),
    )


def sphere_world_contacts(world: StaticWorld, center, r,
                          neigh: int = HF_NEIGH) -> Contacts:
    """Sphere = zero-length capsule. As in the JAX package, ``neigh`` is
    passed on as capsule_world_contacts's ``n_samples``."""
    return capsule_world_contacts(world, center, center, r, neigh)


def deepest_contact(c: Contacts):
    """(depth, normal, point, any_valid) of the deepest valid contact of
    each query (the first slot where several tie)."""
    d = torch.where(c.valid, c.depth, -INF)
    i = torch.argmax(d, dim=-1, keepdim=True)
    i3 = i[..., None].expand(*i.shape, 3)
    return (c.depth.gather(-1, i)[..., 0], c.normal.gather(-2, i3)[..., 0, :],
            c.point.gather(-2, i3)[..., 0, :], c.valid.gather(-1, i)[..., 0])


# ---------------------------------------------------------------------------
# ray casts (replaces __phys_ray_cast, physics.c:473-540)
# ---------------------------------------------------------------------------

def _hf_inside(hf: Heightfield, x, z):
    tx = x - hf.origin[0]
    tz = z - hf.origin[1]
    return (tx >= 0) & (tx <= hf.side) & (tz >= 0) & (tz <= hf.side)


def raycast_down(world: StaticWorld, origin, max_dist):
    """Vertical downward ray — the ground_collide query
    (physics.c:718-727). origin (..., 3).

    Returns (dist, normal, hit, entity); dist = max_dist and entity = -1
    when nothing hit."""
    x, y, z = origin[..., 0], origin[..., 1], origin[..., 2]
    h = hf_height(world.hf, x, z)
    hf_dist = y - h
    hf_ok = (hf_dist >= 0) & (hf_dist <= max_dist) & _hf_inside(world.hf, x, z)
    hf_n = hf_face_normal(world.hf, x, z)

    direc = mx.const([0.0, -1.0, 0.0], origin.device)
    tris = _tris_for(world, origin.shape[:-1])
    t, hit = ray_triangle(origin[..., None, :], direc, tris[..., 0, :],
                          tris[..., 1, :], tris[..., 2, :])
    max_dist = torch.as_tensor(max_dist, dtype=torch.float32,
                               device=origin.device)
    tv = _tri_valid_for(world, origin.shape[:-1])
    t = torch.where(hit & tv & (t <= max_dist[..., None]), t, INF)
    tri_dist = torch.amin(t, dim=-1)
    # winner: first triangle at the minimum distance
    first = torch.argmax((t == tri_dist[..., None]).int(), dim=-1)
    if tris.dim() == 3:
        tri = tris[first]                                     # (..., 3, 3)
    else:
        env = torch.arange(first.shape[0], device=first.device).reshape(
            (-1,) + (1,) * (first.dim() - 1))
        tri = world.tris[env, first]
    tn = torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                            tri[..., 2, :] - tri[..., 0, :], dim=-1)
    tn = tn / torch.clamp(torch.linalg.vector_norm(tn, dim=-1, keepdim=True),
                          min=1e-12)
    tri_ent = world.tri_entity[first]

    hf_d = torch.where(hf_ok, hf_dist, INF)
    use_hf = hf_d <= tri_dist
    dist = torch.minimum(torch.minimum(hf_d, tri_dist), max_dist)
    hit_any = torch.isfinite(torch.minimum(hf_d, tri_dist))
    normal = torch.where(use_hf[..., None], hf_n, tn)
    entity = torch.where(hit_any,
                         torch.where(use_hf, world.hf_entity, tri_ent),
                         torch.full_like(tri_ent, -1))
    return torch.where(hit_any, dist, max_dist), normal, hit_any, entity


def raycast(world: StaticWorld, origin, direction, max_dist,
            n_march: int = 16):
    """General ray vs world: trimesh exact; heightfield by fixed-step
    marching + 8 bisection halvings (camera occlusion quality,
    camera.c:93-117). origin/direction (..., 3), max_dist (...).

    Returns (dist, hit_any)."""
    direc = direction / torch.clamp(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), min=1e-12)
    tris = _tris_for(world, origin.shape[:-1])
    t, hit = ray_triangle(origin[..., None, :], direc[..., None, :],
                          tris[..., 0, :], tris[..., 1, :], tris[..., 2, :])
    t = torch.where(hit & _tri_valid_for(world, origin.shape[:-1]), t, INF)
    tri_dist = torch.amin(t, dim=-1)

    s = torch.linspace(0.0, 1.0, n_march, device=origin.device)
    s = s * max_dist[..., None]                               # (..., M)
    pts = origin[..., None, :] + s[..., None] * direc[..., None, :]
    above = pts[..., 1] - hf_height(world.hf, pts[..., 0], pts[..., 2])
    inside = _hf_inside(world.hf, pts[..., 0], pts[..., 2])
    below = (above < 0) & inside
    first = torch.argmax(below.int(), dim=-1, keepdim=True)
    any_below = torch.any(below, dim=-1)
    lo = torch.gather(s, -1, torch.clamp(first - 1, min=0))[..., 0]
    hi = torch.gather(s, -1, first)[..., 0]
    for _ in range(8):
        mid = 0.5 * (lo + hi)
        p = origin + mid[..., None] * direc
        under = p[..., 1] - hf_height(world.hf, p[..., 0], p[..., 2]) < 0
        lo, hi = torch.where(under, lo, mid), torch.where(under, mid, hi)
    hf_dist = torch.where(any_below, hi, INF)

    dist = torch.minimum(tri_dist, hf_dist)
    hit_any = torch.isfinite(dist)
    return torch.where(hit_any, dist, max_dist), hit_any
