"""Batched heightfield queries (counterpart of
clap_tpu/physics/heightfield.py; reference: core/terrain.c:336-379).

Heightfield layout: ``H[x, z]`` (nr_v, nr_v) float32, matching the host
generator (scene/terrain.py). The JAX package selects corner heights with
one-hot matmuls (a TPU gather workaround); here every query is plain
tensor indexing, which selects the same values exactly. All query
functions broadcast over arbitrary batch shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class Heightfield(NamedTuple):
    """Static per-scene terrain data (shared by every env)."""

    heights: torch.Tensor      # (nr_v, nr_v) [x][z]
    cells: torch.Tensor        # ((nr_v-1)², 4) packed corner heights
    normals: torch.Tensor      # (nr_v, nr_v, 3) grid normals
    origin: torch.Tensor       # (2,) [x0, z0]
    side: torch.Tensor         # () scalar


SWEEP_PATCH = 8    # corner patch for swept queries
CONTACT_PATCH = 4  # per-body patch


def _pack_cells(heights: torch.Tensor) -> torch.Tensor:
    h00 = heights[:-1, :-1]
    h10 = heights[1:, :-1]
    h01 = heights[:-1, 1:]
    h11 = heights[1:, 1:]
    return torch.stack([h00, h10, h01, h11], dim=-1).reshape(-1, 4)


def make_heightfield(heights, normals, origin, side, device=None) -> Heightfield:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    heights = f32(heights)
    return Heightfield(heights=heights, cells=_pack_cells(heights),
                       normals=f32(normals), origin=f32(origin),
                       side=f32(side))


def heightfield_from_terrain(t, device=None) -> Heightfield:
    """Upload a host Terrain (scene/terrain.py) as device tensors."""
    return make_heightfield(t.heights, t.normals_grid, [t.x, t.z], t.side,
                            device=device)


def _grid_of(hf: Heightfield, x, z):
    n = hf.heights.shape[0]
    square = hf.side / (n - 1)
    tx = x - hf.origin[0]
    tz = z - hf.origin[1]
    gx = torch.floor(tx / square).to(torch.int32)
    gz = torch.floor(tz / square).to(torch.int32)
    return n, square, tx, tz, gx, gz


def _cell_query(hf: Heightfield, x, z):
    """Corner heights of the cell under (x, z).

    Returns (h00, h10, h01, h11, xoff, zoff, inside, square)."""
    n, square, tx, tz, gx, gz = _grid_of(hf, x, z)
    inside = (tx >= 0) & (tx <= hf.side) & (tz >= 0) & (tz <= hf.side)
    xoff = (tx - square * gx) / square
    zoff = (tz - square * gz) / square
    gx = torch.clamp(gx, 0, n - 2).long()
    gz = torch.clamp(gz, 0, n - 2).long()
    H = hf.heights
    return (H[gx, gz], H[gx + 1, gz], H[gx, gz + 1], H[gx + 1, gz + 1],
            xoff, zoff, inside, square)


def _plane(h00, h10, h01, h11, xoff, zoff, square):
    lower = xoff <= 1 - zoff
    h = torch.where(lower,
                    h00 + (h10 - h00) * xoff + (h01 - h00) * zoff,
                    h10 + (h11 - h10) * zoff + (h01 - h11) * (1 - xoff))
    nx = torch.where(lower, -(h10 - h00), -(h11 - h01))
    nz = torch.where(lower, -(h01 - h00), -(h11 - h10))
    ny = square.expand(nx.shape)
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz)
    normal = torch.stack([nx * inv, ny * inv, nz * inv], dim=-1)
    return normal, h


def hf_height(hf: Heightfield, x, z):
    """terrain_height (terrain.c:336-379): triangle-exact barycentric
    interpolation, 0 outside the terrain bounds."""
    h00, h10, h01, h11, xoff, zoff, inside, _ = _cell_query(hf, x, z)
    h_lower = h00 + (h10 - h00) * xoff + (h01 - h00) * zoff
    h_upper = h10 + (h11 - h10) * zoff + (h01 - h11) * (1 - xoff)
    h = torch.where(xoff <= 1 - zoff, h_lower, h_upper)
    return torch.where(inside, h, 0.0)


def hf_face_plane(hf: Heightfield, x, z):
    """Plane of the exact triangle under (x, z): (normal (...,3),
    height (...,), inside (...))."""
    h00, h10, h01, h11, xoff, zoff, inside, square = _cell_query(hf, x, z)
    normal, h = _plane(h00, h10, h01, h11, xoff, zoff, square)
    return normal, h, inside


def hf_patch(hf: Heightfield, x, z, p: int):
    """The p×p corner-height patch around the cell of (x, z):
    heights[gx0:gx0+p, gz0:gz0+p] for every query in the batch.

    Returns (patch (..., p, p), gx0 (...), gz0 (...))."""
    n, _square, _tx, _tz, gx, gz = _grid_of(hf, x, z)
    gx0 = torch.clamp(gx - (p // 2 - 1), 0, n - p)
    gz0 = torch.clamp(gz - (p // 2 - 1), 0, n - p)
    k = torch.arange(p, device=gx.device)
    ix = (gx0.long()[..., None, None] + k[:, None])
    iz = (gz0.long()[..., None, None] + k[None, :])
    return hf.heights[ix, iz], gx0, gz0


def hf_face_plane_patch(hf: Heightfield, patch, gx0, gz0, x, z):
    """hf_face_plane evaluated from a pre-extracted patch.

    ``patch`` is (P..., p, p) with gx0/gz0 (P...); x/z are (P..., X...):
    they may carry extra trailing batch dims relative to the patch.
    Sample cells outside the patch clamp to its edge."""
    n, square, tx, tz, gx, gz = _grid_of(hf, x, z)
    p = patch.shape[-1]
    inside = (tx >= 0) & (tx <= hf.side) & (tz >= 0) & (tz <= hf.side)
    xoff = (tx - square * gx) / square
    zoff = (tz - square * gz) / square
    extra = x.dim() - gx0.dim()
    pad = (1,) * extra
    gx0b = gx0.reshape(gx0.shape + pad)
    gz0b = gz0.reshape(gz0.shape + pad)
    lx = torch.clamp(gx - gx0b, 0, p - 2).long()
    lz = torch.clamp(gz - gz0b, 0, p - 2).long()
    flat = patch.reshape(patch.shape[:-2] + pad + (p * p,)).expand(
        x.shape + (p * p,))
    i00 = (lx * p + lz)[..., None]
    pick = torch.gather(flat, -1, torch.cat(
        [i00, i00 + p, i00 + 1, i00 + p + 1], dim=-1))
    h00, h10, h01, h11 = (pick[..., i] for i in range(4))
    normal, h = _plane(h00, h10, h01, h11, xoff, zoff, square)
    return normal, h, inside


def hf_normal(hf: Heightfield, x, z):
    """terrain_normal (terrain.c:316-324): the grid normal of the cell
    under (x, z), clamped to the grid (not interpolated — the reference's
    gameplay query)."""
    n = hf.heights.shape[0]
    square = hf.side / (n - 1)
    gx = torch.clamp(torch.floor((x - hf.origin[0]) / square).to(torch.int32),
                     0, n - 1)
    gz = torch.clamp(torch.floor((z - hf.origin[1]) / square).to(torch.int32),
                     0, n - 1)
    return hf.normals[gx.long(), gz.long()]


def hf_face_normal(hf: Heightfield, x, z):
    """Exact normal of the triangle under (x, z)."""
    return hf_face_plane(hf, x, z)[0]
