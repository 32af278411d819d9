"""Voxel content meshing (counterpart of clap_tpu/scene/voxel.py;
reference use of ca3d: procedural level geometry — ca3d_make's walled box
+ cave walk + CA growth feed level meshes, SURVEY §2.6).

``voxel_mesh`` turns a (D, H, W) occupancy grid (ca3d output) into a
blocky quad mesh: one quad per filled/empty face transition, outward
normals — the standard minecraft-style mesher. Host-side numpy (content
gen), a copy of the JAX package's; output feeds render tables and the
static trimesh collider.
"""
from __future__ import annotations

import numpy as np

# face direction table: (grid offset (dz, dy, dx), world normal (nx, ny, nz)).
# The grid is [z, y, x], so a +x transition (dx=+1) emits a world +x-normal
# face — the offset is in grid index order, the normal in world xyz order.
_FACES = (
    ((0, 0, 1), (1, 0, 0)),     # +x
    ((0, 0, -1), (-1, 0, 0)),   # -x
    ((0, 1, 0), (0, 1, 0)),     # +y
    ((0, -1, 0), (0, -1, 0)),   # -y
    ((1, 0, 0), (0, 0, 1)),     # +z
    ((-1, 0, 0), (0, 0, -1)),   # -z
)


def voxel_mesh(grid: np.ndarray, cell: float = 1.0, origin=(0.0, 0.0, 0.0)):
    """grid: (D, H, W) uint8 ([z, y, x], nonzero = solid).

    Returns (verts (V, 3), normals (V, 3), faces (T, 3) int32) in world
    units: x = x_idx·cell, y = y_idx·cell, z = z_idx·cell + origin."""
    solid = grid != 0
    pad = np.pad(solid, 1)
    verts = []
    normals = []
    faces = []
    ox, oy, oz = origin

    for (dz, dy, dx), nrm in _FACES:
        # solid cell whose neighbor in (dz,dy,dx) is empty → emit a face
        nb = pad[1 + dz : 1 + dz + grid.shape[0],
                 1 + dy : 1 + dy + grid.shape[1],
                 1 + dx : 1 + dx + grid.shape[2]]
        zz, yy, xx = np.nonzero(solid & ~nb)
        if len(zz) == 0:
            continue
        # quad corners on the face plane
        nx, ny, nz = nrm
        # face center offset along the normal by half a cell
        cx = (xx + 0.5 + nx * 0.5) * cell + ox
        cy = (yy + 0.5 + ny * 0.5) * cell + oy
        cz = (zz + 0.5 + nz * 0.5) * cell + oz
        # tangent frame with t1 × t2 = normal → CCW quads from outside
        n_vec = np.array([nx, ny, nz], np.float64)
        t1 = np.array([0.0, 1.0, 0.0]) if ny == 0 else np.array([1.0, 0.0, 0.0])
        t2 = np.cross(n_vec, t1)
        t1 = np.cross(t2, n_vec)
        c = np.stack([cx, cy, cz], -1)
        h = cell * 0.5
        v0 = c - t1 * h - t2 * h
        v1 = c + t1 * h - t2 * h
        v2 = c + t1 * h + t2 * h
        v3 = c - t1 * h + t2 * h
        start = sum(len(v) for v in verts)
        verts.extend([v0, v1, v2, v3])
        n_arr = np.tile(np.array([[nx, ny, nz]], np.float32), (len(cx), 1))
        normals.extend([n_arr] * 4)
        idx = np.arange(len(cx))
        # CCW seen from outside (normal side): v0, v1, v2 / v0, v2, v3
        f1 = np.stack([start + idx, start + len(cx) + idx,
                       start + 2 * len(cx) + idx], -1)
        f2 = np.stack([start + idx, start + 2 * len(cx) + idx,
                       start + 3 * len(cx) + idx], -1)
        faces.extend([f1, f2])

    if not verts:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0, 3), np.int32))
    v = np.concatenate(verts).astype(np.float32)
    n = np.concatenate(normals).astype(np.float32)
    f = np.concatenate(faces).astype(np.int32)
    return v, n, f


def cave_scene(d0: int = 24, d1: int = 24, d2: int = 24, seed: int = 5,
               ca_rule: int = -1, ca_steps: int = 0, cell: float = 1.0,
               device=None):
    """ca3d_make + optional CA growth → mesh (the reference's procedural
    level path: walk carves a cave in a walled box, then CA rules grow
    features — ca3d.c:110-169). The walk runs on the host, the CA growth
    on ``device`` (the card unless named). Returns numpy (grid, verts,
    normals, faces)."""
    import torch

    from ..device import resolve_device
    from ..ops.ca3d import CA3D_RULES, ca3d_run
    from ..utils.frand import Rand48
    from .ca3d_host import ca3d_make_host

    grid = ca3d_make_host(d0, d1, d2, Rand48(seed))
    if ca_rule >= 0 and ca_steps > 0:
        rule = CA3D_RULES[ca_rule % len(CA3D_RULES)]
        g = ca3d_run(rule, torch.as_tensor(grid, device=resolve_device(
            device)), ca_steps)
        grid = g.cpu().numpy()
    v, n, f = voxel_mesh(grid, cell=cell)
    return grid, v, n, f
