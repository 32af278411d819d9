"""Procedural primitive meshes (reference: core/primitives.{c,h}:
cube/quad/frame/cylinder builders used by UI quads and debug draw).

Host-side numpy builders returning (verts, normals, uvs, faces).
"""
from __future__ import annotations

import numpy as np


def quad(w: float = 1.0, h: float = 1.0, z: float = 0.0):
    """XY-plane quad, CCW facing +z."""
    v = np.array([[0, 0, z], [w, 0, z], [w, h, z], [0, h, z]], np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, n, uv, f


def frame_quad(w: float = 1.0, h: float = 1.0, t: float = 0.1):
    """Rectangular frame (border) of thickness t (primitives.c frame)."""
    outer, _, _, _ = quad(w, h)
    verts = []
    faces = []

    def add_quad(x0, y0, x1, y1):
        base = len(verts)
        verts.extend([[x0, y0, 0], [x1, y0, 0], [x1, y1, 0], [x0, y1, 0]])
        faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])

    add_quad(0, 0, w, t)            # bottom
    add_quad(0, h - t, w, h)        # top
    add_quad(0, t, t, h - t)        # left
    add_quad(w - t, t, w, h - t)    # right
    v = np.array(verts, np.float32)
    n = np.tile(np.array([[0, 0, 1]], np.float32), (len(v), 1))
    uv = v[:, :2] / np.array([w, h], np.float32)
    return v, n, uv.astype(np.float32), np.array(faces, np.int32)


def cube(size: float = 1.0):
    """Axis-aligned cube centered at origin, CCW outward faces."""
    s = size / 2
    face_defs = [
        (np.array([0, 0, 1]), np.array([1, 0, 0]), np.array([0, 1, 0])),
        (np.array([0, 0, -1]), np.array([-1, 0, 0]), np.array([0, 1, 0])),
        (np.array([1, 0, 0]), np.array([0, 0, -1]), np.array([0, 1, 0])),
        (np.array([-1, 0, 0]), np.array([0, 0, 1]), np.array([0, 1, 0])),
        (np.array([0, 1, 0]), np.array([1, 0, 0]), np.array([0, 0, -1])),
        (np.array([0, -1, 0]), np.array([1, 0, 0]), np.array([0, 0, 1])),
    ]
    verts, normals, uvs, faces = [], [], [], []
    for nrm, u, v in face_defs:
        base = len(verts)
        for du, dv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            verts.append((nrm + u * du + v * dv) * s)
            normals.append(nrm)
            uvs.append([(du + 1) / 2, (dv + 1) / 2])
        faces.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return (np.array(verts, np.float32), np.array(normals, np.float32),
            np.array(uvs, np.float32), np.array(faces, np.int32))


def cylinder(radius: float = 0.5, height: float = 1.0, segments: int = 16):
    """Y-axis cylinder with caps."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.zeros(segments),
                     np.sin(ang) * radius], -1)
    bot = ring.copy()
    top = ring + np.array([0, height, 0])
    verts = [*bot, *top, [0, 0, 0], [0, height, 0]]
    normals = [*np.stack([np.cos(ang), np.zeros(segments), np.sin(ang)], -1)] * 2
    normals += [[0, -1, 0], [0, 1, 0]]
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        # side (outward CCW)
        faces.append([i, i + segments, j])
        faces.append([j, i + segments, j + segments])
        # caps
        faces.append([2 * segments, i, j])                        # bottom
        faces.append([2 * segments + 1, j + segments, i + segments])  # top
    v = np.array(verts, np.float32)
    uv = np.zeros((len(v), 2), np.float32)
    return (v, np.array(normals, np.float32), uv, np.array(faces, np.int32))
