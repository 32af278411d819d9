"""Synthetic glTF asset pack for the authored ldjam57-style level
(demo/level57.json): the port's copy of demo/assets57.py, byte for byte
the same documents, built with the port's PNG encoder.

The reference ships its level assets in absent git submodules (SURVEY
§6), so the demo synthesizes equivalent glTF documents in memory: the
scene.json stays REAL data (demo/level57.json) and flows through the
standard librarian → gltf → scene path (scene.c:1318-1724 analogue),
exactly as shipped assets would.
"""
from __future__ import annotations

import base64
import json

import numpy as np


def _b64(arr: np.ndarray) -> str:
    return ("data:application/octet-stream;base64,"
            + base64.b64encode(arr.tobytes()).decode())


def _box_mesh(w: float, h: float, d: float):
    """Axis-aligned box, base at y=0 (feet-friendly): 24 verts with
    per-face normals + UVs."""
    hw, hd = w / 2, d / 2
    faces = []
    # (normal, corners CCW from outside)
    defs = [
        ((0, 1, 0), [(-hw, h, -hd), (-hw, h, hd), (hw, h, hd), (hw, h, -hd)]),
        ((0, -1, 0), [(-hw, 0, -hd), (hw, 0, -hd), (hw, 0, hd), (-hw, 0, hd)]),
        ((1, 0, 0), [(hw, 0, -hd), (hw, h, -hd), (hw, h, hd), (hw, 0, hd)]),
        ((-1, 0, 0), [(-hw, 0, -hd), (-hw, 0, hd), (-hw, h, hd), (-hw, h, -hd)]),
        ((0, 0, 1), [(-hw, 0, hd), (hw, 0, hd), (hw, h, hd), (-hw, h, hd)]),
        ((0, 0, -1), [(-hw, 0, -hd), (-hw, h, -hd), (hw, h, -hd), (hw, 0, -hd)]),
    ]
    verts, normals, uvs, idx = [], [], [], []
    for n, corners in defs:
        base = len(verts)
        verts.extend(corners)
        normals.extend([n] * 4)
        uvs.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        idx.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return (np.asarray(verts, np.float32), np.asarray(normals, np.float32),
            np.asarray(uvs, np.float32), np.asarray(idx, np.uint32))


def make_box_gltf(w: float, h: float, d: float,
                  color=(0.8, 0.8, 0.8), emissive=(0.0, 0.0, 0.0),
                  checker: tuple | None = None) -> str:
    """Box glTF with PBR material; checker=(colA, colB) embeds a PNG
    baseColorTexture (exercises the full material path)."""
    v, n, uv, idx = _box_mesh(w, h, d)
    buffers = [v, n, uv, idx]
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": _b64(a), "byteLength": a.nbytes}
                    for a in buffers],
        "bufferViews": [
            {"buffer": i, "byteOffset": 0, "byteLength": a.nbytes}
            for i, a in enumerate(buffers)],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(v),
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": len(n),
             "type": "VEC3"},
            {"bufferView": 2, "componentType": 5126, "count": len(uv),
             "type": "VEC2"},
            {"bufferView": 3, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        "meshes": [{"name": "box", "primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [{"name": "mat", "pbrMetallicRoughness": {
            "baseColorFactor": list(color) + [1.0],
            "metallicFactor": 0.0, "roughnessFactor": 0.8},
            "emissiveFactor": list(emissive)}],
        "nodes": [{"name": "box", "mesh": 0}],
        "scenes": [{"nodes": [0]}],
        "scene": 0,
    }
    if checker is not None:
        from ..utils.png import encode_png

        a, b = checker
        img = np.zeros((8, 8, 3), np.uint8)
        img[:] = np.asarray(b, np.uint8)
        img[::2, ::2] = a
        img[1::2, 1::2] = a
        doc["images"] = [{"uri": "data:image/png;base64," + base64.b64encode(
            encode_png(img)).decode()}]
        doc["textures"] = [{"source": 0}]
        doc["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = \
            {"index": 0}
    return json.dumps(doc)


_ASSETS = {
    "crate.gltf": lambda: make_box_gltf(
        2.0, 0.2, 2.0, color=(1.0, 1.0, 1.0),
        checker=((200, 60, 40), (120, 90, 60))),
    "platform.gltf": lambda: make_box_gltf(
        3.0, 0.4, 3.0, color=(0.55, 0.6, 0.75)),
    "hero.gltf": lambda: make_box_gltf(
        0.6, 1.8, 0.6, color=(0.85, 0.55, 0.35)),
    "light.gltf": lambda: make_box_gltf(
        1.0, 1.0, 1.0, color=(1.0, 1.0, 0.8),
        emissive=(4.0, 3.6, 2.4)),
}


def asset_loader(name: str) -> bytes:
    """librarian-style resolver (librarian.h:39-43) for the level's
    gltf refs."""
    return _ASSETS[name]().encode()
