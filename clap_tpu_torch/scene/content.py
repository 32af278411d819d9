"""Content → renderer wiring (counterpart of clap_tpu/scene/content.py):
glTF materials and textures become render tables and texture sets.

This is the reference's entire content path — gltf materials →
model3dtx texture slots → draw (gltf.c:916-985 builds the texture set
from baseColor/normal/emissive textures or 1×1 canvas colors,
model.h:213-223 holds the slots, scene.c:1381-1421 instantiates) —
re-expressed for the batched renderer: every model's maps land in one
stacked (L, S, S, 3) layer atlas (TextureSets) selected per pixel by
the interpolated ``tex_id`` stream, so one frame can draw every
material without per-model dispatch.

Host-side (numpy): runs once at scene load; the tables and layers then
move to ``device`` (the card unless named).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..render.pipeline import TextureSets
from ..render.scenerender import (ModelData, RenderTables,
                                  build_render_tables, default_edge_ids,
                                  model_from_mesh)
from ..utils.png import decode_png

_FLAT_NORMAL = (0.5, 0.5, 1.0)


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for meshes that ship without NORMAL
    accessors (gltf.c generates them the same way)."""
    n = np.zeros_like(verts, dtype=np.float32)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    fn = np.cross(verts[f[:, 1]] - verts[f[:, 0]],
                  verts[f[:, 2]] - verts[f[:, 0]])
    for k in range(3):
        np.add.at(n, f[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.where(ln > 1e-12, n / np.maximum(ln, 1e-12),
                    np.array([0, 1, 0], np.float32))


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resample to (size, size, C)."""
    h, w = img.shape[:2]
    yi = (np.arange(size) * h // size).clip(0, h - 1)
    xi = (np.arange(size) * w // size).clip(0, w - 1)
    return img[yi[:, None], xi[None, :]]


def _decode_layer(data: bytes, size: int, fill) -> np.ndarray:
    """PNG bytes → (size, size, 3) float [0,1]; fill color when absent
    (the reference's 1×1 canvas-color fallback, gltf.c:916-985)."""
    if data:
        img = decode_png(data).astype(np.float32) / 255.0
        return _resize_nearest(img[..., :3], size)
    return np.broadcast_to(np.asarray(fill, np.float32),
                           (size, size, 3)).copy()


class TextureRegistry:
    """Accumulates per-model texture layers; builds the stacked sets."""

    def __init__(self, size: int = 256):
        self.size = size
        self.layers: list[tuple[bytes, bytes, bytes]] = []
        self.any_normal = False
        self.any_emission = False

    def add(self, diffuse: bytes, normal: bytes = b"",
            emission: bytes = b"") -> int:
        self.any_normal |= bool(normal)
        self.any_emission |= bool(emission)
        self.layers.append((diffuse, normal, emission))
        return len(self.layers) - 1

    def build(self, device=None) -> TextureSets | None:
        """The stacked layers on ``device`` (the card unless named); None
        when no model registered a map."""
        device = resolve_device(device)
        if not self.layers:
            return None
        s = self.size
        diff = np.stack([_decode_layer(d, s, (1, 1, 1))
                         for d, _, _ in self.layers])
        nrm = em = None
        if self.any_normal:
            nrm = np.stack([_decode_layer(n, s, _FLAT_NORMAL)
                            for _, n, _ in self.layers])
        if self.any_emission:
            em = np.stack([_decode_layer(e, s, (0, 0, 0))
                           for _, _, e in self.layers])
        def dev(x):
            return None if x is None else torch.as_tensor(x, device=device)

        return TextureSets(diffuse=dev(diff), normal=dev(nrm),
                           emission=dev(em))


def _image_for(lm, tex_idx: int) -> bytes:
    """Resolve a glTF texture index to raw image bytes through the
    texture→source mapping (gltf.c:621)."""
    if tex_idx < 0 or tex_idx >= len(lm.tex_source):
        return b""
    src = lm.tex_source[tex_idx]
    if src < 0 or src >= len(lm.images):
        return b""
    return lm.images[src]


def model_render_data(lm, registry: TextureRegistry,
                      with_lods: bool = True) -> ModelData:
    """One LoadedModel (scene/loader.py) → ModelData with its material
    factors baked per-vertex and its maps registered as a texture layer
    — the model3dtx construction (gltf.c:1207, model.c:314)."""
    mesh = lm.mesh
    if mesh is None:
        from .primitives import cube

        v, n, uv, f = cube(1.0)
        return model_from_mesh(v, n, f, with_lods=with_lods)

    faces = mesh.indices.reshape(-1, 3)
    normals = (mesh.normals if mesh.normals is not None
               else vertex_normals(mesh.verts, faces))

    mat = None
    if lm.materials and 0 <= mesh.material < len(lm.materials):
        mat = lm.materials[mesh.material]

    base_color = (1.0, 1.0, 1.0)
    rough_metal = (0.7, 0.0)
    emission = (0.0, 0.0, 0.0)
    tex_id = -1
    if mat is not None:
        base_color = tuple(mat.base_color[:3])
        rough_metal = (float(mat.roughness), float(mat.metallic))
        emission = tuple(mat.emissive)
        d = _image_for(lm, mat.base_color_tex)
        n = _image_for(lm, mat.normal_tex)
        e = _image_for(lm, mat.emissive_tex)
        if d or n or e:
            tex_id = registry.add(d, n, e)

    return model_from_mesh(mesh.verts, normals, faces,
                           base_color=base_color, rough_metal=rough_metal,
                           emission=emission, uv=mesh.uvs, tex_id=tex_id,
                           with_lods=with_lods)


def scene_render_setup(scene, tex_size: int = 256, with_lods: bool = True,
                       extra_models: dict | None = None,
                       exclude_outline=None, device=None):
    """LoadedScene → (RenderTables, TextureSets | None): the end-to-end
    wiring from parsed glTF materials to the per-frame draw tables.

    extra_models: {model_idx: ModelData} overrides (procedural terrain
    etc. that has no glTF). exclude_outline: optional (E,) bool mask of
    entities whose pixels never cartoon-outline (bit7).

    Returns tables that carry uv/tangent/tex_id streams AND per-entity
    edge ids (characters get distinct solid ids), so a frame rendered
    from these tables exercises texturing, normal mapping, and outline
    metadata with zero per-frame host work. Both live on ``device`` (the
    card unless named).
    """
    device = resolve_device(device)
    registry = TextureRegistry(tex_size)
    models_rd = []
    for mi, lm in enumerate(scene.models):
        if extra_models and mi in extra_models:
            models_rd.append(extra_models[mi])
            continue
        models_rd.append(model_render_data(lm, registry, with_lods))

    ent = scene.cfg.entities
    active = ent.active.cpu().numpy()
    edge = default_edge_ids(active, ent.body_is_char.cpu().numpy(),
                            exclude=exclude_outline)
    rt = build_render_tables(models_rd, ent.model_id.cpu().numpy(), active,
                             entity_edge_id=edge, device=device)
    return rt, registry.build(device)
