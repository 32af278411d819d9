"""glTF 2.0 / GLB parser (counterpart of clap_tpu/scene/gltf.py; reference:
core/gltf.{c,h} — 1366 LoC C parser).

Host-side (numpy) asset ingestion: accessors/buffer views (gltf.c:15-60),
meshes, skins (gltf.c:583), animations (gltf.c:491), materials
(gltf.c:150-158, 916-985), base64 data URIs, GLB containers
(gltf.c:1065). Instantiation mirrors gltf_instantiate_one
(gltf.c:1158-1331): root or first non-collision mesh becomes the render
mesh; a node named "collision" supplies the physics trimesh
(scene.c:1392-1421); skins produce our Skeleton + AnimLibrary.

Runtime playback drops glTF sampler interpolation modes exactly like the
reference does (STEP/CUBICSPLINE parsed but played back lerp/slerp —
model.c:678-741, SURVEY §2.11).
"""
from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field

import numpy as np

_COMPONENT_DTYPE = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_SIZE = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
              "MAT2": 4, "MAT3": 9, "MAT4": 16}


@dataclass
class GltfMesh:
    name: str
    verts: np.ndarray            # (V, 3)
    normals: np.ndarray | None
    uvs: np.ndarray | None
    tangents: np.ndarray | None
    joints: np.ndarray | None    # (V, 4) uint16
    weights: np.ndarray | None   # (V, 4) f32
    indices: np.ndarray          # (I,) uint32
    material: int


@dataclass
class GltfMaterial:
    name: str
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: tuple = (0.0, 0.0, 0.0)
    base_color_tex: int = -1
    normal_tex: int = -1
    emissive_tex: int = -1


@dataclass
class GltfSkin:
    joint_nodes: list            # node indices, in skin order
    invbind: np.ndarray          # (J, 4, 4)


@dataclass
class GltfAnimation:
    name: str
    # channels: (node, path_str, times (T,), values (T, D))
    channels: list = field(default_factory=list)


@dataclass
class GltfDocument:
    meshes: list                 # GltfMesh per mesh-node instantiated
    materials: list
    skins: list
    animations: list
    nodes: list                  # raw node dicts
    node_trs: list               # (translation, rotation, scale) per node
    images: list                 # decoded raw bytes per image
    scene_roots: list
    textures: list = field(default_factory=list)  # texture idx → source
                                                  # image idx (gltf.c:621)


def _decode_uri(uri: str, buffers_dir=None) -> bytes:
    if uri.startswith("data:"):
        b64 = uri.split(",", 1)[1]
        return base64.b64decode(b64)
    if buffers_dir is not None:
        return (buffers_dir / uri).read_bytes()
    raise FileNotFoundError(uri)


def parse_glb(data: bytes):
    """GLB container (gltf.c:1065-1098): header + JSON + BIN chunks."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    off = 12
    doc = None
    bin_chunk = b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8 : off + 8 + clen]
        if ctype == 0x4E4F534A:
            doc = json.loads(chunk.decode("utf-8"))
        elif ctype == 0x004E4942:
            bin_chunk = chunk
        off += 8 + clen
    return doc, bin_chunk


class _Accessors:
    def __init__(self, doc, buffers):
        self.doc = doc
        self.buffers = buffers

    def read(self, idx):
        acc = self.doc["accessors"][idx]
        bv = self.doc["bufferViews"][acc["bufferView"]]
        buf = self.buffers[bv.get("buffer", 0)]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        ncomp = _TYPE_SIZE[acc["type"]]
        count = acc["count"]
        byte_off = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        itemsize = np.dtype(dtype).itemsize * ncomp
        if stride and stride != itemsize:
            rows = []
            for i in range(count):
                o = byte_off + i * stride
                rows.append(np.frombuffer(buf, dtype, ncomp, o))
            arr = np.stack(rows)
        else:
            arr = np.frombuffer(buf, dtype, count * ncomp, byte_off)
            arr = arr.reshape(count, ncomp) if ncomp > 1 else arr
        return np.array(arr)


def load_gltf(data: bytes | str, buffers_dir=None) -> GltfDocument:
    """Parse a .gltf (JSON str/bytes) or .glb (bytes) document."""
    if isinstance(data, bytes) and data[:4] == b"glTF":
        doc, bin_chunk = parse_glb(data)
        buffers = []
        for b in doc.get("buffers", []):
            if "uri" in b:
                buffers.append(_decode_uri(b["uri"], buffers_dir))
            else:
                buffers.append(bin_chunk)
    else:
        doc = json.loads(data if isinstance(data, str) else data.decode())
        buffers = [_decode_uri(b["uri"], buffers_dir)
                   for b in doc.get("buffers", [])]

    acc = _Accessors(doc, buffers)

    materials = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        materials.append(GltfMaterial(
            name=m.get("name", ""),
            base_color=tuple(pbr.get("baseColorFactor", (1, 1, 1, 1))),
            metallic=pbr.get("metallicFactor", 1.0),
            roughness=pbr.get("roughnessFactor", 1.0),
            emissive=tuple(m.get("emissiveFactor", (0, 0, 0))),
            base_color_tex=pbr.get("baseColorTexture", {}).get("index", -1),
            normal_tex=m.get("normalTexture", {}).get("index", -1),
            emissive_tex=m.get("emissiveTexture", {}).get("index", -1),
        ))

    meshes = []
    for mi, m in enumerate(doc.get("meshes", [])):
        prim = m["primitives"][0]  # reference uses primitive 0 per mesh
        at = prim["attributes"]

        def rd(name):
            return acc.read(at[name]) if name in at else None

        verts = acc.read(at["POSITION"]).astype(np.float32)
        idx = acc.read(prim["indices"]).astype(np.uint32) if "indices" in prim \
            else np.arange(len(verts), dtype=np.uint32)
        nrm = rd("NORMAL")
        uv = rd("TEXCOORD_0")
        tan = rd("TANGENT")
        joints = rd("JOINTS_0")
        weights = rd("WEIGHTS_0")
        meshes.append(GltfMesh(
            name=m.get("name", f"mesh{mi}"),
            verts=verts,
            normals=None if nrm is None else nrm.astype(np.float32),
            uvs=None if uv is None else uv.astype(np.float32),
            tangents=None if tan is None else tan.astype(np.float32),
            joints=None if joints is None else joints.astype(np.int32),
            weights=None if weights is None else
            (weights.astype(np.float32) / np.maximum(
                weights.astype(np.float32).sum(-1, keepdims=True), 1e-9)
             if weights.dtype != np.float32 else weights),
            indices=idx.reshape(-1),
            material=prim.get("material", -1),
        ))

    skins = []
    for s in doc.get("skins", []):
        inv = acc.read(s["inverseBindMatrices"]).astype(np.float32) \
            if "inverseBindMatrices" in s else \
            np.tile(np.eye(4, dtype=np.float32).reshape(1, 16),
                    (len(s["joints"]), 1))
        # glTF matrices are column-major flat — transpose to our row-major
        inv = inv.reshape(-1, 4, 4).transpose(0, 2, 1)
        skins.append(GltfSkin(joint_nodes=list(s["joints"]), invbind=inv))

    animations = []
    for a in doc.get("animations", []):
        anim = GltfAnimation(name=a.get("name", ""))
        for ch in a.get("channels", []):
            smp = a["samplers"][ch["sampler"]]
            times = acc.read(smp["input"]).astype(np.float32).reshape(-1)
            vals = acc.read(smp["output"]).astype(np.float32)
            tgt = ch["target"]
            anim.channels.append((tgt["node"], tgt["path"], times, vals))
        animations.append(anim)

    node_trs = []
    for n in doc.get("nodes", []):
        if "matrix" in n:
            m = np.array(n["matrix"], np.float32).reshape(4, 4).T
            t = m[:3, 3]
            sc = np.linalg.norm(m[:3, :3], axis=0)
            r3 = m[:3, :3] / sc[None, :]
            import torch

            from ..mathx import quat_from_mat3

            q = quat_from_mat3(torch.as_tensor(r3)).numpy()
        else:
            t = np.array(n.get("translation", [0, 0, 0]), np.float32)
            q = np.array(n.get("rotation", [0, 0, 0, 1]), np.float32)
            sc = np.array(n.get("scale", [1, 1, 1]), np.float32)
        node_trs.append((t, q, sc))

    images = []
    for img in doc.get("images", []):
        if "uri" in img:
            try:
                images.append(_decode_uri(img["uri"], buffers_dir))
            except FileNotFoundError:
                images.append(b"")
        elif "bufferView" in img:
            bv = doc["bufferViews"][img["bufferView"]]
            buf = buffers[bv.get("buffer", 0)]
            o = bv.get("byteOffset", 0)
            images.append(bytes(buf[o : o + bv["byteLength"]]))

    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]
    return GltfDocument(
        meshes=meshes, materials=materials, skins=skins,
        animations=animations, nodes=doc.get("nodes", []),
        node_trs=node_trs, images=images,
        scene_roots=scene.get("nodes", []),
        textures=[t.get("source", -1) for t in doc.get("textures", [])],
    )


# ---------------------------------------------------------------------------
# instantiation (gltf_instantiate_one, gltf.c:1158-1331)
# ---------------------------------------------------------------------------

_PATHS = {"translation": 0, "rotation": 1, "scale": 2}


def build_rig(doc: GltfDocument, skin_idx: int = 0, device=None):
    """Skeleton + AnimLibrary from a parsed document, on ``device`` (the
    card unless named).

    Joint indexing follows the skin's joint list; node parents are
    remapped into skin-joint space (nodes outside the skin become
    roots). Channel values targeting non-joint nodes are dropped, like
    the reference's per-joint channel binding (gltf.c:1234-1322)."""
    from ..anim.clips import build_library
    from ..anim.joints import build_skeleton

    skin = doc.skins[skin_idx]
    node_to_joint = {n: j for j, n in enumerate(skin.joint_nodes)}
    J = len(skin.joint_nodes)

    parent_of_node = {}
    for ni, n in enumerate(doc.nodes):
        for c in n.get("children", []):
            parent_of_node[c] = ni

    parent = np.full(J, -1, np.int32)
    for j, n in enumerate(skin.joint_nodes):
        p = parent_of_node.get(n, -1)
        parent[j] = node_to_joint.get(p, -1)

    base_t = np.zeros((J, 3), np.float32)
    base_r = np.tile(np.array([0, 0, 0, 1], np.float32), (J, 1))
    base_s = np.ones((J, 3), np.float32)
    for j, n in enumerate(skin.joint_nodes):
        t, q, s = doc.node_trs[n]
        base_t[j], base_r[j], base_s[j] = t, q, s

    # topological order requirement: parent[i] < i. glTF does not
    # guarantee it, so reorder joints if needed.
    order = []
    seen = set()

    def visit(j):
        if j in seen:
            return
        if parent[j] >= 0:
            visit(parent[j])
        seen.add(j)
        order.append(j)

    for j in range(J):
        visit(j)
    remap = np.empty(J, np.int32)
    for new, old in enumerate(order):
        remap[old] = new
    parent2 = np.array([
        remap[parent[old]] if parent[old] >= 0 else -1 for old in order
    ], np.int32)

    sk = build_skeleton(parent2, skin.invbind[order], base_t[order],
                        base_r[order], base_s[order], device)

    clips = []
    names = []
    for anim in doc.animations:
        chans = []
        for node, path, times, vals in anim.channels:
            if node not in node_to_joint or path not in _PATHS:
                continue
            j = int(remap[node_to_joint[node]])
            chans.append((j, _PATHS[path], times, vals))
        if chans:
            clips.append(chans)
            names.append(anim.name)
    lib = build_library(clips, J, device) if clips else None
    return sk, lib, names, remap


def resolve_armature(doc: GltfDocument, armature: dict, remap,
                     skin_idx: int = 0) -> dict:
    """Resolve a scene.json "armature" block ({semantic: joint NAME})
    to BUILD_RIG joint indices (scene.c:1474-1492: joint names come
    from the glTF exporter; semantics — head/foot_left/… model.h:30-38
    — are what gameplay/camera code keys on). ``remap`` is build_rig's
    old→new joint reorder. Unknown names resolve to -1."""
    skin = doc.skins[skin_idx]
    name_to_old = {}
    for j, n in enumerate(skin.joint_nodes):
        nm = doc.nodes[n].get("name") if n < len(doc.nodes) else None
        if nm:
            name_to_old.setdefault(nm, j)
    out = {}
    for sem, jname in (armature or {}).items():
        old = name_to_old.get(jname, -1)
        out[sem] = int(remap[old]) if old >= 0 else -1
    return out


def find_collision_mesh(doc: GltfDocument):
    """The reference's named-"collision"-mesh convention
    (scene.c:1392-1421). Returns (render_mesh, collision_mesh|None)."""
    render = None
    coll = None
    for m in doc.meshes:
        if "collision" in m.name.lower():
            coll = coll or m
        elif render is None:
            render = m
    return render, coll
