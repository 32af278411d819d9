"""Engine-state → renderer glue (counterpart of
clap_tpu/render/scenerender.py; reference: models_render
model.c:742-1086, the draw loop with per-entity cull and LOD select).

At scene load every active entity gets an instanced copy of its model in
one concatenated table (``build_render_tables``, host numpy). Per frame
the cluster-record front end (``assemble_cluster_records_batch``, the
kernel-attrs path) culls entities and clusters, picks each entity's LOD
by distance, compacts the valid clusters and transforms their rest-pose
corners straight to clip space — one batched pass for every env. Tables
with per-vertex or textured materials take the member-granularity
assembly (``assemble_scene_geometry_batch``) and the per-pixel gather
path. Both take skinned characters (``charskin.CharSkin``). The single-env
``assemble_scene_geometry`` (the game's own frame) bakes world-space
normals and tangents per frame, skinned characters exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device
from ..scene.mesh import LOD_MAX, build_lods
from .pipeline import SceneGeometry
from .raster import CLUSTER, cluster_faces, ent_pack_stride
from .view import aabb_in_frustum

LOD_DISTANCES = (30.0, 60.0, 120.0)


class ModelData(NamedTuple):
    """Host-side per-model render data fed to build_render_tables."""

    verts: np.ndarray        # (V, 3)
    normals: np.ndarray      # (V, 3)
    base_color: np.ndarray   # (V, 3)
    rough_metal: np.ndarray  # (V, 2)
    emission: np.ndarray     # (V, 3)
    lod_faces: list          # [(T_l, 3)] per LOD
    uv: np.ndarray = None
    tangent: np.ndarray = None
    tex_id: int = -1
    mat_fbm: tuple = None


class RenderTables(NamedTuple):
    """Static instanced geometry (device tensors; fields as in the JAX
    package, see clap_tpu/render/scenerender.py)."""

    verts: torch.Tensor
    normals: torch.Tensor
    base_color: torch.Tensor
    rough_metal: torch.Tensor
    emission: torch.Tensor
    uv: torch.Tensor
    tangent: torch.Tensor
    tex_id: torch.Tensor
    mat_fbm: torch.Tensor
    any_material: bool
    vert_entity: torch.Tensor
    faces: torch.Tensor
    face_entity: torch.Tensor
    face_lod: torch.Tensor
    entity_aabb: torch.Tensor
    ent_max_lod: torch.Tensor = None
    edge_id: torch.Tensor = None
    shadow_faces: torch.Tensor = None
    shadow_face_entity: torch.Tensor = None
    ent_flat: torch.Tensor = None
    flat_eligible: bool = False
    static_shadow_faces: torch.Tensor = None
    cl_entity: torch.Tensor = None
    cl_lod: torch.Tensor = None
    cl_aabb: torch.Tensor = None
    cl_rest: torch.Tensor = None
    shadow_corner_rest: torch.Tensor = None
    shadow_corner_entity: torch.Tensor = None


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def model_from_mesh(verts, normals, faces, base_color=(0.7, 0.7, 0.7),
                    rough_metal=(0.7, 0.0), emission=(0, 0, 0),
                    with_lods: bool = True, uv=None, tex_id: int = -1,
                    mat_fbm=None) -> ModelData:
    """ModelData with LOD chains (native simplifier), each LOD's faces in
    Morton order so binning clusters are compact spatial patches. With
    ``uv`` the per-vertex tangents come from the LOD 0 faces
    (compute_tangents); ``tex_id`` is the model's texture layer and
    ``mat_fbm`` its (amp, scale, rough floor/ceil, metal floor/ceil)."""
    verts = np.asarray(verts, np.float32)
    V = len(verts)
    lods = build_lods(verts, np.asarray(faces).reshape(-1)) if with_lods \
        else [np.asarray(faces, np.uint32).reshape(-1)]
    lods = [cluster_faces(verts, l.reshape(-1, 3))[0].reshape(-1)
            for l in lods]
    tangent = None
    if uv is not None:
        uv = np.asarray(uv, np.float32)
        tangent = compute_tangents(verts, np.asarray(normals, np.float32),
                                   uv, lods[0].reshape(-1, 3))
    return ModelData(
        verts=verts,
        normals=np.asarray(normals, np.float32),
        base_color=np.broadcast_to(np.asarray(base_color, np.float32),
                                   (V, 3)).copy(),
        rough_metal=np.broadcast_to(np.asarray(rough_metal, np.float32),
                                    (V, 2)).copy(),
        emission=np.broadcast_to(np.asarray(emission, np.float32),
                                 (V, 3)).copy(),
        lod_faces=[l.reshape(-1, 3) for l in lods],
        uv=uv, tangent=tangent, tex_id=tex_id, mat_fbm=mat_fbm,
    )


def compute_tangents(verts, normals, uvs, faces):
    """Per-vertex tangents from uv gradients (Lengyel's accumulation; the
    TANGENTS model.vert:54-67 reads). Returns (V, 4): the xyz tangent and
    the bitangent's handedness w."""
    V = len(verts)
    tan = np.zeros((V, 3), np.float32)
    bit = np.zeros((V, 3), np.float32)
    f = np.asarray(faces, np.int64)
    p0, p1, p2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    t0, t1, t2 = uvs[f[:, 0]], uvs[f[:, 1]], uvs[f[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = t1 - t0, t2 - t0
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1, det))
    td = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    bd = (e2 * d1[:, 0:1] - e1 * d2[:, 0:1]) * r[:, None]
    for k in range(3):
        np.add.at(tan, f[:, k], td)
        np.add.at(bit, f[:, k], bd)
    n = np.asarray(normals, np.float32)
    t = tan - n * np.sum(n * tan, -1, keepdims=True)
    ln = np.linalg.norm(t, axis=-1, keepdims=True)
    t = np.where(ln > 1e-8, t / np.maximum(ln, 1e-8),
                 np.array([1.0, 0.0, 0.0], np.float32))
    w = np.where(np.sum(np.cross(n, t) * bit, -1) < 0, -1.0, 1.0)
    return np.concatenate([t, w[:, None]], -1).astype(np.float32)


def default_edge_ids(entity_active, body_is_char,
                     exclude=None) -> np.ndarray:
    """Per-entity edge-mode ids: each character entity gets a distinct
    solid id 1..15, everything else 0; ``exclude`` adds 128."""
    e = np.zeros(len(entity_active), np.float32)
    sid = 1
    for i, (act, ch) in enumerate(zip(_np(entity_active), _np(body_is_char))):
        if act and ch:
            e[i] = float(sid)
            sid = sid % 15 + 1
    if exclude is not None:
        e = e + 128.0 * np.asarray(exclude, np.float32)
    return e


def shadow_static_mask(entities, platform_group=None) -> np.ndarray:
    """Static shadow casters: active entities with no physics body and no
    character capsule (terrain chunks, trees)."""
    m = _np(entities.active) & (_np(entities.body) < 0) \
        & ~_np(entities.body_is_char)
    if platform_group is not None:
        m = m & ~(_np(platform_group) >= 0)
    return m


def build_render_tables(models: list, entity_model, entity_active,
                        entity_edge_id=None, entity_shadow_static=None,
                        device=None) -> RenderTables:
    """Instance-expand models over active entity slots (host numpy), then
    move the tables to ``device``. Each (entity, LOD) face block is padded
    to a CLUSTER multiple with degenerate faces, so every binning cluster
    is (entity, LOD)-pure."""
    device = resolve_device(device)
    entity_model = _np(entity_model)
    entity_active = _np(entity_active)
    vs, ns, bc, rm, em, ve = [], [], [], [], [], []
    uvs, tgs, tids, fbms, eids = [], [], [], [], []
    fs, fe, fl, fp = [], [], [], []
    E = len(entity_model)
    aabbs = np.zeros((E, 2, 3), np.float32)
    ent_flat = np.zeros((E, 9), np.float32)
    any_material = any(
        m.uv is not None or m.tex_id >= 0 or m.mat_fbm is not None
        for m in models)
    flat_eligible = not any_material
    voff = 0
    for ei, (mi, act) in enumerate(zip(entity_model, entity_active)):
        if not act:
            continue
        m = models[int(mi)]
        V = len(m.verts)
        if V == 0:
            continue
        if (np.ptp(m.base_color, axis=0).max(initial=0.0) > 0
                or np.ptp(m.rough_metal, axis=0).max(initial=0.0) > 0
                or np.ptp(m.emission, axis=0).max(initial=0.0) > 0):
            flat_eligible = False
        else:
            ent_flat[ei, 0:3] = m.base_color[0]
            ent_flat[ei, 3:5] = m.rough_metal[0]
            ent_flat[ei, 5:8] = m.emission[0]
            if entity_edge_id is not None:
                ent_flat[ei, 8] = float(entity_edge_id[ei])
        vs.append(m.verts)
        ns.append(m.normals)
        bc.append(m.base_color)
        rm.append(m.rough_metal)
        em.append(m.emission)
        uvs.append(m.uv if m.uv is not None else np.zeros((V, 2), np.float32))
        tgs.append(m.tangent if m.tangent is not None
                   else np.tile(np.array([1, 0, 0, 1], np.float32), (V, 1)))
        tids.append(np.full(V, float(m.tex_id), np.float32))
        fbms.append(np.tile(np.asarray(
            m.mat_fbm if m.mat_fbm is not None else (0.0,) * 6,
            np.float32), (V, 1)))
        if entity_edge_id is not None:
            eids.append(np.full(V, float(entity_edge_id[ei]), np.float32))
        ve.append(np.full(V, ei, np.int32))
        for lod, faces in enumerate(m.lod_faces):
            n = len(faces)
            pad = (-n) % CLUSTER
            fs.append(faces.astype(np.int64) + voff)
            if pad:
                fs.append(np.full((pad, 3), voff, np.int64))
            fe.append(np.full(n + pad, ei, np.int32))
            fl.append(np.full(n + pad, lod, np.int32))
            fp.append(np.arange(n + pad) >= n)
        aabbs[ei, 0] = m.verts.min(0)
        aabbs[ei, 1] = m.verts.max(0)
        voff += V

    def t(a, dtype=None):
        a = np.asarray(a)
        if dtype is not None:
            a = a.astype(dtype)
        return torch.as_tensor(a, device=device)

    def cat(xs, d=np.float32):
        return t(np.concatenate(xs) if xs else np.zeros((0,), d), d)

    fe_np = np.concatenate(fe) if fe else np.zeros((0,), np.int32)
    fl_np = np.concatenate(fl) if fl else np.zeros((0,), np.int32)
    fp_np = np.concatenate(fp) if fp else np.zeros((0,), bool)
    fs_np = (np.concatenate(fs).astype(np.int32) if fs
             else np.zeros((0, 3), np.int32))
    coarse = np.zeros(E, np.int64)
    np.maximum.at(coarse, fe_np, fl_np)
    ssel = (fl_np == coarse[fe_np]) & ~fp_np
    sta_faces = None
    if entity_shadow_static is not None:
        sta = _np(entity_shadow_static).astype(bool)
        sta_faces = t(fs_np[ssel & sta[fe_np]], np.int32)
        ssel = ssel & ~sta[fe_np]

    cl_entity = cl_lod = cl_rest = cl_aabb = sc_rest = sc_ent = None
    if fs_np.shape[0] > 0:
        Tn = fs_np.shape[0]
        Tcn = Tn // CLUSTER
        cl_e = fe_np.reshape(Tcn, CLUSTER)
        cl_l = fl_np.reshape(Tcn, CLUSTER)
        if not ((cl_e == cl_e[:, :1]).all() and (cl_l == cl_l[:, :1]).all()):
            raise AssertionError("face blocks not cluster-pure")
        cl_entity = t(cl_e[:, 0], np.int32)
        cl_lod = t(cl_l[:, 0], np.int32)
        vcat = np.concatenate(vs)
        ncat = np.concatenate(ns)
        comps = []
        for c in range(3):
            p = vcat[fs_np[:, c]]
            q = ncat[fs_np[:, c]]
            comps += [p[:, 0], p[:, 1], p[:, 2], q[:, 0], q[:, 1], q[:, 2]]
        stk = np.stack(comps)                        # (18, T)
        cl_rest = t(stk.reshape(18, Tcn, CLUSTER).transpose(1, 0, 2)
                    .reshape(Tcn, 18 * CLUSTER), np.float32)
        cxyz = stk[[0, 1, 2, 6, 7, 8, 12, 13, 14]].reshape(3, 3, Tcn, CLUSTER)
        cmin = cxyz.min(axis=(0, 3)).T
        cmax = cxyz.max(axis=(0, 3)).T
        cl_aabb = t(np.concatenate([(cmin + cmax) * 0.5,
                                    (cmax - cmin) * 0.5], axis=1),
                    np.float32)
        sfaces_np = fs_np[ssel]
        sc_rest = t(vcat[sfaces_np[:, [0, 2, 1]].reshape(-1)], np.float32)
        sc_ent = t(np.repeat(fe_np[ssel], 3), np.int32)
    return RenderTables(
        verts=cat(vs), normals=cat(ns), base_color=cat(bc),
        rough_metal=cat(rm), emission=cat(em),
        uv=cat(uvs), tangent=cat(tgs), tex_id=cat(tids),
        mat_fbm=cat(fbms), any_material=bool(any_material),
        vert_entity=cat(ve, np.int32),
        faces=t(fs_np, np.int32),
        face_entity=cat(fe, np.int32),
        face_lod=cat(fl, np.int32),
        entity_aabb=t(aabbs, np.float32),
        ent_max_lod=t(coarse, np.int32),
        edge_id=cat(eids) if entity_edge_id is not None else None,
        shadow_faces=t(fs_np[ssel], np.int32),
        shadow_face_entity=t(fe_np[ssel], np.int32),
        ent_flat=t(ent_flat, np.float32),
        flat_eligible=bool(flat_eligible),
        static_shadow_faces=sta_faces,
        cl_entity=cl_entity, cl_lod=cl_lod, cl_rest=cl_rest,
        cl_aabb=cl_aabb,
        shadow_corner_rest=sc_rest, shadow_corner_entity=sc_ent,
    )


def kernel_attrs_ok(rt: RenderTables) -> bool:
    """Static eligibility for kernel-side attribute interpolation: flat
    per-entity materials and float-exact packed ids (2T·stride < 2^24)."""
    stride = ent_pack_stride(rt.entity_aabb.shape[0])
    return bool(rt.flat_eligible
                and 2 * rt.faces.shape[0] * stride < 1 << 24)


def _xform_rows(g, p):
    """Apply per-row 3×4 matrices g (..., 12) to points p (..., 3) with the
    JAX package's operation order."""
    return torch.stack(
        [g[..., 4 * i] * p[..., 0] + g[..., 4 * i + 1] * p[..., 1]
         + g[..., 4 * i + 2] * p[..., 2] + g[..., 4 * i + 3]
         for i in range(3)], dim=-1)


def _entity_cull_lod(rt: RenderTables, entity_mx, entity_visible,
                     cam_planes, cam_pos, skip_culling=None,
                     lod_scale: float = 1.0):
    """Per-env per-entity frustum cull + distance LOD. Returns (ent_ok
    (B, E) bool, lod (B, E) int32, rot (B, E, 3, 3))."""
    c = 0.5 * (rt.entity_aabb[:, 0] + rt.entity_aabb[:, 1])
    e = 0.5 * (rt.entity_aabb[:, 1] - rt.entity_aabb[:, 0])
    rot = entity_mx[..., :3, :3]
    wc = (rot @ c[:, :, None])[..., 0] + entity_mx[..., :3, 3]
    we = (torch.abs(rot) @ e[:, :, None])[..., 0]
    in_frustum = aabb_in_frustum(cam_planes, wc - we, wc + we)
    if skip_culling is not None:
        in_frustum = in_frustum | skip_culling[None, :]
    dd = wc - cam_pos[:, None, :]
    dist = torch.sqrt(torch.sum(dd * dd, dim=-1))
    dists = mx.const(LOD_DISTANCES, dist.device) * lod_scale
    lod = torch.sum(dist[..., None] > dists, dim=-1).to(torch.int32)
    lod = torch.clamp(lod, max=LOD_MAX - 1)
    if rt.ent_max_lod is not None:
        lod = torch.minimum(lod, rt.ent_max_lod[None, :])
    return entity_visible & in_frustum, lod, rot


def assemble_cluster_records_batch(rt: RenderTables, entity_mx,
                                   entity_visible, cam_planes, cam_pos,
                                   views, proj, cap: int = 24576,
                                   skip_culling=None,
                                   cluster_cull: bool = True,
                                   char_skin=None, joint_mats=None,
                                   lod_scale: float = 1.0) -> SceneGeometry:
    """Cluster-granularity batched record front end (kernel-attrs path).

    entity_mx (B, E, 4, 4), entity_visible (B, E), cam_planes (B, 6, 4),
    cam_pos (B, 3), views (B, 4, 4), proj (4, 4). Per env: cluster
    validity from entity cull + LOD, per-cluster frustum cull, stable
    valid-first compaction to ``cap // CLUSTER`` clusters, and the
    world+clip transform of the kept clusters' rest-pose corners. Returns
    a batched SceneGeometry carrying ``comp`` (B, 21, T), ``comp_valid``,
    ``comp_ent`` and the world-space dynamic shadow corner stream.

    char_skin (CharSkin) + joint_mats (B, C, J, 4, 4): skinned characters.
    The chars' rigid clusters are masked off (``char_skin.cl_skinned``,
    built with the CharSkin), an LBS-deformed per-env range of C·Tp
    records is concatenated onto the compacted stream, and the chars' rows
    of the shadow corner stream are replaced by skinned corners."""
    if rt.cl_rest is None or not rt.flat_eligible:
        raise ValueError("cluster records need cl_rest tables and "
                         "flat-eligible materials (kernel_attrs mode)")
    dev = entity_mx.device
    B, E = entity_mx.shape[:2]
    L = LOD_MAX
    ent_ok, lod, rot = _entity_cull_lod(rt, entity_mx, entity_visible,
                                        cam_planes, cam_pos, skip_culling,
                                        lod_scale)
    ok_el = ent_ok[..., None] & (lod[..., None]
                                 == torch.arange(L, device=dev))
    idx = (rt.cl_entity * L + rt.cl_lod).long()
    cv = ok_el.reshape(B, E * L)[:, idx]                     # (B, Tc)
    if char_skin is not None:
        # the skinned range below replaces the chars' rigid clusters
        cv = cv & ~char_skin.cl_skinned[None, :]
    Tc = idx.shape[0]
    capc = min(cap // CLUSTER, Tc)
    packed = entity_mx[..., :3, :].reshape(B, E, 12)

    if cluster_cull and rt.cl_aabb is not None:
        gm = packed[:, rt.cl_entity.long()]                   # (B, Tc, 12)
        cc, ce = rt.cl_aabb[:, :3], rt.cl_aabb[:, 3:]
        wc = _xform_rows(gm, cc)
        we = torch.stack(
            [torch.abs(gm[..., 4 * i]) * ce[:, 0]
             + torch.abs(gm[..., 4 * i + 1]) * ce[:, 1]
             + torch.abs(gm[..., 4 * i + 2]) * ce[:, 2] for i in range(3)],
            dim=-1)
        n = cam_planes[..., :3]
        d = cam_planes[..., 3]
        dist = torch.einsum("bpk,btk->btp", n, wc) + d[:, None, :] \
            + torch.einsum("bpk,btk->btp", torch.abs(n), we)
        in_fr = torch.all(dist >= 0.0, dim=-1)
        if skip_culling is not None:
            in_fr = in_fr | skip_culling[rt.cl_entity.long()][None, :]
        cv = cv & in_fr

    # valid-first stable compaction (kept clusters stay in stream order)
    sidx = torch.sort((~cv).to(torch.int8), dim=-1, stable=True)[1]
    keep = sidx[:, :capc]
    nval = torch.clamp(cv.sum(-1), max=capc)
    kvalid = torch.arange(capc, device=dev)[None, :] < nval[:, None]

    rows = rt.cl_rest[keep].reshape(B, capc, 18, CLUSTER)
    centi = rt.cl_entity[keep]                                # (B, capc)
    vp = proj @ views                                         # (B, 4, 4)
    F = (vp[:, None] @ entity_mx).reshape(B, E, 16)
    fc = torch.gather(F, 1, centi.long()[..., None].expand(B, capc, 16))
    T = capc * CLUSTER
    comp = []
    for c in range(3):
        X, Y, Z = (rows[:, :, c * 6 + k] for k in range(3))  # (B, capc, 8)
        for j in range(4):
            f = fc[:, :, 4 * j:4 * j + 4, None]
            comp.append((f[:, :, 0] * X + f[:, :, 1] * Y + f[:, :, 2] * Z
                         + f[:, :, 3]).reshape(B, T))
        for k in range(3):
            comp.append(rows[:, :, c * 6 + 3 + k].reshape(B, T))
    comp = torch.stack(comp, dim=1)                           # (B, 21, T)
    comp_valid = kvalid.repeat_interleave(CLUSTER, dim=-1)
    comp_ent = centi.repeat_interleave(CLUSTER, dim=-1)

    gs = packed[:, rt.shadow_corner_entity.long()]            # (B, 3Ts, 12)
    swc = _xform_rows(gs, rt.shadow_corner_rest)
    sfv = entity_visible[:, rt.shadow_face_entity.long()]

    if char_skin is not None:
        from .charskin import apply_shadow_skin, skin_records

        comp_s, valid_s, ent_s, sh_world = skin_records(
            char_skin, joint_mats, entity_mx, views, proj, entity_visible)
        comp = torch.cat([comp, comp_s], dim=-1)
        comp_valid = torch.cat([comp_valid, valid_s], dim=-1)
        comp_ent = torch.cat([comp_ent, ent_s], dim=-1)
        swc = apply_shadow_skin(swc, char_skin, sh_world)

    z3 = torch.zeros((0, 3), device=dev)
    return SceneGeometry(
        verts=z3, normals=z3, faces=torch.zeros((0, 3), dtype=torch.int32,
                                                device=dev),
        face_valid=torch.zeros((0,), dtype=torch.bool, device=dev),
        base_color=z3, rough_metal=z3[:, :2], emission=z3,
        comp=comp, comp_valid=comp_valid, comp_ent=comp_ent,
        ent_rot=rot, ent_flat=rt.ent_flat,
        shadow_faces=rt.shadow_faces, shadow_face_valid=sfv,
        shadow_corner_verts=swc,
    )


def assemble_scene_geometry_batch(rt: RenderTables, entity_mx,
                                  entity_visible, cam_planes, cam_pos,
                                  skip_culling=None, char_skin=None,
                                  joint_mats=None,
                                  lod_scale: float = 1.0) -> SceneGeometry:
    """Member-granularity batched assembly (the per-pixel gather path):
    B envs with their own entity transforms, visibility and cameras over
    the one shared instance table.

    Per env: world vertices (B, Vi, 3), face validity (B, Ti) from entity
    cull + LOD, shadow-caster validity (B, Ts) from visibility alone, and
    the entity rotations (B, E, 3, 3); every attribute table stays shared
    and model-local (the model pass rotates normals per pixel by the
    face's entity). char_skin + joint_mats (B, C, J, 4, 4): the chars'
    vertex blocks are replaced by LBS-deformed world positions; their
    shading normals stay rest-pose on this path, as in the JAX package."""
    B, E = entity_mx.shape[:2]
    L = LOD_MAX
    packed = entity_mx[..., :3, :].reshape(B, E, 12)
    wverts = _xform_rows(packed[:, rt.vert_entity.long()], rt.verts)
    if char_skin is not None:
        from .charskin import skin_vertex_rows

        w_skin, _ = skin_vertex_rows(char_skin, joint_mats, entity_mx)
        V = char_skin.n_verts
        for c, r0 in enumerate(char_skin.vert_row0):
            wverts[:, r0:r0 + V] = w_skin[:, c]

    ent_ok, lod, rot = _entity_cull_lod(rt, entity_mx, entity_visible,
                                        cam_planes, cam_pos, skip_culling,
                                        lod_scale)
    ok_el = ent_ok[..., None] & (lod[..., None]
                                 == torch.arange(L, device=lod.device))
    fv = ok_el.reshape(B, E * L)[:, (rt.face_entity * L + rt.face_lod).long()]
    sfv = entity_visible[:, rt.shadow_face_entity.long()]
    mat = rt.any_material
    return SceneGeometry(
        verts=wverts, normals=rt.normals, faces=rt.faces, face_valid=fv,
        base_color=rt.base_color, rough_metal=rt.rough_metal,
        emission=rt.emission,
        uv=rt.uv if mat else None, tangent=rt.tangent if mat else None,
        tex_id=rt.tex_id if mat else None,
        local_pos=rt.verts if mat else None,
        mat_fbm=rt.mat_fbm if mat else None,
        edge_id=rt.edge_id, face_entity=rt.face_entity, ent_rot=rot,
        ent_flat=rt.ent_flat if rt.flat_eligible else None,
        shadow_faces=rt.shadow_faces, shadow_face_valid=sfv)


def _unit_rows(v):
    return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)),
                           min=1e-6)


def assemble_scene_geometry(rt: RenderTables, entity_mx, entity_visible,
                            cam_planes, cam_pos, skip_culling=None,
                            char_skin=None, joint_mats=None) -> SceneGeometry:
    """Single-env per-frame assembly (models_render model.c:969-998), the
    game frame's: every instance vertex transformed by its entity matrix,
    world-space normals (and tangents where the tables carry materials),
    per-entity frustum cull and distance LOD, and the static shadow-caster
    stream valid by visibility alone.

    entity_mx (E, 4, 4), entity_visible (E,), cam_planes (6, 4), cam_pos
    (3,). char_skin + joint_mats (C, J, 4, 4): the chars' vertex blocks
    take LBS-deformed world positions and normals (both exact on this
    path). Returns the geometry of one env as ``render_frame`` takes it at
    B = 1: verts (1, V, 3), face_valid (1, T), shadow_face_valid (1, Ts);
    normals, tangents and the material tables shared."""
    m = entity_mx[:, :3, :][rt.vert_entity.long()]             # (V, 3, 4)
    rot = m[:, :, :3]
    wverts = (rot @ rt.verts[:, :, None])[..., 0] + m[:, :, 3]
    wnorm = _unit_rows((rot @ rt.normals[:, :, None])[..., 0])
    if char_skin is not None:
        from .charskin import skin_vertex_rows

        w_skin, snl = skin_vertex_rows(char_skin, joint_mats, entity_mx)
        emx = entity_mx[char_skin.char_ents.long()]           # (C, 4, 4)
        wn = _unit_rows(snl @ emx[:, :3, :3].transpose(-1, -2))
        V = char_skin.n_verts
        for c, r0 in enumerate(char_skin.vert_row0):
            wverts[r0:r0 + V] = w_skin[c]
            wnorm[r0:r0 + V] = wn[c]
    wtan = None
    if rt.any_material:
        wt = _unit_rows((rot @ rt.tangent[:, :3, None])[..., 0])
        wtan = torch.cat([wt, rt.tangent[:, 3:4]], dim=-1)

    ent_ok, lod, _ = _entity_cull_lod(rt, entity_mx[None],
                                      entity_visible[None], cam_planes[None],
                                      cam_pos[None], skip_culling)
    fe = rt.face_entity.long()
    fv = ent_ok[:, fe] & (rt.face_lod[None] == lod[:, fe])
    sfv = entity_visible[rt.shadow_face_entity.long()][None]
    mat = rt.any_material
    return SceneGeometry(
        verts=wverts[None], normals=wnorm, faces=rt.faces, face_valid=fv,
        base_color=rt.base_color, rough_metal=rt.rough_metal,
        emission=rt.emission, uv=rt.uv if mat else None, tangent=wtan,
        tex_id=rt.tex_id if mat else None,
        local_pos=rt.verts if mat else None,
        mat_fbm=rt.mat_fbm if mat else None, edge_id=rt.edge_id,
        shadow_faces=rt.shadow_faces, shadow_face_valid=sfv)


def static_shadow_geometry(rt: RenderTables, entity_mx0, light_dir,
                           far: float = 200.0):
    """The static casters at their load pose (entity_mx0 (E, 4, 4)) as a
    one-env SceneGeometry, and the bounds-fit ortho light view over them.
    Returns (geom, Subview with one cascade, cascade_dists (1,))."""
    from .view import bounds_light_subview

    if rt.static_shadow_faces is None or rt.static_shadow_faces.shape[0] == 0:
        raise ValueError("no static shadow stream: build_render_tables "
                         "needs entity_shadow_static")
    dev = rt.verts.device
    T = rt.static_shadow_faces
    used = torch.zeros(rt.verts.shape[0], dtype=torch.bool, device=dev)
    used[T.reshape(-1).long()] = True
    E = entity_mx0.shape[0]
    g = entity_mx0[:, :3, :].reshape(E, 12)[rt.vert_entity.long()]
    m = g.reshape(-1, 3, 4)
    wverts = (m[:, :, :3] @ rt.verts[:, :, None])[..., 0] + m[:, :, 3]
    wsub = wverts[used]
    sv, cd = bounds_light_subview(wsub.amin(0) - 1.0, wsub.amax(0) + 1.0,
                                  light_dir, far=far)
    ones_t = torch.ones((1, T.shape[0]), dtype=torch.bool, device=dev)
    zeros_v = torch.zeros_like(wverts)[None]
    geom = SceneGeometry(
        verts=wverts[None], normals=zeros_v, faces=T, face_valid=ones_t,
        base_color=zeros_v, rough_metal=zeros_v[..., :2], emission=zeros_v,
        shadow_faces=T, shadow_face_valid=ones_t)
    return geom, sv, cd


def bake_static_shadow(rt: RenderTables, entity_mx0, light_dir,
                       shadow_size: int = 1024, far: float = 200.0):
    """Render the STATIC casters' shadow atlas once (one K2 launch): a
    single bounds-fit ortho light view over the static geometry at its
    load pose. Static geometry under a fixed directional light is a
    constant shadow map, so per-frame passes raster only the dynamic
    casters and multiply the two factors. Returns (moments (1, S, S, 2),
    mvps (1, 4, 4), cascade_dists (1,)) — the ``static_shadow`` triple."""
    from .pipeline import RenderOptions, shadow_pass_all

    geom, sv, cd = static_shadow_geometry(rt, entity_mx0, light_dir, far)
    opts = RenderOptions(shadow_size=shadow_size)
    moments = shadow_pass_all(opts, geom, sv.view[None], sv.proj[None])[0]
    return moments, sv.proj @ sv.view, cd
