"""Frame graph (counterpart of clap_tpu/render/pipeline.py; reference
core/pipeline.c + pipeline-builder.c:182-613).

Each pass is a function over batched image tensors and the "graph" is
function composition assembled from RenderOptions. The canonical chain:

  4-cascade shadow atlas (K2; ``shadow_msaa`` rasters it at f× and pools
  the moments) → model pass (K1 G-buffer; surface attributes either
  kernel-interpolated normals with per-entity flat materials —
  ``kernel_attrs`` over cluster records — or the per-pixel gather of
  interpolated vertex attributes with textures, TBN and material fBm —
  member-granularity geometry; deferred GGX with the static × dynamic
  shadow factor, VSM at quarter resolution or PCF at full; material fog)
  → particles (K1 on billboard records, depth-tested, blended) → sobel or
  laplace edges → SMAA-lite → shift or hemisphere-kernel SSAO → bloom →
  fog (noise-tinted) → contrast → LUT → ACES → outlines → film grain →
  sRGB OETF. ``internal_scale`` renders all of it at 1/s², ``model_msaa``
  at f² the pixels and box-resolves.

Every function takes a leading env axis B; there is one K1 launch per
raster pass and one K2 launch per shadow pass for all envs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from .. import mathx as mx
from ..ops.noise import fog_cloud, noise3d_field, noise_glsl
from ..ops.particles import particle_clip_quads
from . import post, shade
from .lut import apply_lut
from .lights import Lights, light_grid
from .raster import (CLUSTER, GBuffer, assemble_tri_records, bin_triangles,
                     clip_near_records, compact_faces, corner_records,
                     ent_pack_stride, project_to_screen, rasterize,
                     rasterize_attrs, rasterize_depth, tile_dims)
from .view import bounds_light_subview, cascade_subviews


@dataclass(frozen=True)
class RenderOptions:
    """render_options (pipeline.h:15-57): the JAX package's RenderOptions
    and defaults."""

    width: int = 1280
    height: int = 720
    shadow_size: int = 1024
    shadow_vsm: bool = True
    ssao: bool = True
    ssao_mode: str = "shift"
    bloom: bool = True
    edge_aa: bool = True
    edge_sobel: bool = True
    lighting_lut: bool = False
    hdr: bool = False
    bloom_intensity: float = 1.0
    bloom_threshold: float = 1.0
    lighting_exposure: float = 1.0
    contrast: float = 0.1
    fog_near: float = 80.0
    fog_far: float = 160.0
    fog_color: tuple = (0.58, 0.68, 0.78)
    record_compact: int = 0
    internal_scale: int = 1
    model_msaa: int = 1
    shadow_msaa: int = 1
    fog_noise: bool = False
    material_fog: bool = False
    fog_3d_amp: float = 1.0          # material fog: fog_cloud amplitude
    fog_3d_scale: float = 0.05       # and frequency
    film_grain: float = 0.03
    tonemap_aces: bool = True
    shadow_outline_threshold: float = 0.5
    outline_strength: float = 0.35
    raster_cap: int = 0
    attr_bf16: bool = False     # the gather path's per-triangle table in bf16
    kernel_attrs: bool = False


class SceneGeometry(NamedTuple):
    """Render geometry (fields as in the JAX package). In the batched
    cluster-record path ``comp``/``comp_valid``/``comp_ent``,
    ``ent_rot``, ``shadow_face_valid`` and ``shadow_corner_verts`` carry a
    leading env axis; tables (faces, ent_flat, shadow_faces) are shared.
    In the member-granularity path the ``PER_ENV`` fields (``verts``,
    ``face_valid``, ``ent_rot``, ``shadow_face_valid`` and the corner
    streams ``corner_verts`` / ``shadow_corner_verts``) are per env; the
    attribute tables (model-local normals, ``corner_normals``, materials,
    uv, ...) and faces are shared.

    Corner streams (static geometry, ``expand_corners_*``):
    ``corner_verts`` / ``corner_normals`` corner-MAJOR over ``faces``
    (clip_near_records' layout), ``shadow_corner_verts`` in RECORD order
    over the shadow face stream (assemble_tri_records' layout)."""

    verts: torch.Tensor
    normals: torch.Tensor
    faces: torch.Tensor
    face_valid: torch.Tensor
    base_color: torch.Tensor
    rough_metal: torch.Tensor
    emission: torch.Tensor
    uv: torch.Tensor = None
    tangent: torch.Tensor = None
    tex_id: torch.Tensor = None
    local_pos: torch.Tensor = None
    mat_fbm: torch.Tensor = None
    edge_id: torch.Tensor = None
    face_entity: torch.Tensor = None
    ent_rot: torch.Tensor = None
    shadow_faces: torch.Tensor = None
    shadow_face_valid: torch.Tensor = None
    ent_flat: torch.Tensor = None
    corner_verts: torch.Tensor = None
    corner_normals: torch.Tensor = None
    shadow_corner_verts: torch.Tensor = None
    comp: torch.Tensor = None
    comp_valid: torch.Tensor = None
    comp_ent: torch.Tensor = None


# the member-granularity fields that carry a leading env axis
PER_ENV = ("verts", "face_valid", "ent_rot", "shadow_face_valid",
           "corner_verts", "shadow_corner_verts")


def per_env(geom: SceneGeometry, n: int) -> SceneGeometry:
    """The geometry of ONE shared scene (``PER_ENV`` fields without an env
    axis) as ``n`` envs: expanded views, nothing copied."""
    return geom._replace(**{
        f: getattr(geom, f).expand(n, *getattr(geom, f).shape)
        for f in PER_ENV if getattr(geom, f) is not None})


def _check_corners(geom: SceneGeometry):
    """A corner stream built over a different face table would render the
    wrong triangles."""
    if geom.corner_verts is not None \
            and geom.corner_verts.shape[-2] != 3 * geom.faces.shape[0]:
        raise ValueError("corner_verts does not match the face stream")


class TextureSets(NamedTuple):
    """Per-model texture layers (model3dtx's diffuse/normal/emission set,
    model.h:213-223), stacked and indexed by SceneGeometry.tex_id."""

    diffuse: torch.Tensor              # (L, S, S, 3)
    normal: torch.Tensor = None        # (L, S, S, 3) tangent space, [0, 1]
    emission: torch.Tensor = None      # (L, S, S, 3)
    # terrain atlas layers (terrain.frag:39-46): diffuse is a 2×2 atlas,
    # grass at the origin quadrant and rock at +0.5, blended by slope
    slope_blend: torch.Tensor = None   # (L,) bool


def clip_transform(verts, view, proj):
    """World points (B, V, 3) → clip (B, V, 4) with per-env view (B, 4, 4)
    and a shared or per-env proj. Each row is summed in pairs,
    (m0·x + m1·y) + (m2·z + m3), the order of the JAX package's einsum on
    the CPU: sliver triangles amplify one ulp of a corner into depth."""
    vp = (proj @ view)[..., None, :, :]                    # (B, 1, 4, 4)
    x, y, z = (verts[..., i, None] for i in range(3))
    return (vp[..., 0] * x + vp[..., 1] * y) + (vp[..., 2] * z + vp[..., 3])


def shadow_records(opts: RenderOptions, geom: SceneGeometry, casc_views,
                   casc_projs):
    """The two-sided depth records of every env's cascade atlas and their
    band-clamped binning. Returns (rec, binned, (width, height, tile_h,
    tile_w)) — the atlas is (C·S, S), cascade c in rows [c·S, (c+1)·S),
    with S = shadow_size · shadow_msaa."""
    s = opts.shadow_size * max(opts.shadow_msaa, 1)
    B, n_casc = casc_views.shape[:2]
    if geom.shadow_faces is not None:
        faces0, valid0 = geom.shadow_faces, geom.shadow_face_valid
    else:
        faces0, valid0 = geom.faces, geom.face_valid
    pre = geom.shadow_corner_verts is not None
    pad = (-faces0.shape[0]) % CLUSTER
    dev = casc_views.device
    if pad:
        faces0 = torch.cat([faces0, faces0.new_zeros(pad, 3)])
        valid0 = torch.cat([valid0, valid0.new_zeros(*valid0.shape[:-1],
                                                     pad)], dim=-1)
    if pre:
        # pad rows project with w = 1; only valid0's pad entries keep them
        # out
        src = geom.shadow_corner_verts
        if src.shape[-2] != 3 * (faces0.shape[0] - pad):
            raise ValueError("shadow_corner_verts does not match the "
                             "shadow face stream")
        if pad:
            src = torch.cat([src, src.new_zeros(*src.shape[:-2], 3 * pad,
                                                3)], dim=-2)
    else:
        src = geom.verts
    sxs, sys_, zs, iws = [], [], [], []
    for c in range(n_casc):
        clip = clip_transform(src, casc_views[:, c], casc_projs[:, c])
        sx, sy, z, iw = project_to_screen(clip, s, s)
        sxs.append(sx)
        sys_.append(sy + c * s)       # atlas band offset
        zs.append(z)
        iws.append(iw)
    sx, sy, z, iw = (torch.cat(a, dim=-1) for a in (sxs, sys_, zs, iws))
    V = src.shape[-2]
    faces = None if pre else \
        torch.cat([faces0 + c * V for c in range(n_casc)])
    valid = torch.cat([valid0] * n_casc, dim=-1)
    rec, ok = assemble_tri_records(sx, sy, z, iw, faces, valid,
                                   two_sided=True, pre_expanded=pre)
    th, tw = tile_dims(s, n_casc * s)
    T = faces0.shape[0]
    band = torch.arange(n_casc, dtype=torch.int32,
                        device=dev).repeat_interleave(T)
    binned = bin_triangles(rec, ok, s, n_casc * s, band_id=band,
                           band_tiles=s // th, tile_h=th, tile_w=tw)
    return rec, binned, (s, n_casc * s, th, tw)


def shadow_pass(opts: RenderOptions, geom: SceneGeometry, light_view,
                light_proj):
    """One cascade per env: depth-only raster → linearized VSM moments
    (d, d²) (shadow_vsm.frag:8-13). light_view / light_proj (B, 4, 4);
    returns (B, S, S, 2). ``shadow_pass_all`` with one cascade: one K2
    launch."""
    return shadow_pass_all(opts, geom, light_view[:, None],
                           light_proj[:, None])[:, 0]


def shadow_pass_all(opts: RenderOptions, geom: SceneGeometry, casc_views,
                    casc_projs):
    """All cascades of every env in ONE depth raster (one K2 launch) over a
    vertically stacked (C·S, S) atlas per env: casc_views/casc_projs
    (B, C, 4, 4). Returns (B, C, S, S, 2) linearized VSM moments; with
    ``shadow_msaa`` f the atlas is rastered at f·S and each cascade's
    moments are average-pooled back to S (moments are linear in coverage,
    so the pool is the multisample resolve)."""
    B, n_casc = casc_views.shape[:2]
    rec, binned, (w, h, th, tw) = shadow_records(opts, geom, casc_views,
                                                 casc_projs)
    depth = rasterize_depth(rec, binned, w, h, th, tw)
    d = torch.where(torch.isfinite(depth), depth * 0.5 + 0.5, 1.0)
    m = torch.stack([d, d * d], dim=-1).reshape(B * n_casc, w, w, 2)
    if opts.shadow_msaa > 1:
        m = post.downsample_pool(m, opts.shadow_msaa)
    return m.reshape(B, n_casc, *m.shape[1:])


def surface_records(opts: RenderOptions, geom: SceneGeometry, clip=None):
    """Near-clipped 22-column extras records (the model-local normal as
    extras, tid·stride + entity as id) and their binning: of every env's
    cluster-record geometry (``comp``), or of member-granularity geometry
    whose clip-space vertices (or corner stream) are ``clip`` (B, V, 4),
    its normals (or ``corner_normals``) the extras and ``face_entity`` the
    packed entity. Returns (rec, binned, stride)."""
    W, H = opts.width, opts.height
    if geom.ent_rot is None or geom.ent_flat is None \
            or (geom.face_entity is None and geom.comp is None):
        raise ValueError("kernel_attrs needs local-attrs geometry with "
                         "ent_flat (RenderTables.flat_eligible)")
    n_ent = geom.ent_rot.shape[-3]
    T = geom.comp.shape[-1] if geom.comp is not None else geom.faces.shape[0]
    stride = ent_pack_stride(n_ent)
    if 2 * T * stride >= 1 << 24:
        raise ValueError(
            f"kernel_attrs limit exceeded: T={T} with E={n_ent} "
            f"(stride {stride}) needs 2·T·stride < 2^24")
    if geom.comp is not None:
        comps = [[geom.comp[:, c * 7 + i] for i in range(7)]
                 for c in range(3)]
        rec, ok, _csrc, _ = clip_near_records(
            None, None, W, H, geom.comp_valid, tid_pack=geom.comp_ent,
            pack_stride=stride, components=comps)
    else:
        pre = geom.corner_verts is not None
        vex = geom.normals
        if pre:
            if geom.corner_normals is None:
                raise ValueError("corner_verts without corner_normals: "
                                 "kernel_attrs interpolates normals")
            _check_corners(geom)
            vex = geom.corner_normals
        faces, fvalid, fent = geom.faces, geom.face_valid, geom.face_entity
        if opts.record_compact and not pre:
            faces, fvalid, fent = compact_faces(
                faces, fvalid, opts.record_compact, extra=fent.int())
        rec, ok, _csrc, _ = clip_near_records(
            clip, faces, W, H, fvalid, vextra=vex, tid_pack=fent,
            pack_stride=stride, pre_expanded=pre)
    binned = bin_triangles(rec, ok, W, H, cap=opts.raster_cap or None)
    return rec, binned, stride


def _surface_kernel_attrs(opts: RenderOptions, geom: SceneGeometry,
                          clip=None):
    """Kernel-side attribute interpolation (``surface_records``): K1
    interpolates iw·(model-local normal) in its d0/d1/s planes and carries
    tid·stride + entity in its float id; every other attribute is
    per-entity flat (geom.ent_flat), looked up per pixel by entity id."""
    W, H = opts.width, opts.height
    rec, binned, stride = surface_records(opts, geom, clip)
    B = rec.shape[0]
    n_ent = geom.ent_rot.shape[-3]
    depth, pid, nraw = rasterize_attrs(rec, binned, W, H)
    gb = GBuffer(depth=depth, tri_id=pid,
                 bary=torch.zeros(pid.shape + (2,), device=pid.device))
    hit_px = pid >= 0
    # background → the appended all-zero row (the reference's one-hot
    # lookup matches no entity there)
    ent = torch.where(hit_px, torch.remainder(pid, stride), n_ent).long()
    rot = geom.ent_rot.expand(B, n_ent, 3, 3).reshape(B, n_ent, 9)
    tbl = torch.cat([rot, geom.ent_flat.expand(B, n_ent, 9)], dim=-1)
    tbl = torch.cat([tbl, tbl.new_zeros(B, 1, 18)], dim=1)
    px = torch.gather(tbl, 1, ent.reshape(B, -1, 1).expand(-1, -1, 18)
                      ).reshape(*ent.shape, 18)
    Rpx = px[..., :9].reshape(*ent.shape, 3, 3)
    nrm = (Rpx @ nraw[..., None])[..., 0]
    nrm = nrm / torch.clamp(
        torch.sqrt(torch.sum(nrm * nrm, -1, keepdim=True)), min=1e-6)
    eid_px = px[..., 17] if geom.edge_id is not None else None
    return (gb, nrm, px[..., 9:12], px[..., 12], px[..., 13],
            px[..., 14:17], eid_px)


def gather_records(opts: RenderOptions, geom: SceneGeometry, clip):
    """Near-clipped 19-column barycentric records of every env's member-
    granularity geometry (clip (B, V, 4), or (B, 3T, 4) of a corner
    stream) and their binning, after the valid-first face compaction of
    ``opts.record_compact`` (none on a corner stream). Returns (rec,
    binned, faces, face_entity, csrc): faces (B, T, 3) and
    face_entity (B, T) per env when compacted, else the shared tables."""
    W, H = opts.width, opts.height
    pre = geom.corner_verts is not None
    _check_corners(geom)
    faces, fvalid, face_entity = geom.faces, geom.face_valid, \
        geom.face_entity
    if opts.record_compact and not pre:
        faces, fvalid, face_entity = compact_faces(
            faces, fvalid, opts.record_compact, extra=face_entity)
    rec, ok, csrc, _ = clip_near_records(clip, faces, W, H, fvalid,
                                         pre_expanded=pre)
    binned = bin_triangles(rec, ok, W, H, cap=opts.raster_cap or None)
    return rec, binned, faces, face_entity, csrc


def texture_layer(tex_id_px):
    """Each pixel's texture layer from its interpolated per-vertex tex_id
    (-1: untextured). Returns (layer int32, textured bool). A constant id
    k interpolates to k - 1 ulp on about 5 % of pixels, so it is rounded;
    the JAX package truncates and samples layer k - 1 there."""
    return torch.floor(tex_id_px + 0.5).to(torch.int32), tex_id_px >= -0.5


def _surface_gather(opts: RenderOptions, geom: SceneGeometry, clip,
                    base_texture=None, textures=None):
    """Surface attributes through the per-pixel attribute gather (the
    general path: per-vertex materials, textures, TBN, material fBm): K1
    in barycentric mode, then one gather of the packed per-triangle record
    per pixel. World position is not interpolated (it comes from depth)."""
    W, H = opts.width, opts.height
    rec, binned, faces, face_entity, csrc = gather_records(opts, geom, clip)
    gb = rasterize(rec, binned, W, H)
    B = gb.tri_id.shape[0]

    # optional streams pack behind the core 11 columns
    streams = [geom.normals, geom.base_color, geom.rough_metal,
               geom.emission]
    off = {}
    cursor = 11
    textured = geom.uv is not None and (
        base_texture is not None or textures is not None)
    if textured:
        off["uv"] = cursor
        streams.append(geom.uv)
        cursor += 2
    tbn = (textures is not None and textures.normal is not None
           and geom.tangent is not None)
    if tbn:
        off["tangent"] = cursor
        streams.append(geom.tangent)
        cursor += 4
    if textures is not None and geom.tex_id is not None:
        off["tex_id"] = cursor
        streams.append(geom.tex_id[:, None].float())
        cursor += 1
    fbm_on = geom.mat_fbm is not None and geom.local_pos is not None
    if fbm_on:
        off["local"] = cursor
        streams.append(geom.local_pos)
        cursor += 3
        off["fbm"] = cursor
        streams.append(geom.mat_fbm)
        cursor += 6
    if geom.edge_id is not None:
        off["edge"] = cursor
        streams.append(geom.edge_id[:, None])
        cursor += 1
    vattrs = torch.cat(streams, dim=-1)
    local_mode = geom.ent_rot is not None and face_entity is not None
    tdt = torch.bfloat16 if opts.attr_bf16 else None
    Rpx = None
    if local_mode:
        # the face's entity rides the same gather as a flat column
        attrs, flat_px = shade.interpolate_attrs(
            gb, faces, vattrs, csrc,
            face_attrs=face_entity[..., None].float(), table_dtype=tdt)
        # model-local attributes rotate by the pixel's entity; background
        # (-1) and any id outside the table take the zero row
        n_ent = geom.ent_rot.shape[-3]
        fe = flat_px[..., 0].to(torch.int32)
        fe = torch.where((fe >= 0) & (fe < n_ent), fe, n_ent).long()
        tbl = torch.cat([geom.ent_rot.reshape(B, n_ent, 9),
                         geom.ent_rot.new_zeros(B, 1, 9)], dim=1)
        Rpx = torch.gather(tbl, 1, fe.reshape(B, -1, 1).expand(-1, -1, 9)
                           ).reshape(*fe.shape, 3, 3)
    else:
        attrs = shade.interpolate_attrs(gb, faces, vattrs, csrc,
                                        table_dtype=tdt)

    def rot(v):
        return v if Rpx is None else (Rpx @ v[..., None])[..., 0]

    def unit(v):
        return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)),
                               min=1e-6)

    nrm = unit(rot(attrs[..., 0:3]))
    base = attrs[..., 3:6]
    rough = attrs[..., 6]
    metal = attrs[..., 7]
    emission = attrs[..., 8:11]

    if textured:
        from .texture import sample_bilinear, sample_layered

        uv_px = attrs[..., off["uv"]:off["uv"] + 2]
        if textures is not None:
            if "tex_id" in off:
                lid, has_tex = texture_layer(attrs[..., off["tex_id"]])
            else:
                lid = torch.zeros(gb.tri_id.shape, dtype=torch.int32,
                                  device=gb.tri_id.device)
                has_tex = torch.ones_like(gb.tri_id, dtype=torch.bool)
            texel = sample_layered(textures.diffuse, lid, uv_px)
            if textures.slope_blend is not None:
                # grass/rock atlas blended by the geometric normal's slope
                # (terrain.frag:39-46)
                uv_q = torch.remainder(uv_px, 0.5)
                grass = sample_layered(textures.diffuse, lid, uv_q)
                rock = sample_layered(textures.diffuse, lid, uv_q + 0.5)
                fac = torch.clamp(nrm[..., 1], 0.0, 1.0)[..., None] ** 4
                sb = textures.slope_blend[torch.clamp(
                    lid, 0, textures.slope_blend.shape[0] - 1).long()]
                texel = torch.where(sb[..., None],
                                    grass * fac + rock * (1.0 - fac), texel)
            base = torch.where(has_tex[..., None], base * texel, base)
            if tbn:
                # TBN normal mapping (model.vert:54-67, lighting.glsl:174)
                t4 = attrs[..., off["tangent"]:off["tangent"] + 4]
                t = rot(t4[..., :3])
                t = unit(t - torch.sum(t * nrm, -1, keepdim=True) * nrm)
                b = torch.cross(nrm, t, dim=-1) * t4[..., 3:4]
                nm = sample_layered(textures.normal, lid, uv_px) * 2.0 - 1.0
                mapped = unit(t * nm[..., 0:1] + b * nm[..., 1:2]
                              + nrm * nm[..., 2:3])
                nrm = torch.where(has_tex[..., None], mapped, nrm)
            if textures.emission is not None:
                em_tex = sample_layered(textures.emission, lid, uv_px)
                emission = torch.where(has_tex[..., None],
                                       emission + em_tex, emission)
        else:
            base = base * sample_bilinear(base_texture, uv_px)[..., :3]

    if fbm_on:
        # procedural roughness/metallic of the local position
        # (lighting.glsl:20-50)
        lp = attrs[..., off["local"]:off["local"] + 3]
        fp = attrs[..., off["fbm"]:off["fbm"] + 6]
        f = shade.material_fbm(lp, fp[..., 0], 4, fp[..., 1:2])
        use = fp[..., 0] > 0
        rough = torch.where(use, fp[..., 2] + (fp[..., 3] - fp[..., 2]) * f,
                            rough)
        metal = torch.where(use, fp[..., 4] + (fp[..., 5] - fp[..., 4]) * f,
                            metal)
    eid_px = attrs[..., off["edge"]] if "edge" in off else None
    return gb, nrm, base, rough, metal, emission, eid_px


def model_pass(opts: RenderOptions, geom: SceneGeometry, cam_view,
               cam_proj, lights: Lights, eye, shadow_moments=None,
               shadow_mvps=None, cascade_dists=None, base_texture=None,
               textures=None, static_shadow=None):
    """MRT model pass (pipeline-builder.c:329-364) as raster + deferred
    shading: kernel-side attributes over cluster records
    (``opts.kernel_attrs``) or the per-pixel attribute gather over
    member-granularity geometry. The per-frame atlas is read by VSM at
    quarter resolution, or with ``shadow_vsm`` off by 5×5 PCF on its depth
    channel at full resolution; the static atlas stays VSM. Returns (hdr,
    emission, view normals, gbuffer, view_pos, edge_meta)."""
    W, H = opts.width, opts.height
    dev = cam_view.device
    if geom.comp is not None:
        # cluster records arrive in clip space
        if not opts.kernel_attrs:
            raise ValueError("cluster-record geometry (comp) requires "
                             "opts.kernel_attrs")
        clip = None
    else:
        # a corner stream transforms its 3T rows (no per-frame gather)
        clip = clip_transform(
            geom.corner_verts if geom.corner_verts is not None
            else geom.verts, cam_view, cam_proj)
    if opts.kernel_attrs:
        gb, nrm, base, rough, metal, emission, eid_px = \
            _surface_kernel_attrs(opts, geom, clip)
    else:
        gb, nrm, base, rough, metal, emission, eid_px = _surface_gather(
            opts, geom, clip, base_texture, textures)

    # world position from depth (inverse view-projection unproject)
    hit2 = gb.tri_id >= 0
    d_ndc = torch.where(torch.isfinite(gb.depth), gb.depth, 1.0)
    ndc_x = (torch.arange(W, device=dev, dtype=torch.float32)[None, :]
             + 0.5) / W * 2.0 - 1.0
    ndc_y = 1.0 - 2.0 * (torch.arange(H, device=dev,
                                      dtype=torch.float32)[:, None] + 0.5) / H
    # inv_ex: no singularity check, which would read the device back
    inv_vp = torch.linalg.inv_ex(cam_proj @ cam_view).inverse[:, None, None]
    p4 = (inv_vp[..., :, 0] * ndc_x.expand(H, W)[..., None]
          + inv_vp[..., :, 1] * ndc_y.expand(H, W)[..., None]
          + inv_vp[..., :, 2] * d_ndc[..., None]
          + inv_vp[..., :, 3])
    w4 = p4[..., 3:4]
    wpos = torch.where(hit2[..., None],
                       p4[..., :3] / torch.where(torch.abs(w4) < 1e-12,
                                                 1.0, w4), 0.0)
    view_b = cam_view[:, None, None]
    vpos = mx.mat4_transform_point(view_b, wpos)
    vnrm = mx.mat4_transform_dir(view_b, nrm)
    view_depth = -vpos[..., 2]

    sf = None
    q_pos = q_vd = None
    if shadow_moments is not None or static_shadow is not None:
        q_pos = post.downsample_pool(wpos, 4)
        q_vd = post.downsample_pool(view_depth, 4)

    def _up(sf_q):
        sf_h = post.upsample2(sf_q[..., None], sf_q.shape[1] * 2,
                              sf_q.shape[2] * 2)
        return post.upsample2(sf_h, H, W)[..., 0]

    if shadow_moments is not None and opts.shadow_vsm:
        sf = _up(shade.vsm_shadow(shadow_moments, shadow_mvps,
                                  cascade_dists, q_pos, q_vd))
    elif shadow_moments is not None:
        sf = shade.pcf_shadow(shadow_moments[..., 0], shadow_mvps,
                              cascade_dists, wpos, view_depth, nrm,
                              lights.direction[0])
    if static_shadow is not None:
        sm_s, mvp_s, cd_s = static_shadow
        sf_s = _up(shade.vsm_shadow(sm_s, mvp_s, cd_s, q_pos, q_vd))
        sf = sf_s if sf is None else sf * sf_s
    if sf is not None:
        l0 = -lights.direction[0]
        ndl = torch.clamp(torch.sum(nrm * l0, -1), 0.0, 1.0)
        sf = sf + (1.0 - sf) * torch.pow(1.0 - ndl, 1.3)

    tile_mask = light_grid(lights, cam_view, cam_proj, W, H)
    mat = shade.Material(base_color=base, roughness=rough, metallic=metal,
                         emission=emission)
    fog_density = None
    if opts.material_fog:
        # use_3d_fog (lighting.glsl:209-213): density from the analytic
        # noise field at the world position
        fog_density = fog_cloud(wpos, opts.fog_3d_amp, opts.fog_3d_scale)
    hdr = shade.shade_pixels(wpos, nrm, eye, mat, lights, tile_mask,
                             shadow_factor=sf, fog_density=fog_density)
    fog_c = mx.const(opts.fog_color, dev)
    hdr = torch.where(hit2[..., None], hdr, fog_c)
    emit = post.bloom_threshold(emission, opts.bloom_threshold,
                                opts.bloom_intensity)

    edge_meta = None
    if eid_px is not None:
        # edge-mode key (RT2 alpha packing, model.frag:109-125)
        excl = eid_px >= 128.0
        sid = torch.remainder(eid_px, 128.0)
        luma = torch.sum(vnrm * 0.5 + 0.5, -1) / 3.0
        lq = torch.floor(torch.clamp(luma, 0.0, 1.0) * 7.0)
        if sf is not None:
            lq = torch.where(sf < opts.shadow_outline_threshold, 7.0 - lq, lq)
        key = sid * 8.0 + lq
        edge_meta = (torch.where(hit2, key, -8.0), excl)
    return hdr, emit, vnrm, gb, vpos, edge_meta


def particle_records(opts: RenderOptions, ppos, psize, pactive, cam_view,
                     cam_proj):
    """The billboard quads of every env's particles (``ops/particles.py::
    particle_clip_quads``) as corner records, 2·P per env, and their
    binning: (rec, binned). Nothing is near-clipped: a quad with a corner
    at w <= 0 fails the records' own validity test, as in the JAX
    package."""
    W, H = opts.width, opts.height
    verts, _faces, valid, _owner = particle_clip_quads(
        ppos, psize, cam_view, cam_proj, pactive)
    sx, sy, z, iw = project_to_screen(verts, W, H)
    vr = torch.stack([sx, sy, z, iw], dim=-1).reshape(
        verts.shape[0], -1, 3, 4)
    rec, ok = corner_records(vr[:, :, 0], vr[:, :, 1], vr[:, :, 2], valid)
    return rec, bin_triangles(rec, ok, W, H)


def particle_pass(opts: RenderOptions, hdr, scene_depth, ppos, psize,
                  pactive, cam_view, cam_proj, color=(0.9, 0.9, 0.6),
                  alpha: float = 0.55):
    """Particle billboards (particle.c:122-125) rastered by K1, one launch
    for every env, depth-tested against the scene's G-buffer depth and
    alpha-blended over the HDR buffer (the nearest particle per pixel
    blends: one transparency layer). ppos (B, P, 3); psize a number, (P,)
    or (B, P); pactive (P,) or (B, P)."""
    W, H = opts.width, opts.height
    rec, binned = particle_records(opts, ppos, psize, pactive, cam_view,
                                   cam_proj)
    gb = rasterize(rec, binned, W, H)
    vis = (gb.tri_id >= 0) & (gb.depth < scene_depth)
    c = color if torch.is_tensor(color) else mx.const(
        list(color), hdr.device, hdr.dtype)
    return torch.where(vis[..., None], hdr * (1.0 - alpha) + c * alpha, hdr)


def render_frame(opts: RenderOptions, geom: SceneGeometry, cam_view,
                 cam_proj, lights: Lights, eye, far: float = 200.0,
                 shadow_moments=None, shadow_mvps=None, cascade_dists=None,
                 static_shadow=None, grain_noise=None, lut_volume=None,
                 particles=None, textures=None, base_texture=None,
                 ssao_kernel_arr=None, _taps=None):
    """The canonical frame for every env: cam_view (B, 4, 4), cam_proj
    (4, 4), eye (B, 3). ``textures`` (TextureSets, by each vertex's
    tex_id) or ``base_texture`` (one (S, S, C) texture) shade the
    gather path. ``shadow_moments`` / ``shadow_mvps`` / ``cascade_dists``:
    a precomputed atlas, per env (B, C, S, S, 2) or shared (C, S, S, 2)
    (``render_frame_batch``); None fits and renders each env's cascades.
    ``particles``: (pos (B, P, 3), size, active (B, P)[, color[, alpha]]).
    ``grain_noise`` ((S, S) or (S, S, 3), tiled) and ``lut_volume``
    ((N, N, N, 3)) are read only when their options are on;
    ``ssao_kernel_arr`` (16, 3) replaces the default hemisphere table of
    ``ssao_mode="kernel"``. Returns the LDR image (B, H, W, 3).

    ``_taps``: a dict this call fills with each pass's intermediate image,
    (B, ...) each, at the points of the JAX package's render_frame (the
    pass browser's data, ``passbrowser.render_frame_debug``); None costs
    nothing."""
    kw = dict(far=far, shadow_moments=shadow_moments,
              shadow_mvps=shadow_mvps, cascade_dists=cascade_dists,
              static_shadow=static_shadow, grain_noise=grain_noise,
              lut_volume=lut_volume, particles=particles, textures=textures,
              base_texture=base_texture, ssao_kernel_arr=ssao_kernel_arr,
              _taps=_taps)
    if opts.internal_scale > 1:
        # the shading-rate lever: the 3D frame renders at 1/s² of the
        # pixels; only the final LDR upscale touches full resolution
        s = opts.internal_scale
        iopts = dataclasses.replace(opts, width=max(opts.width // s, 8),
                                    height=max(opts.height // s, 8),
                                    internal_scale=1)
        img = render_frame(iopts, geom, cam_view, cam_proj, lights, eye,
                           **kw)
        return post.upsample_bilinear(img, opts.height, opts.width)
    if opts.model_msaa > 1:
        # supersampling: the frame at f× the width and height (particles
        # included), box-filtered down
        f = opts.model_msaa
        sopts = dataclasses.replace(opts, width=opts.width * f,
                                    height=opts.height * f, model_msaa=1)
        img = render_frame(sopts, geom, cam_view, cam_proj, lights, eye,
                           **kw)
        return post.downsample_pool(img, f)
    W, H = opts.width, opts.height
    dev = cam_view.device

    casters = geom.shadow_faces if geom.shadow_faces is not None \
        else geom.faces
    if shadow_moments is None and casters.shape[0] > 0 \
            and lights.active.shape[0] > 0:
        casc, cascade_dists = cascade_subviews(
            cam_view, cam_proj, lights.direction[0], 0.1, far)
        shadow_moments = shadow_pass_all(opts, geom, casc.view, casc.proj)
        shadow_mvps = casc.proj @ casc.view

    hdr, emit, vnrm, gb, vpos, edge_meta = model_pass(
        opts, geom, cam_view, cam_proj, lights, eye, shadow_moments,
        shadow_mvps, cascade_dists, base_texture=base_texture,
        textures=textures, static_shadow=static_shadow)
    if _taps is not None:
        # the model pass's MRT outputs and the shadow pass it read
        # (pipeline-debug.c previews each pass's FBO attachments)
        if shadow_moments is not None:
            _taps["shadow_atlas"] = shadow_moments[..., 0]
        _taps["lighting_hdr"] = hdr
        _taps["emission"] = emit
        _taps["view_normals"] = vnrm * 0.5 + 0.5
        _taps["depth"] = gb.depth
        if edge_meta is not None:
            _taps["edge_key"] = edge_meta[0]

    if particles is not None:
        ppos, psize, pactive = particles[:3]
        pkw = dict(zip(("color", "alpha"), particles[3:5]))
        hdr = particle_pass(opts, hdr, gb.depth, ppos, psize, pactive,
                            cam_view, cam_proj, **pkw)

    if opts.edge_sobel and edge_meta is not None:
        key, excl = edge_meta
        edges = post.sobel_edges(key / 8.0)
        ex = excl
        for ax, sh in ((1, 1), (1, -1), (2, 1), (2, -1)):
            ex = ex | torch.roll(excl, sh, dims=ax)
        edges = torch.where(ex, 0.0, edges)
    elif opts.edge_sobel:
        luma = torch.sum(vnrm * 0.5 + 0.5, -1) / 3.0
        edges = post.sobel_edges(luma)
    else:
        edges = post.laplace_edges(
            torch.where(torch.isfinite(gb.depth), gb.depth, 1.0))
    edge_mask = torch.clamp(edges * 2.0, 0.0, 1.0)
    if _taps is not None:
        _taps["edges"] = edge_mask

    smaa_weights = None
    if opts.edge_aa:
        smaa_weights = post.smaa_blend_weights(edge_mask)
        hdr = post.smaa_neighborhood_blend(hdr, smaa_weights)
        if _taps is not None:
            _taps["smaa_weights"] = smaa_weights

    if opts.ssao:
        q_pos = post.downsample_pool(vpos, 4)
        q_nrm = post.downsample_pool(vnrm, 4)
        q_nrm = q_nrm / torch.clamp(
            torch.sqrt(torch.sum(q_nrm * q_nrm, -1, keepdim=True)), min=1e-6)
        if opts.ssao_mode == "shift":
            ao_raw = post.ssao_shift(q_pos, q_nrm)
        else:
            kern = ssao_kernel_arr if ssao_kernel_arr is not None \
                else post.ssao_kernel(device=dev)
            ao_raw = post.ssao(q_pos, q_nrm, kern)
        ao_q = post.ssao_blur(ao_raw)
        ao = post.upsample2(post.upsample2(
            ao_q, ao_q.shape[1] * 2, ao_q.shape[2] * 2), H, W)
        if _taps is not None:
            _taps["ssao"] = ao
        hdr = hdr * (0.4 + 0.6 * ao[..., None])

    view_dist = torch.sqrt(torch.sum(vpos * vpos, -1))
    view_dist = torch.where(gb.tri_id >= 0, view_dist, 1e9)
    fog_f = torch.clamp((view_dist - opts.fog_near)
                        / max(opts.fog_far - opts.fog_near, 1e-6), 0.0, 1.0)

    color = hdr * opts.lighting_exposure
    if opts.bloom:
        bloom = post.upsample2(
            post.gauss_blur_v(post.gauss_blur_h(
                post.downsample2(post.downsample2(emit)))), H, W)
        if _taps is not None:
            _taps["bloom"] = bloom
        color = color + bloom * (opts.bloom_intensity
                                 * (1.0 - fog_f))[..., None]
    fc = mx.const(opts.fog_color, dev, color.dtype)
    if opts.fog_noise:
        # radial_fog_color (combine.frag:43-48): the fog tint darkens by
        # the squared magnitude of the jittered noise field at the view
        # position
        nv = noise3d_field(vpos + noise_glsl(vpos)[..., None], 0.05) * 0.05
        nfac = torch.clamp(torch.sum(nv * nv, -1), max=3.0) / 3.0
        fc = fc * (1.0 - nfac[..., None])
    color = color * (1.0 - fog_f[..., None]) + fc * fog_f[..., None]
    color = post.contrast(color, opts.contrast)
    if opts.lighting_lut and lut_volume is not None:
        color = apply_lut(color, lut_volume)
    color = shade.tonemap_aces(color) if opts.tonemap_aces else \
        shade.tonemap_reinhard(color)
    if opts.outline_strength > 0:
        fade = 1.0 - fog_f
        if smaa_weights is not None:
            fade = fade * (1.0 - 0.5 * torch.sum(smaa_weights, -1))
        color = color * (1.0 - opts.outline_strength * edge_mask
                         * fade)[..., None]
    if opts.film_grain > 0 and grain_noise is not None:
        color = post.film_grain(color, grain_noise, opts.film_grain)
    out = shade.oetf_pq(color) if opts.hdr else shade.oetf_srgb(color)
    if _taps is not None:
        _taps["combine"] = out
    return out


def render_frame_batch(opts: RenderOptions, geom: SceneGeometry, cam_views,
                       cam_proj, lights: Lights, eyes, far: float = 200.0,
                       shared_shadow: bool = True, scene_aabb=None, **kw):
    """Render B views of ONE shared scene: ``geom``'s ``PER_ENV`` fields
    carry no env axis (verts (V, 3), face_valid (T,), ...); cam_views
    (B, 4, 4), eyes (B, 3).

    shared_shadow=True renders one stable light atlas fitted to the scene
    bounds (``scene_aabb``, default the verts' min − 1 / max + 1), one K2
    launch for all views, which every view reads; shared_shadow=False fits
    and renders each view's own cascades, as ``render_frame_dynamic_batch``
    does. The views see the geometry through expanded views (nothing is
    copied per view). Returns (B, H, W, 3)."""
    sm = mv = cd = None
    if shared_shadow and lights.active.shape[0] > 0:
        if scene_aabb is None:
            scene_aabb = (geom.verts.amin(0) - 1.0, geom.verts.amax(0) + 1.0)
        sv, cd = bounds_light_subview(scene_aabb[0], scene_aabb[1],
                                      lights.direction[0], far=far)
        sm = shadow_pass_all(opts, per_env(geom, 1), sv.view[None],
                             sv.proj[None])[0]                # (1, S, S, 2)
        mv = sv.proj @ sv.view                                 # (1, 4, 4)
    return render_frame(opts, per_env(geom, cam_views.shape[0]), cam_views,
                        cam_proj, lights, eyes, far=far, shadow_moments=sm,
                        shadow_mvps=mv, cascade_dists=cd, **kw)


def render_frame_dynamic_batch(opts: RenderOptions, geom: SceneGeometry,
                               cam_views, cam_proj, lights: Lights, eyes,
                               far: float = 200.0, **kw):
    """Render B envs with PER-ENV dynamic geometry (the composed
    step-and-render frame): geom from assemble_cluster_records_batch or
    assemble_scene_geometry_batch, cam_views (B, 4, 4), eyes (B, 3); each
    env fits and renders its own CSM atlas. Returns (B, H, W, 3)."""
    return render_frame(opts, geom, cam_views, cam_proj, lights, eyes,
                        far=far, **kw)


def menu_blur(frame, opts: RenderOptions):
    """The pause-menu backdrop (pipeline-builder.c:570-610, the checkpoint
    of pipeline.c:530-567): the finished LDR frame (B, H, W, 3) at ¼
    resolution, gaussian-blurred, contrast + 0.1, upsampled back to
    (H, W)."""
    h, w = frame.shape[1], frame.shape[2]
    q = post.downsample2(post.downsample2(frame))
    q = post.gauss_blur_v(post.gauss_blur_h(q))
    q = post.contrast(q, opts.contrast + 0.1)
    return post.upsample2(post.upsample2(q, q.shape[1] * 2, q.shape[2] * 2),
                          h, w)
