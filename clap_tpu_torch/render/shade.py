"""Deferred shading: BRDF, shadows, tonemap, OETF (counterpart of
clap_tpu/render/shade.py; reference shaders lighting.glsl, shadow.glsl,
tonemap.glsl, oetf.glsl).

Elementwise image math over batched (B, H, W[, C]) tensors, and the
G-buffer attribute interpolation of the per-pixel gather path (one gather
of a packed per-triangle record per pixel).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import mathx as mx
from .lights import LIGHT_TILE, Lights
from .raster import GBuffer


# ---------------------------------------------------------------------------
# G-buffer attribute interpolation
# ---------------------------------------------------------------------------

def pack_tri_attrs(faces, vattrs):
    """(B, T, 3A) per-triangle records, the three corners' attributes side
    by side, from faces (T, 3) shared or (B, T, 3) per env and vattrs
    (V, A)."""
    return vattrs[faces.long()].reshape(*faces.shape[:-1],
                                        3 * vattrs.shape[-1])


def interpolate_attrs(gb: GBuffer, faces, vattrs, csrc=None,
                      face_attrs=None, table_dtype=None):
    """Per-pixel interpolated vertex attributes of a (B, H, W) G-buffer.

    faces (T, 3) shared or (B, T, 3) per env (after compact_faces); vattrs
    (V, A). Returns (B, H, W, A), zeros on background pixels.

    csrc (near-plane clip, clip_near_records): the G-buffer holds
    sub-triangle ids, already folded back to the original triangle's
    barycentrics (the fold lives in the records), so only the id maps
    back: orig = sub mod T, with T the (per env compacted) face count.

    face_attrs (T, F) or (B, T, F): flat per-face columns that ride the
    same per-pixel gather; then returns (attrs, flat (B, H, W, F)), flat
    copied from the record, -1 on background pixels.

    table_dtype (e.g. torch.bfloat16): storage dtype of the per-triangle
    table; interpolation runs in vattrs' dtype."""
    B = gb.tri_id.shape[0]
    A = vattrs.shape[-1]
    T = faces.shape[-2]
    tri = pack_tri_attrs(faces, vattrs).expand(B, T, 3 * A)
    if face_attrs is not None:
        tri = torch.cat([tri, face_attrs.to(tri.dtype).expand(
            B, T, face_attrs.shape[-1])], dim=-1)
    if table_dtype is not None:
        tri = tri.to(table_dtype)
    tid = torch.clamp(gb.tri_id, min=0).long()
    if csrc is not None:
        tid = torch.remainder(tid, T)
    rec = torch.gather(tri, 1, tid.reshape(B, -1, 1).expand(
        -1, -1, tri.shape[-1])).reshape(*gb.tri_id.shape, tri.shape[-1])
    if table_dtype is not None:
        rec = rec.to(vattrs.dtype)
    b0 = gb.bary[..., 0:1]
    b1 = gb.bary[..., 1:2]
    b2 = 1.0 - b0 - b1
    out = rec[..., :A] * b0 + rec[..., A:2 * A] * b1 \
        + rec[..., 2 * A:3 * A] * b2
    hit = (gb.tri_id >= 0)[..., None]
    out = torch.where(hit, out, 0.0)
    if face_attrs is None:
        return out
    return out, torch.where(hit, rec[..., 3 * A:], -1.0)


def face_attr(gb: GBuffer, per_face):
    """Per-pixel flat (per-face) attribute gather, e.g. a material id:
    per_face (B, T, ...) (expand a shared table); zeros on background
    pixels."""
    B = gb.tri_id.shape[0]
    tid = torch.clamp(gb.tri_id, min=0).reshape(B, -1).long()
    out = per_face[torch.arange(B, device=tid.device)[:, None], tid]
    out = out.reshape(*gb.tri_id.shape, *per_face.shape[2:])
    hit = (gb.tri_id >= 0).reshape(gb.tri_id.shape
                                   + (1,) * (out.dim() - gb.tri_id.dim()))
    return torch.where(hit, out, torch.zeros_like(out))


class Material(NamedTuple):
    base_color: torch.Tensor   # (..., 3)
    roughness: torch.Tensor    # (...)
    metallic: torch.Tensor     # (...)
    emission: torch.Tensor     # (..., 3)


def _unit(v, eps=1e-6):
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=eps)


def ggx_brdf(n, v, l, base_color, roughness, metallic):
    """Per-light Cook-Torrance term (lighting.glsl:94-139): (diffuse,
    specular), each already scaled by NdotL."""
    alpha = torch.clamp(roughness * roughness, 0.05, 0.98)
    h = _unit(v + l)
    ndl = torch.clamp(torch.sum(n * l, -1), min=0.0)
    ndv = torch.clamp(torch.sum(n * v, -1), min=1e-4)
    ndh = torch.clamp(torch.sum(n * h, -1), min=0.0)
    vdh = torch.clamp(torch.sum(v * h, -1), min=0.0)

    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / torch.clamp(math.pi * denom * denom, min=1e-6)

    m = metallic[..., None]
    f0 = 0.04 * (1.0 - m) + base_color * m
    F = f0 + (1.0 - f0) * torch.pow(1.0 - vdh, 5.0)[..., None]

    k = (alpha + 1.0) ** 2 / 8.0
    g1 = ndl / torch.clamp(ndl * (1 - k) + k, min=1e-6)
    g2 = ndv / torch.clamp(ndv * (1 - k) + k, min=1e-6)
    G = g1 * g2

    spec = F * (D * G / torch.clamp(4.0 * ndl * ndv, min=1e-6))[..., None]
    kd = (1.0 - F) * (1.0 - m)
    diff = kd * base_color / math.pi
    return diff * ndl[..., None], spec * ndl[..., None]


def attenuation(att, dist):
    """1/(kc + kl·d + kq·d²) (lighting.glsl:98-99)."""
    return 1.0 / torch.clamp(
        att[..., 0] + att[..., 1] * dist + att[..., 2] * dist * dist,
        min=1e-6)


def spot_factor(l, light_dir, cutoff):
    """Spotlight smoothstep (lighting.glsl:57-66); cutoff <= -1 → 1."""
    cd = torch.sum(-l * light_dir, dim=-1)
    co = torch.cos(torch.acos(torch.clamp(cutoff, -1.0, 1.0))
                   + math.radians(5.0))
    t = torch.clamp((cd - co) / torch.clamp(cutoff - co, min=1e-6), 0.0, 1.0)
    f = t * t * (3.0 - 2.0 * t)
    return torch.where(cutoff <= -1.0, 1.0, f)


def shade_pixels(world_pos, normal, view_pos, mat: Material, lights: Lights,
                 tile_mask, shadow_factor=None, ambient=0.1,
                 shadow_tint=None, fog_density=None):
    """Accumulate all lights (model.frag main loop, lighting.glsl:141-207)
    for world_pos/normal (B, H, W, 3), view_pos (B, 3), tile_mask
    (B, nty, ntx, L). Light 0 is the shadow caster: its diffuse is tinted
    by ``shadow_tint`` (3,) and its specular zeroed where shadowed.

    fog_density (B, H, W): material fog (use_3d_fog,
    lighting.glsl:209-213): the diffuse blends toward the ambient fog
    colour and the specular fades by (1 − density)."""
    H, W = world_pos.shape[1:3]
    dev = world_pos.device
    v = _unit(view_pos[:, None, None, :] - world_pos)
    pix_mask = tile_mask.repeat_interleave(LIGHT_TILE, dim=1) \
        .repeat_interleave(LIGHT_TILE, dim=2)[:, :H, :W]
    total_d = torch.zeros_like(mat.base_color)
    total_s = torch.zeros_like(mat.base_color)
    if shadow_factor is None:
        shadow_factor = torch.ones(world_pos.shape[:3], device=dev)
    if shadow_tint is None:
        shadow_tint = mx.const([0.3, 0.3, 0.4], dev)
    for li in range(lights.pos.shape[0]):
        to_l = torch.where(lights.is_dir[li], -lights.direction[li],
                           lights.pos[li] - world_pos)
        dist = torch.sqrt(torch.sum(to_l * to_l, dim=-1))
        l = to_l / torch.clamp(dist[..., None], min=1e-6)
        diff, spec = ggx_brdf(normal, v, l, mat.base_color, mat.roughness,
                              mat.metallic)
        att = torch.where(lights.is_dir[li], 1.0,
                          attenuation(lights.attenuation[li], dist))
        att = att * spot_factor(l, lights.direction[li], lights.cutoff[li])
        ca = lights.color[li] * att[..., None]
        d_li, s_li = diff * ca, spec * ca
        if li == 0:
            sf = shadow_factor[..., None]
            d_li = d_li * sf + d_li * shadow_tint * (1 - sf)
            s_li = s_li * sf
        m = pix_mask[..., li:li + 1]
        total_d = total_d + torch.where(m, d_li, 0.0)
        total_s = total_s + torch.where(m, s_li, 0.0)
    amb_tint = 1.0 * shadow_factor[..., None] \
        + shadow_tint * (1 - shadow_factor[..., None])
    total_d = total_d + ambient * mat.base_color * amb_tint
    if fog_density is not None:
        fd = fog_density[..., None]
        amb_col = mx.const([ambient] * 3, dev, total_d.dtype)
        total_d = total_d * (1.0 - fd) + amb_col * fd
        total_s = total_s * (1.0 - fd)
    return total_d + total_s


# ---------------------------------------------------------------------------
# material noise (lighting.glsl:20-50): procedural roughness / metallic
# ---------------------------------------------------------------------------

def _hash3(p):
    """fract(sin(p · (127.1, 311.7, 74.7)) · 43758.5453). The multiply
    turns one ulp of sin into ~3e-3, so two implementations agree only to
    that (and differ by ~1 where fract wraps)."""
    k = mx.const([127.1, 311.7, 74.7], p.device, p.dtype)
    q = torch.sin(torch.sum(p * k, -1)) * 43758.5453
    return q - torch.floor(q)


def value_noise3(p):
    """Cheap 3-D value noise (the material fBm's octave)."""
    i = torch.floor(p)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)

    def corner(dx, dy, dz):
        return _hash3(i + mx.const([dx, dy, dz], p.device, p.dtype))

    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    x00 = corner(0, 0, 0) * (1 - ux) + corner(1, 0, 0) * ux
    x10 = corner(0, 1, 0) * (1 - ux) + corner(1, 1, 0) * ux
    x01 = corner(0, 0, 1) * (1 - ux) + corner(1, 0, 1) * ux
    x11 = corner(0, 1, 1) * (1 - ux) + corner(1, 1, 1) * ux
    y0 = x00 * (1 - uy) + x10 * uy
    y1 = x01 * (1 - uy) + x11 * uy
    return y0 * (1 - uz) + y1 * uz


def material_fbm(local_pos, amp, octaves: int, scale):
    """fBm of the local-space position (lighting.glsl:20-50), clipped to
    [0, 1]: the caller lerps the material's floor → ceil by it. amp
    (...,) and scale (..., 1) may vary per pixel."""
    total = torch.zeros(local_pos.shape[:-1], dtype=local_pos.dtype,
                        device=local_pos.device)
    freq = 1.0
    a = amp
    for _ in range(octaves):
        total = total + a * value_noise3(local_pos * (scale * freq))
        freq *= 2.0
        a = a * 0.5
    return torch.clamp(total, 0.0, 1.0)


def select_cascade(view_depth, cascade_dists):
    """First cascade whose far distance exceeds the pixel's view depth
    (shadow.glsl:148-155)."""
    past = view_depth[..., None] >= cascade_dists
    return torch.clamp(torch.sum(past, -1), max=cascade_dists.shape[-1] - 1)


def _cascade_project(shadow_mvps, cascade_dists, world_pos, view_depth):
    """Each pixel's cascade (select_cascade) and its light-space NDC there:
    (casc (B, H, W), w, ok = w > 1e-3, uv (B, H, W, 2), depth d in
    [0, 1]). shadow_mvps (B, C, 4, 4)."""
    B = world_pos.shape[0]
    casc = select_cascade(view_depth, cascade_dists)
    p = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])], -1)
    sps = (shadow_mvps[:, :, None, None] @ p[:, None, ..., None])[..., 0]
    sp = torch.gather(sps, 1, casc[:, None, ..., None].expand(
        B, 1, *casc.shape[1:], 4))[:, 0]                      # (B, H, W, 4)
    w = sp[..., 3]
    ok = w > 1e-3
    ndc = sp[..., :3] / torch.where(ok, w, 1.0)[..., None]
    return casc, w, ok, ndc[..., :2] * 0.5 + 0.5, ndc[..., 2] * 0.5 + 0.5


def vsm_shadow(moments_maps, shadow_mvps, cascade_dists, world_pos,
               view_depth, light_bleed=0.8):
    """Variance shadow maps (shadow.glsl:97-121): Chebyshev bound with
    light-bleed clamp + smoothstep remap, one bilinear fetch from the
    vertically stacked cascade atlas.

    moments_maps (B, C, S, S, 2) per env or (C, S, S, 2) shared;
    shadow_mvps (B, C, 4, 4) or (C, 4, 4); cascade_dists (C,);
    world_pos (B, H, W, 3), view_depth (B, H, W). Returns (B, H, W)."""
    B = world_pos.shape[0]
    shared = moments_maps.dim() == 4       # one atlas, read by every env
    if shared:
        moments_maps = moments_maps[None]
    if shadow_mvps.dim() == 3:
        shadow_mvps = shadow_mvps[None].expand(B, *shadow_mvps.shape)
    n_casc = moments_maps.shape[1]
    casc, _w, ok, uv, d = _cascade_project(shadow_mvps, cascade_dists,
                                           world_pos, view_depth)
    s = moments_maps.shape[2]
    u = uv[..., 0] * (s - 1)
    v = (1.0 - uv[..., 1]) * (s - 1)
    atlas = moments_maps.reshape(moments_maps.shape[0], n_casc * s, s, 2)
    u = torch.clamp(u, 0.0, s - 1.001)
    v = torch.clamp(v, 0.0, s - 1.001) + casc.float() * s
    # clamped on both sides, as the reference's gather clamps: a NaN
    # position floors to INT64_MIN
    u0 = torch.clamp(torch.floor(u).long(), 0, s - 1)
    v0 = torch.clamp(torch.floor(v).long(), 0, n_casc * s - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    right = torch.cat([atlas[:, :, 1:], atlas[:, :, -1:]], dim=2)
    down = torch.cat([atlas[:, 1:], atlas[:, -1:]], dim=1)
    down_r = torch.cat([down[:, :, 1:], down[:, :, -1:]], dim=2)
    quad = torch.cat([atlas, right, down, down_r], dim=-1).reshape(
        atlas.shape[0], -1, 8)
    idx = (v0 * s + u0).reshape(B, -1)
    m4 = quad[0][idx] if shared else torch.gather(
        quad, 1, idx[..., None].expand(-1, -1, 8))
    m4 = m4.reshape(*u.shape, 8)
    a, b = m4[..., 0:2], m4[..., 2:4]
    cc, dd = m4[..., 4:6], m4[..., 6:8]
    m = (a * (1 - fu) + b * fu) * (1 - fv) + (cc * (1 - fu) + dd * fu) * fv
    mu, m2 = m[..., 0], m[..., 1]
    var = torch.clamp(m2 - mu * mu, min=1e-5)
    diff = d - mu
    cheb = var / (var + diff * diff)
    p_lit = torch.where(diff <= 0, 1.0, cheb)
    t = torch.clamp((p_lit - 0.15) / (0.95 - 0.15), 0.0, 1.0)
    p_lit = t * t * (3 - 2 * t)
    inb = ok & (uv[..., 0] >= 0) & (uv[..., 0] <= 1) \
        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
    return torch.where(inb, p_lit, 1.0)


def pcf_shadow(depth_maps, shadow_mvps, cascade_dists, world_pos,
               view_depth, normal, light_dir, kernel: int = 5):
    """PCF (shadow.glsl:20-50, 167-168): k×k depth compares in the pixel's
    cascade with the slope-scaled bias max(0.0005·(1 − N·L), 0.0008) ·
    max(w·0.02, 1), at full resolution.

    depth_maps (B, C, S, S) per env or (C, S, S) shared; shadow_mvps
    (B, C, 4, 4) or (C, 4, 4); cascade_dists (C,); world_pos, normal
    (B, H, W, 3); view_depth (B, H, W); light_dir (3,). The k² taps are
    read by one index. Returns (B, H, W)."""
    B = world_pos.shape[0]
    shared = depth_maps.dim() == 3
    if shadow_mvps.dim() == 3:
        shadow_mvps = shadow_mvps[None].expand(B, *shadow_mvps.shape)
    n_casc, s = depth_maps.shape[-3], depth_maps.shape[-1]
    casc, w, ok, uv, d = _cascade_project(shadow_mvps, cascade_dists,
                                          world_pos, view_depth)
    ndl = torch.clamp(torch.sum(normal * -light_dir, -1), 0.0, 1.0)
    bias = torch.clamp(0.0005 * (1.0 - ndl), min=0.0008) \
        * torch.clamp(w * 0.02, min=1.0)
    u = torch.clamp(uv[..., 0] * (s - 1), 0.0, s - 1.0)
    v = torch.clamp((1.0 - uv[..., 1]) * (s - 1), 0.0, s - 1.0) \
        + casc.float() * s
    ui = u.to(torch.int32)
    vi = torch.clamp(v.to(torch.int32), max=n_casc * s - 1)
    r = kernel // 2
    d_ = torch.arange(-r, r + 1, device=ui.device, dtype=torch.int32)
    dy = d_.repeat_interleave(kernel).reshape(-1, 1, 1, 1)
    dx = d_.repeat(kernel).reshape(-1, 1, 1, 1)
    su = torch.clamp(ui + dx, 0, s - 1)
    sv = torch.minimum(torch.maximum(vi + dy, casc * s), (casc + 1) * s - 1)
    idx = (sv * s + su).long()                               # (k², B, H, W)
    if shared:
        stored = depth_maps.reshape(-1)[idx]
    else:
        stored = torch.gather(
            depth_maps.reshape(B, -1), 1,
            idx.permute(1, 0, 2, 3).reshape(B, -1)).reshape(
                B, kernel * kernel, *ui.shape[1:]).permute(1, 0, 2, 3)
    lit = torch.sum(torch.where((d - bias)[None] <= stored, 1.0, 0.0), dim=0)
    sf = lit / float(kernel * kernel)
    inb = ok & (uv[..., 0] >= 0) & (uv[..., 0] <= 1) \
        & (uv[..., 1] >= 0) & (uv[..., 1] <= 1)
    return torch.where(inb, sf, 1.0)


def tonemap_reinhard(x):
    """1 - exp(-x) variant (tonemap.glsl:4-7)."""
    return 1.0 - torch.exp(-x)


def tonemap_aces(x):
    """ACES filmic approximation (tonemap.glsl:8-12, Narkowicz fit)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def oetf_srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x, 1 / 2.4) - 0.055)


def oetf_pq(x, peak_nits=1000.0):
    """SMPTE ST.2084 PQ (oetf.glsl HDR output path)."""
    m1, m2 = 0.1593017578125, 78.84375
    c1, c2, c3 = 0.8359375, 18.8515625, 18.6875
    y = torch.clamp(x * peak_nits / 10000.0, 0.0, 1.0)
    yp = torch.pow(y, m1)
    return torch.pow((c1 + c2 * yp) / (1.0 + c3 * yp), m2)
