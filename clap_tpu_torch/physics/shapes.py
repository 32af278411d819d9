"""Closest-point geometry primitives for the batched narrowphase
(counterpart of clap_tpu/physics/shapes.py).

Branchless closest-point routines (Ericson, "Real-Time Collision
Detection" ch. 5, mask-based). All functions broadcast over leading batch
axes; points are (..., 3).
"""
from __future__ import annotations

import torch

from ..mathx import cross


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _safe(den):
    """Denominator with exact zeros replaced by 1 (masked out by callers)."""
    return torch.where(den == 0, torch.ones_like(den), den)


def closest_pt_segment(p, a, b):
    """Closest point on segment [a, b] to point p."""
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def closest_pt_triangle(p, a, b, c):
    """Closest point on triangle abc to point p (branchless Ericson 5.1.5)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    v_ab = torch.where(torch.abs(d1 - d3) > 1e-12, d1 / _safe(d1 - d3), 0.0)
    p_ab = a + torch.clamp(v_ab, 0, 1)[..., None] * ab
    w_ac = d2 / _safe(d2 - d6)
    p_ac = a + torch.clamp(w_ac, 0, 1)[..., None] * ac
    w_bc = (d4 - d3) / _safe((d4 - d3) + (d5 - d6))
    p_bc = b + torch.clamp(w_bc, 0, 1)[..., None] * (c - b)

    denom = _safe(va + vb + vc)
    v = vb / denom
    w = vc / denom
    p_face = a + v[..., None] * ab + w[..., None] * ac

    out = p_face
    out = torch.where(on_bc[..., None], p_bc, out)
    out = torch.where(on_ac[..., None], p_ac, out)
    out = torch.where(on_ab[..., None], p_ab, out)
    out = torch.where(in_c[..., None], c, out)
    out = torch.where(in_b[..., None], b, out)
    out = torch.where(in_a[..., None], a, out)
    return out


def closest_pt_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1,q1] and [p2,q2]; returns (c1, c2).
    Branchless version of Ericson 5.1.9."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b

    s = torch.where(denom > 1e-12,
                    torch.clamp((b * f - c * e) / _safe(denom), 0, 1), 0.0)
    t = (b * s + f) / _safe(e)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / _safe(a), 0.0, 1.0)
    t = torch.clamp((b * s + f) / _safe(e), 0.0, 1.0)
    s = torch.where(a <= 1e-12, 0.0, s)
    t = torch.where(e <= 1e-12, 0.0, t)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    return c1, c2


def segment_triangle_closest(p0, p1, a, b, c):
    """Closest points between segment [p0,p1] and triangle abc.

    Returns (pt_seg, pt_tri, dist); distance 0 at the crossing when the
    segment pierces the triangle."""
    n = cross(b - a, c - a)
    nn = torch.clamp(_dot(n, n), min=1e-20)
    d0 = _dot(p0 - a, n)
    d1 = _dot(p1 - a, n)
    crosses = d0 * d1 < 0
    t_hit = d0 / _safe(d0 - d1)
    hit = p0 + torch.clamp(t_hit, 0, 1)[..., None] * (p1 - p0)
    hc = closest_pt_triangle(hit, a, b, c)
    inside = _dot(hit - hc, hit - hc) < 1e-10 * nn
    pierce = crosses & inside

    cands_seg = []
    cands_tri = []
    for p in (p0, p1):
        cands_seg.append(p)
        cands_tri.append(closest_pt_triangle(p, a, b, c))
    for e0, e1 in ((a, b), (b, c), (c, a)):
        cs, ce = closest_pt_segment_segment(p0, p1, e0, e1)
        cands_seg.append(cs)
        cands_tri.append(ce)

    # first minimum wins (argmin semantics)
    ds = [_dot(s - t, s - t) for s, t in zip(cands_seg, cands_tri)]
    best_d, pt_seg, pt_tri = ds[0], cands_seg[0], cands_tri[0]
    for d, s, t in zip(ds[1:], cands_seg[1:], cands_tri[1:]):
        w = d < best_d
        best_d = torch.where(w, d, best_d)
        pt_seg = torch.where(w[..., None], s, pt_seg)
        pt_tri = torch.where(w[..., None], t, pt_tri)
    dist = torch.sqrt(best_d)

    pt_seg = torch.where(pierce[..., None], hit, pt_seg)
    pt_tri = torch.where(pierce[..., None], hit, pt_tri)
    dist = torch.where(pierce, 0.0, dist)
    return pt_seg, pt_tri, dist


def capsule_triangle_contact(p0, p1, r, a, b, c):
    """Capsule (segment [p0,p1], radius r) vs triangle abc.

    Returns (depth, normal, contact_point): depth > 0 on penetration;
    normal points from the triangle toward the capsule."""
    ps, pt, dist = segment_triangle_closest(p0, p1, a, b, c)
    tri_n = cross(b - a, c - a)
    tri_n = tri_n / torch.clamp(
        torch.linalg.vector_norm(tri_n, dim=-1, keepdim=True), min=1e-12)
    diff = ps - pt
    dn = diff / torch.clamp(dist[..., None], min=1e-9)
    mid = 0.5 * (p0 + p1)
    sign = torch.sign(_dot(mid - pt, tri_n))[..., None]
    fallback = tri_n * torch.where(sign == 0, 1.0, sign)
    normal = torch.where(dist[..., None] > 1e-7, dn, fallback)
    depth = r - dist
    return depth, normal, pt


def ray_triangle(origin, direction, a, b, c, backface_cull=True):
    """Möller–Trumbore; returns (t, hit_mask). direction need not be unit;
    t is in units of |direction|. Backface culling matches
    dGeomRaySetBackfaceCull(ray, 1) (physics.c:489)."""
    e1 = b - a
    e2 = c - a
    pvec = cross(direction, e2)
    det = _dot(e1, pvec)
    ok = det > 1e-12 if backface_cull else torch.abs(det) > 1e-12
    inv_det = 1.0 / _safe(det)
    tvec = origin - a
    u = _dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return torch.where(hit, t, torch.full_like(t, float("inf"))), hit
