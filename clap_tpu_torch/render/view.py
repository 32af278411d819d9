"""Views, frusta, cascaded shadow fitting (counterpart of
clap_tpu/render/view.py; reference: core/view.{c,h}).

A ``Subview`` is a (view, proj) pair plus its frustum planes. The main
view owns CASCADES_MAX=4 shadow subviews whose ortho projections are
fitted per cascade to the camera frustum slices in light space. Functions
broadcast over a leading env axis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx

CASCADES_MAX = 4
CASCADE_SPLITS = (15.0, 50.0, 150.0)


class Subview(NamedTuple):
    view: torch.Tensor       # (..., 4, 4)
    proj: torch.Tensor       # (..., 4, 4)
    planes: torch.Tensor     # (..., 6, 4): n·p + d >= 0 inside


def frustum_planes(viewproj):
    """The 6 clip planes of a view-projection matrix (Gribb/Hartmann)."""
    m = viewproj
    rows = [m[..., 3, :] + m[..., 0, :],   # left
            m[..., 3, :] - m[..., 0, :],   # right
            m[..., 3, :] + m[..., 1, :],   # bottom
            m[..., 3, :] - m[..., 1, :],   # top
            m[..., 3, :] + m[..., 2, :],   # near
            m[..., 3, :] - m[..., 2, :]]   # far
    planes = torch.stack(rows, dim=-2)
    n = torch.sqrt(torch.sum(planes[..., :3] ** 2, dim=-1, keepdim=True))
    return planes / torch.clamp(n, min=1e-12)


def make_subview(view, proj) -> Subview:
    return Subview(view=view, proj=proj, planes=frustum_planes(proj @ view))


def aabb_in_frustum(planes, aabb_min, aabb_max):
    """view_entity_in_frustum (view.c:296-336), p-vertex test: planes
    (..., 6, 4), boxes (..., E, 3) → (..., E) not-culled mask."""
    n = planes[..., :3]
    d = planes[..., 3]
    pos = torch.where(n[..., None, :, :] >= 0, aabb_max[..., None, :],
                      aabb_min[..., None, :])             # (..., E, 6, 3)
    dist = torch.sum(pos * n[..., None, :, :], dim=-1) + d[..., None, :]
    return torch.all(dist >= 0, dim=-1)


def frustum_corners_world(view, proj, near_t=0.0, far_t=1.0):
    """8 world-space corners (..., 8, 3) of the [near_t, far_t] NDC-depth
    slice of the frustum (view.c:150-193)."""
    inv = torch.linalg.inv_ex(proj @ view).inverse
    dev = view.device
    corners = []
    for z in (near_t * 2 - 1, far_t * 2 - 1):
        for y in (-1.0, 1.0):
            for x in (-1.0, 1.0):
                corners.append(torch.stack([mx.f32(v, dev).reshape(())
                                            for v in (x, y, z, 1.0)]))
    c = torch.stack(corners)                           # (8, 4)
    w = (inv[..., None, :, :] @ c[..., None])[..., 0]   # (..., 8, 4)
    return w[..., :3] / w[..., 3:4]


def cascade_subviews(cam_view, cam_proj, light_dir, near, far,
                     tex_size: float = 2048.0):
    """Fit CASCADES_MAX ortho light views to the camera frustum slices
    (view.c:129-148, 195-228). cam_view (B, 4, 4), cam_proj (4, 4).

    Returns (Subview with (B, C, ...) leaves, cascade far distances (C,))."""
    dev = cam_view.device
    splits = list(CASCADE_SPLITS) + [None]
    dists, views, projs = [], [], []
    up = mx.const([0.0, 1.0, 0.0], dev)
    ldir = mx.normalize(light_dir)
    e2 = mx.const([0.0, 0.0, -1.0, 0.0], dev)
    e3 = mx.const([0.0, 0.0, 0.0, 1.0], dev)

    def ndc_t(dist):
        p = (cam_proj @ e2) * dist + cam_proj @ e3
        return (p[2] / p[3] + 1.0) * 0.5

    for i in range(CASCADES_MAX):
        d1 = mx.const(splits[i] if splits[i] is not None else far, dev)
        d1 = torch.clamp(d1, max=far)
        t0 = mx.const(0.0, dev) if i == 0 \
            else ndc_t(dists[-1] + 1e-4)
        corners = frustum_corners_world(cam_view, cam_proj, t0, ndc_t(d1))
        center = corners.mean(dim=-2)
        eye = center - ldir * 1.0
        lview = mx.mat4_look_at_safe(eye, center, up)
        lc = mx.mat4_transform_point(lview[..., None, :, :], corners)
        mn = lc.amin(dim=-2)
        mxx = lc.amax(dim=-2)
        near_l = -(mxx[..., 2] + 50.0)
        far_l = -(mn[..., 2] - 1.0)
        projs.append(mx.mat4_ortho(mn[..., 0], mxx[..., 0], mn[..., 1],
                                   mxx[..., 1], near_l, far_l))
        views.append(lview)
        dists.append(d1)
    view = torch.stack(views, dim=-3)
    proj = torch.stack(projs, dim=-3)
    return (Subview(view=view, proj=proj,
                    planes=frustum_planes(proj @ view)),
            torch.stack(dists))


def bounds_light_subview(aabb_min, aabb_max, light_dir, far: float = 1e4,
                         pad: float = 1.02):
    """ONE stable ortho light view fitted to a world AABB.

    Returns (Subview with a leading cascade axis of 1, cascade_dists (1,))."""
    dev = light_dir.device
    up = mx.const([0.0, 1.0, 0.0], dev)
    ldir = mx.normalize(light_dir)
    mn = aabb_min.float()
    mxx = aabb_max.float()
    center = 0.5 * (mn + mxx)
    eye = center - ldir * 1.0
    lview = mx.mat4_look_at_safe(eye, center, up)
    corners = mx.const([[x, y, z] for x in (0, 1) for y in (0, 1)
                        for z in (0, 1)], dev)
    wc = mn[None, :] + corners * (mxx - mn)[None, :]
    lc = mx.mat4_transform_point(lview, wc)
    lctr = 0.5 * (lc.amin(dim=0) + lc.amax(dim=0))
    lhalf = 0.5 * (lc.amax(dim=0) - lc.amin(dim=0)) * pad
    lmn = lctr - lhalf
    lmx = lctr + lhalf
    near_l = -(lmx[2] + 50.0)
    far_l = -(lmn[2] - 1.0)
    proj = mx.mat4_ortho(lmn[0], lmx[0], lmn[1], lmx[1], near_l, far_l)
    sv = make_subview(lview, proj)
    return (Subview(view=sv.view[None], proj=sv.proj[None],
                    planes=sv.planes[None]),
            mx.const([far], dev))
