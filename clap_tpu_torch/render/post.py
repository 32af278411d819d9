"""Post-processing image ops (counterpart of clap_tpu/render/post.py).

Images are batched: (B, H, W) or (B, H, W, C) — spatial axes 1 and 2.
Stencils clamp at the image edge (texture clamp-to-edge semantics).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device
from ..ops.noise import jax_table


def _pad_edge(img, ry: int, rx: int):
    """Edge-pad the spatial axes once for a stencil of radius (ry, rx)."""
    h, w = img.shape[1], img.shape[2]
    iy = torch.clamp(torch.arange(-ry, h + ry, device=img.device), 0, h - 1)
    ix = torch.clamp(torch.arange(-rx, w + rx, device=img.device), 0, w - 1)
    return img[:, iy][:, :, ix]


def _tap(p, dy: int, dx: int, ry: int, rx: int, h: int, w: int):
    """result[:, y, x] = img[:, clamp(y+dy), clamp(x+dx)] given
    p = _pad_edge(img, ry, rx)."""
    return p[:, ry + dy:ry + dy + h, rx + dx:rx + dx + w]


def _pool(img, f: int):
    """f×f window sums over the spatial axes (cropped to multiples of f)."""
    B, h, w = img.shape[0], img.shape[1] // f, img.shape[2] // f
    c = img[:, :h * f, :w * f]
    return c.reshape(B, h, f, w, f, *img.shape[3:]).sum(dim=(2, 4))


def downsample2(img):
    """½-res 2×2 box downsample (downsample.frag)."""
    return _pool(img, 2) * 0.25


def downsample_pool(img, f: int):
    """f×f average pool."""
    return _pool(img, f) / (f * f)


def upsample2(img, out_h: int, out_w: int):
    """Upsample to (out_h, out_w) (upsample.frag): integer factors repeat
    and take one half-pixel smoothing tap; other shapes resize bilinearly
    (``resize_bilinear``)."""
    h, w = img.shape[1], img.shape[2]
    if out_h % h or out_w % w:
        return resize_bilinear(img, out_h, out_w)
    up = img.repeat_interleave(out_h // h, dim=1) \
        .repeat_interleave(out_w // w, dim=2)
    pd = _pad_edge(up, 1, 1)
    return 0.25 * (up + _tap(pd, 0, 1, 1, 1, out_h, out_w)
                   + _tap(pd, 1, 0, 1, 1, out_h, out_w)
                   + _tap(pd, 1, 1, 1, 1, out_h, out_w))


def _axis_bilinear_up(x, f: int, dim: int):
    """True bilinear ×f upsample along ``dim``: repeat + two edge-clamped
    shifts + a per-phase weight (output centre (j + 0.5)/f − 0.5
    interpolates the two nearest input samples)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    up = x.repeat_interleave(f, dim=0)
    nxt = torch.cat([up[f:], up[-1:].expand(f, *up.shape[1:])], dim=0)
    prv = torch.cat([up[:1].expand(f, *up.shape[1:]), up[:-f]], dim=0)
    k = torch.arange(n * f, device=x.device) % f
    g = (k.to(x.dtype) + 0.5) / f - 0.5
    g = g.reshape((n * f,) + (1,) * (x.dim() - 1))
    w = torch.abs(g)
    nb = torch.where(g >= 0, nxt, prv)
    return ((1.0 - w) * up + w * nb).movedim(0, dim)


def _resize_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) weights of a half-pixel-centre triangle-kernel resize
    along one axis, as ``jax.image.resize(..., "bilinear")`` builds them:
    the kernel widens by n_in/n_out when shrinking, each output's weights
    are normalised to sum 1 (so the edges clamp), and outputs centred
    outside the input get none."""
    f32 = dict(dtype=torch.float32, device=device)
    inv_scale = 1.0 / torch.tensor(n_out / n_in, **f32)
    kscale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, **f32)[:, None]) \
        / kscale
    wts = torch.clamp(1.0 - torch.abs(x), min=0.0)
    tot = wts.sum(0, keepdim=True)
    wts = torch.where(torch.abs(tot) > 1000.0 * 1.1920929e-07,
                      wts / torch.where(tot != 0, tot, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], wts, 0.0)


def resize_bilinear(img, out_h: int, out_w: int):
    """Separable bilinear resize of the spatial axes of (B, H, W[, C]) to
    (out_h, out_w), ``jax.image.resize``'s weights (``_resize_weights``),
    rows first."""
    h, w = img.shape[1], img.shape[2]
    wy = _resize_weights(h, out_h, img.device)
    wx = _resize_weights(w, out_w, img.device)
    x = img if img.dim() == 4 else img[..., None]
    x = torch.einsum("bhwc,hH->bHwc", x, wy)
    x = torch.einsum("bHwc,wW->bHWc", x, wx)
    return x if img.dim() == 4 else x[..., 0]


def upsample_bilinear(img, out_h: int, out_w: int):
    """Exact separable bilinear upsample of (B, H, W[, C]) (the
    internal-resolution lever's final LDR upscale): integer factors take
    repeat + shifts (``_axis_bilinear_up``), other shapes
    ``resize_bilinear``."""
    h, w = img.shape[1], img.shape[2]
    if out_h % h == 0 and out_w % w == 0:
        return _axis_bilinear_up(_axis_bilinear_up(img, out_h // h, 1),
                                 out_w // w, 2)
    return resize_bilinear(img, out_h, out_w)


# 11-tap Gaussian, matching the reference's separable blur weights
_G11 = np.array([0.0093, 0.028002, 0.065984, 0.121703, 0.175713, 0.198596,
                 0.175713, 0.121703, 0.065984, 0.028002, 0.0093], np.float32)
_G11 /= _G11.sum()


def gauss_blur_h(img):
    h, w = img.shape[1], img.shape[2]
    pd = _pad_edge(img, 0, 5)
    acc = torch.zeros_like(img)
    for i, wgt in enumerate(_G11):
        acc = acc + float(wgt) * _tap(pd, 0, i - 5, 0, 5, h, w)
    return acc


def gauss_blur_v(img):
    h, w = img.shape[1], img.shape[2]
    pd = _pad_edge(img, 5, 0)
    acc = torch.zeros_like(img)
    for i, wgt in enumerate(_G11):
        acc = acc + float(wgt) * _tap(pd, i - 5, 0, 5, 0, h, w)
    return acc


def bloom_threshold(emission, threshold, intensity):
    """RT1 emission shaping (model.frag:84-101)."""
    return torch.clamp(emission - threshold, min=0.0) * abs(intensity)


def bloom_chain(hdr_emission, out_h: int, out_w: int, intensity=1.0,
                exposure=1.0):
    """¼-res downsample → v/h Gaussian → upsample recombine
    (pipeline-builder.c:366-411; upsample.frag math)."""
    q = downsample2(downsample2(hdr_emission))
    q = gauss_blur_v(gauss_blur_h(q))
    up = upsample2(q, out_h, out_w)
    return (hdr_emission + up * intensity) * exposure


def sobel_edges(img_luma):
    """Sobel magnitude on a single-channel image (B, H, W)."""
    h, w = img_luma.shape[1], img_luma.shape[2]
    pd = _pad_edge(img_luma, 1, 1)

    def t(dy, dx):
        return _tap(pd, dy, dx, 1, 1, h, w)

    gx = (t(-1, 1) + 2 * t(0, 1) + t(1, 1)
          - t(-1, -1) - 2 * t(0, -1) - t(1, -1))
    gy = (t(1, -1) + 2 * t(1, 0) + t(1, 1)
          - t(-1, -1) - 2 * t(-1, 0) - t(-1, 1))
    return torch.sqrt(gx * gx + gy * gy)


def laplace_edges(depth_lin, kernel: int = 3):
    """|Laplacian| of the depth (edge_filter.glsl laplace path), (B, H, W):
    the 4-neighbour stencil, or with ``kernel`` != 3 the 8-neighbour
    ring."""
    h, w = depth_lin.shape[1], depth_lin.shape[2]
    pd = _pad_edge(depth_lin, 1, 1)
    if kernel == 3:
        acc = -4.0 * depth_lin
        taps = ((0, 1), (0, -1), (1, 0), (-1, 0))
    else:
        acc = -8.0 * depth_lin
        taps = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                     if dy or dx)
    for dy, dx in taps:
        acc = acc + _tap(pd, dy, dx, 1, 1, h, w)
    return torch.abs(acc)


def smaa_blend_weights(edges):
    """4-direction edge continuity weights (smaa-blend-weights.frag)."""
    h, w = edges.shape[1], edges.shape[2]
    pd = _pad_edge(edges, 1, 1)
    el = _tap(pd, 0, -1, 1, 1, h, w)
    er = _tap(pd, 0, 1, 1, 1, h, w)
    eu = _tap(pd, -1, 0, 1, 1, h, w)
    ed = _tap(pd, 1, 0, 1, 1, h, w)
    tot = el + er + eu + ed + 1e-6
    return torch.stack([el, er, eu, ed], -1) / tot[..., None] \
        * torch.clamp(edges, 0.0, 1.0)[..., None]


def smaa_neighborhood_blend(color, weights):
    """Blend each pixel toward its neighbours by the SMAA weights."""
    wsum = torch.sum(weights, -1, keepdim=True)
    h, w = color.shape[1], color.shape[2]
    pd = _pad_edge(color, 1, 1)
    blended = (
        weights[..., 0:1] * _tap(pd, 0, -1, 1, 1, h, w)
        + weights[..., 1:2] * _tap(pd, 0, 1, 1, 1, h, w)
        + weights[..., 2:3] * _tap(pd, -1, 0, 1, 1, h, w)
        + weights[..., 3:4] * _tap(pd, 1, 0, 1, 1, h, w)
    )
    return color * (1 - wsum * 0.5) + blended * 0.5


_SSAO_TAPS = ((0, 1), (1, 1), (2, 0), (2, -2), (0, -3), (-3, -2),
              (-4, 0), (-3, 3), (0, 5), (4, 4), (1, -2), (-2, 1),
              (5, 0), (-5, 1), (-1, -5), (2, 4))


def ssao_shift(view_pos, view_normal, radius: float = 0.5,
               bias: float = 0.025):
    """Gather-free SSAO with 16 fixed screen-space taps, scored
    horizon-style and attenuated by distance. view_pos (B, H, W, 3);
    returns (B, H, W) in [0, 1] (1 = unoccluded)."""
    n = view_normal
    occ = torch.zeros(view_pos.shape[:3], dtype=view_pos.dtype,
                      device=view_pos.device)
    h, w = view_pos.shape[1], view_pos.shape[2]
    pd = _pad_edge(view_pos, 5, 5)
    for dy, dx in _SSAO_TAPS:
        dvec = _tap(pd, dy, dx, 5, 5, h, w) - view_pos
        d2 = torch.sum(dvec * dvec, -1)
        inv_d = torch.rsqrt(torch.clamp(d2, min=1e-8))
        elev = torch.sum(n * dvec, -1) * inv_d
        atten = torch.clamp(radius * radius / torch.clamp(d2, min=1e-8),
                            0.0, 1.0)
        occ = occ + torch.clamp(elev - bias, min=0.0) * atten
    return 1.0 - torch.clamp(occ / (len(_SSAO_TAPS) * 0.5), 0.0, 1.0)


SSAO_KERNEL_SIZE = 16  # shader_constants.h:11-12


def ssao_kernel(draws=None, device=None):
    """(16, 3) hemisphere samples scaled toward the centre (ssao.c:81).
    ``draws`` (16, 3): uniform draws, x and y in [-1, 1), z in [0, 1).
    None gives the JAX package's default table,
    ``ssao_kernel(jax.random.PRNGKey(7))``, as committed
    (``ops/noise.py::jax_table``), a per-device constant."""
    dev = resolve_device(device)
    if draws is None:
        return mx.const(jax_table("ssao_kernel").tolist(), dev)
    v = torch.as_tensor(draws, dtype=torch.float32, device=dev)
    v = v / torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    scale = torch.linspace(0.1, 1.0, SSAO_KERNEL_SIZE, device=dev) ** 2
    return v * scale[:, None]


def ssao(view_pos, view_normal, kernel, radius: float = 0.5,
         bias: float = 0.025):
    """The reference's hemisphere-sample SSAO (ssao.frag:17-59): per pixel,
    16 view-space offsets around its position, each projected to a pixel
    through the local position gradient and compared with the depth
    stored there; all 16 taps read by one index. view_pos, view_normal
    (B, H, W, 3); kernel (16, 3). Returns (B, H, W) in [0, 1]
    (1 = unoccluded)."""
    B, H, W = view_pos.shape[:3]
    dev = view_pos.device
    xs = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    # per-pixel rotation of the kernel (the blue-noise texture analogue)
    ang = torch.remainder(xs * 12.9898 + ys * 78.233, 2 * math.pi)
    rnd = torch.stack([torch.cos(ang), torch.sin(ang),
                       torch.zeros_like(ang)], -1)
    n = view_normal
    t = rnd - n * torch.sum(rnd * n, -1, keepdim=True)
    t = t / torch.clamp(torch.sqrt(torch.sum(t * t, -1, keepdim=True)),
                        min=1e-6)
    b = torch.cross(n, t, dim=-1)

    depth = view_pos[..., 2]
    px = _pad_edge(view_pos[..., 0], 0, 1)
    py = _pad_edge(view_pos[..., 1], 1, 0)
    dzdx = (_tap(px, 0, 1, 0, 1, H, W) - _tap(px, 0, -1, 0, 1, H, W)) * 0.5
    dzdy = (_tap(py, 1, 0, 1, 0, H, W) - _tap(py, -1, 0, 1, 0, H, W)) * 0.5
    dzdx = torch.where(torch.abs(dzdx) < 1e-6, 1e-6, dzdx)
    dzdy = torch.where(torch.abs(dzdy) < 1e-6, 1e-6, dzdy)
    k = kernel.reshape(SSAO_KERNEL_SIZE, 1, 1, 1, 1, 3)
    offs = t * k[..., 0] + b * k[..., 1] + n * k[..., 2]   # (16, B, H, W, 3)
    sample = view_pos + offs * radius
    du = (sample[..., 0] - view_pos[..., 0]) / dzdx
    dv = (sample[..., 1] - view_pos[..., 1]) / dzdy
    su = torch.clamp(xs + du, 0, W - 1).to(torch.int32)
    sv = torch.clamp(ys + dv, 0, H - 1).to(torch.int32)
    idx = (sv * W + su).long().permute(1, 0, 2, 3).reshape(B, -1)
    stored = torch.gather(depth.reshape(B, H * W), 1, idx).reshape(
        B, SSAO_KERNEL_SIZE, H, W).permute(1, 0, 2, 3)
    sz = sample[..., 2]
    range_check = torch.clamp(radius / torch.clamp(
        torch.abs(depth[None] - stored), min=1e-4), 0.0, 1.0)
    occ = torch.sum(torch.where(stored >= sz + bias, 1.0, 0.0)
                    * range_check, dim=0)
    return 1.0 - occ / SSAO_KERNEL_SIZE


def ssao_blur(ao):
    """4×4 box blur of the ¼-res AO (pipeline-builder.c:457-486)."""
    acc = torch.zeros_like(ao)
    h, w = ao.shape[1], ao.shape[2]
    pd = _pad_edge(ao, 2, 2)
    for dy in (-1, 0, 1, 2):
        for dx in (-1, 0, 1, 2):
            acc = acc + _tap(pd, dy, dx, 2, 2, h, w)
    return acc / 16.0


def radial_fog(color, view_dist, fog_color, fog_near, fog_far, noise=None):
    """Distance fog (combine.frag:35-48): color (B, H, W, 3) towards
    fog_color (3,) by the clamped ramp of view_dist (B, H, W) from
    fog_near to fog_far; ``noise`` (B, H, W) tints the fog colour."""
    span = fog_far - fog_near
    span = torch.clamp(span, min=1e-6) if isinstance(span, torch.Tensor) \
        else max(span, 1e-6)
    f = torch.clamp((view_dist - fog_near) / span, 0.0, 1.0)
    fc = fog_color
    if noise is not None:
        fc = fc * (0.75 + 0.5 * noise[..., None])
    return color * (1 - f[..., None]) + fc * f[..., None]


def contrast(color, amount):
    """Contrast about 0.5 (contrast.frag; combine.frag)."""
    return torch.clamp((color - 0.5) * (1.0 + amount) + 0.5, 0.0, 1.0)


def film_grain(color, noise2d, strength=0.04):
    """Blue-noise grain weighted by the inverse luma (combine.frag:50-63):
    color (B, H, W, 3); noise2d (S, S) or (S, S, 3), tiled over frames
    larger than it like the reference's REPEAT-sampled texture."""
    h, w = color.shape[1], color.shape[2]
    n = noise2d if noise2d.dim() == 3 else noise2d[..., None]
    ry = -(-h // n.shape[0])
    rx = -(-w // n.shape[1])
    if ry > 1 or rx > 1:
        n = n.repeat(ry, rx, 1)
    n = n[:h, :w]
    luma = torch.sum(color * mx.const([0.2126, 0.7152, 0.0722], color.device,
                                      color.dtype), -1, keepdim=True)
    weight = 1.0 - torch.clamp(luma, 0.0, 1.0)
    return color + (n - 0.5) * strength * weight
