"""Texture sampling for the per-pixel gather path (counterpart of
clap_tpu/render/texture.py; reference: model3dtx's texture slots and
model.frag's diffuse/normal/emission samplers).

The per-pixel uv comes from the interpolated attribute record. Textures are
(H, W, C) float tensors, stacked (L, H, W, C) per model layer. Wrap is
GL_REPEAT, floor modulo (``torch.remainder``) as ``jnp.mod`` is; clamp is
GL_CLAMP_TO_EDGE.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _quad_pack(tex, wrap: bool):
    """Each texel's 2×2 bilinear footprint packed into one row of 4C
    channels (self | right | down | down-right), so a bilinear fetch reads
    one row; ``wrap`` picks wrapped or clamped neighbours."""
    if wrap:
        right = torch.roll(tex, -1, dims=-2)
        down = torch.roll(tex, -1, dims=-3)
        down_r = torch.roll(right, -1, dims=-3)
    else:
        right = torch.cat([tex[..., 1:, :], tex[..., -1:, :]], dim=-2)
        down = torch.cat([tex[..., 1:, :, :], tex[..., -1:, :, :]], dim=-3)
        down_r = torch.cat([right[..., 1:, :, :], right[..., -1:, :, :]],
                           dim=-3)
    return torch.cat([tex, right, down, down_r], dim=-1)


def upload_texture(rgba_u8: np.ndarray, device=None) -> torch.Tensor:
    """uint8 texels → a float texture in [0, 1] on ``device``."""
    return torch.as_tensor(np.asarray(rgba_u8), dtype=torch.float32,
                           device=resolve_device(device)) / 255.0


def _texel_coords(uv, ht: int, wt: int, wrap: bool):
    """Bilinear footprint of uv (..., 2): (v0, u0) int64 and the weights
    (fu, fv) (..., 1)."""
    u = uv[..., 0] * wt - 0.5
    v = uv[..., 1] * ht - 0.5
    if wrap:
        u = torch.remainder(u, wt)
        v = torch.remainder(v, ht)
    u0 = torch.floor(u).to(torch.int32)
    v0 = torch.floor(v).to(torch.int32)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    if wrap:
        u0 = torch.remainder(u0, wt)
        v0 = torch.remainder(v0, ht)
    else:
        u0 = torch.clamp(u0, 0, wt - 1)
        v0 = torch.clamp(v0, 0, ht - 1)
    return v0.long(), u0.long(), fu, fv


def _bilerp(m, C, fu, fv):
    a, b = m[..., :C], m[..., C:2 * C]
    c, d = m[..., 2 * C:3 * C], m[..., 3 * C:]
    return (a * (1 - fu) + b * fu) * (1 - fv) + (c * (1 - fu) + d * fu) * fv


def sample_bilinear(tex, uv, wrap: bool = True):
    """Bilinear fetch from tex (Ht, Wt, C) at uv (..., 2) in texture space;
    ``wrap`` repeats (the model default), else clamps."""
    ht, wt, C = tex.shape
    v0, u0, fu, fv = _texel_coords(uv, ht, wt, wrap)
    m = _quad_pack(tex, wrap).reshape(-1, 4 * C)[v0 * wt + u0]
    return _bilerp(m, C, fu, fv)


def sample_nearest(tex, uv, wrap: bool = True):
    """Nearest fetch: uv·size truncated toward zero, then wrapped or
    clamped."""
    ht, wt = tex.shape[0], tex.shape[1]
    u = (uv[..., 0] * wt).to(torch.int32)
    v = (uv[..., 1] * ht).to(torch.int32)
    if wrap:
        u = torch.remainder(u, wt)
        v = torch.remainder(v, ht)
    else:
        u = torch.clamp(u, 0, wt - 1)
        v = torch.clamp(v, 0, ht - 1)
    return tex[v.long(), u.long()]


def sample_layered(tex, layer, uv, wrap: bool = True):
    """Bilinear fetch from stacked per-model layers tex (L, Ht, Wt, C):
    ``layer`` (...,) int selects the model's texture set (clamped to the
    stack), uv (..., 2)."""
    n_layers, ht, wt, C = tex.shape
    v0, u0, fu, fv = _texel_coords(uv, ht, wt, wrap)
    li = torch.clamp(layer, 0, n_layers - 1).long()
    m = _quad_pack(tex, wrap).reshape(-1, 4 * C)[(li * ht + v0) * wt + u0]
    return _bilerp(m, C, fu, fv)
