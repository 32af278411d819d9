"""Colour-grading 3-D LUTs (counterpart of clap_tpu/render/lut.py;
reference core/lut.{c,h}, shaders lut.glsl).

Each of the 14 presets (names, exposure and contrast of lut.c:172-258) is
an RGB → RGB transform; ``bake_lut`` evaluates one on a size³ lattice and
``apply_lut`` fetches it trilinearly, over any leading axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..device import resolve_device


def _v(values, like):
    return torch.tensor(values, dtype=like.dtype, device=like.device)


def _clamp(x):
    return torch.clamp(x, 0.0, 1.0)


def _luma(c):
    return torch.sum(c * _v([0.3, 0.59, 0.11], c), -1, keepdim=True)


def _identity(c):
    return c


def _orange_blue_filmic(c):
    l = _luma(c)
    warm = c * _v([1.15, 1.0, 0.8], c)
    cool = c * _v([0.85, 0.95, 1.25], c)
    return _clamp(warm * l + cool * (1 - l))


def _comic(c, channel):
    boost = [0.0, 0.0, 0.0]
    boost[channel] = 0.35
    q = torch.round(c * 5.0) / 5.0   # posterize
    return _clamp(q * (1.0 - 0.2) + _v(boost, c) * _luma(c))


def _sunset_warm(c):
    return _clamp(c * _v([1.2, 1.0, 0.75], c) + _v([0.05, 0.02, 0.0], c))


def _hyper_sunset(c):
    g = torch.pow(_clamp(c), _v([0.8, 1.0, 1.3], c))
    return _clamp(g * _v([1.4, 0.95, 0.7], c))


def _green_matrix(c):
    l = _luma(c)
    return _clamp(torch.cat([l * 0.2, l * 1.1, l * 0.3], -1))


def _scifi_bluegreen(c):
    return _clamp(c * _v([0.7, 1.1, 1.2], c))


def _scifi_neon(c):
    g = torch.pow(_clamp(c), 1.5)
    return _clamp(g * _v([1.3, 0.7, 1.5], c))


def _deep_sea_abyss(c):
    l = _luma(c)
    return _clamp(torch.cat(
        [c[..., :1] * 0.25, c[..., 1:2] * 0.6 + l * 0.1,
         c[..., 2:3] * 0.9 + l * 0.2], -1))


def _bloodveil_crimson(c):
    l = _luma(c)
    return _clamp(torch.cat(
        [c[..., :1] * 1.3 + l * 0.2, c[..., 1:2] * 0.5, c[..., 2:3] * 0.5],
        -1))


def _mad_max_bleach(c):
    l = _luma(c)
    harsh = torch.clamp(l * 1.6, max=1.0)
    return _clamp(torch.cat([
        torch.maximum(c[..., :1], harsh),
        torch.maximum(c[..., 1:2] * 0.9, harsh * 0.8),
        torch.maximum(c[..., 2:3] * 0.6, harsh * 0.6),
    ], -1))


def _teal_orange(c):
    p = torch.pow(_clamp(c), _v([0.9, 1.0, 1.1], c))
    r = p[..., :1] * 1.3 - p[..., 2:3] * 0.2
    g = p[..., 1:2] + p[..., 2:3] * 0.05
    b = p[..., 2:3] * 1.1 - p[..., :1] * 0.2 - p[..., 1:2] * 0.1
    return _clamp(torch.cat([r, g, b], -1))


@dataclass(frozen=True)
class LutPreset:
    name: str
    fn: Callable
    exposure: float
    contrast: float


# lut.c:172-258 (names, exposure, contrast)
LUT_PRESETS = (
    LutPreset("identity", _identity, 2.0, 0.05),
    LutPreset("orange blue filmic", _orange_blue_filmic, 1.8, 0.05),
    LutPreset("comic red", lambda c: _comic(c, 0), 2.4, 0.05),
    LutPreset("comic green", lambda c: _comic(c, 1), 2.4, 0.05),
    LutPreset("comic blue", lambda c: _comic(c, 2), 2.4, 0.05),
    LutPreset("sunset warm", _sunset_warm, 2.0, 0.01),
    LutPreset("hyper sunset", _hyper_sunset, 1.0, 0.05),
    LutPreset("green matrix", _green_matrix, 2.0, 0.05),
    LutPreset("scifi bluegreen", _scifi_bluegreen, 2.0, 0.05),
    LutPreset("scifi neon", _scifi_neon, 5.0, 0.01),
    LutPreset("deep sea abyss", _deep_sea_abyss, 2.4, 0.1),
    LutPreset("bloodveil crimson", _bloodveil_crimson, 2.4, 0.1),
    LutPreset("mad max bleach", _mad_max_bleach, 2.0, 0.05),
    LutPreset("teal orange", _teal_orange, 2.0, 0.05),
)


def lut_find(name: str) -> LutPreset:
    for p in LUT_PRESETS:
        if p.name == name:
            return p
    raise KeyError(name)


def bake_lut(preset: LutPreset, size: int = 32, device=None):
    """(size, size, size, 3) LUT volume (lut_generate, lut.c:323-363): the
    preset evaluated on the RGB lattice, red along axis 0."""
    ax = torch.linspace(0.0, 1.0, size, device=resolve_device(device))
    r, g, b = torch.meshgrid(ax, ax, ax, indexing="ij")
    return preset.fn(torch.stack([r, g, b], -1))


def apply_lut(color, lut_volume):
    """Trilinear 3-D LUT fetch (lut.glsl) of color (..., 3) in [0, 1]."""
    s = lut_volume.shape[0]
    c = torch.clamp(color, 0.0, 1.0) * (s - 1)
    i0 = torch.clamp(torch.floor(c).to(torch.int32), 0, s - 2)   # NaN too
    f = c - i0
    i0 = i0.long()
    r0, g0, b0 = i0[..., 0], i0[..., 1], i0[..., 2]

    def at(dr, dg, db):
        return lut_volume[r0 + dr, g0 + dg, b0 + db]

    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = at(0, 0, 0) * (1 - fr) + at(1, 0, 0) * fr
    c10 = at(0, 1, 0) * (1 - fr) + at(1, 1, 0) * fr
    c01 = at(0, 0, 1) * (1 - fr) + at(1, 0, 1) * fr
    c11 = at(0, 1, 1) * (1 - fr) + at(1, 1, 1) * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    return c0 * (1 - fb) + c1 * fb
