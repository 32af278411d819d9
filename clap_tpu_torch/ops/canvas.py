"""CPU-style canvas ops + texture format conversions (counterpart of
clap_tpu/ops/canvas.py; reference: render-texture.c + draw.c —
blit/fill/blend across RGBA8/16F/32F, test.c:906-1279).

Image ops on tensors of any device. Formats are torch dtypes: uint8
(RGBA8), float16 (RGBA16F), float32 (RGBA32F); conversions normalize
u8 ↔ [0, 1] floats like the reference's texel converters, through
float32 (``torch.round`` rounds half to even, as ``jnp.rint`` does), so
the results equal the JAX package's. Each op returns a new tensor.
"""
from __future__ import annotations

import torch


def convert(img, dtype):
    """Format conversion with u8 normalization semantics."""
    src = img.dtype
    if src == dtype:
        return img
    if src == torch.uint8:
        return img.to(torch.float32).div(255.0).to(dtype)
    # float source
    if dtype == torch.uint8:
        return torch.clamp(torch.round(img.to(torch.float32) * 255.0), 0,
                           255).to(torch.uint8)
    return img.to(dtype)


def canvas_fill(img, color):
    """Fill with a color (float colors auto-quantize for u8 canvases)."""
    c = torch.as_tensor(color, device=img.device)
    if img.dtype == torch.uint8 and c.dtype != torch.uint8:
        c = torch.clamp(torch.round(c * 255.0), 0, 255).to(torch.uint8)
    return c.to(img.dtype).expand(img.shape).clone()


def _clip(dst, src, x: int, y: int):
    """The window of src that lands on dst at (x, y): (x0, y0, x1, y1) in
    dst's pixels, or None when nothing does."""
    H, W = dst.shape[0], dst.shape[1]
    h, w = src.shape[0], src.shape[1]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, W), min(y + h, H)
    if x1 <= x0 or y1 <= y0:
        return None
    return x0, y0, x1, y1


def canvas_blit(dst, src, x: int, y: int):
    """Copy src onto dst at (x, y), clipped; formats converted to dst's."""
    win = _clip(dst, src, x, y)
    if win is None:
        return dst.clone()
    x0, y0, x1, y1 = win
    out = dst.clone()
    out[y0:y1, x0:x1] = convert(src, dst.dtype)[y0 - y:y1 - y, x0 - x:x1 - x]
    return out


def canvas_blend(dst, src, x: int, y: int):
    """Alpha-blend an RGBA src over dst at (x, y) (premultiply-free
    src-over, draw.c blend semantics)."""
    win = _clip(dst, src, x, y)
    if win is None:
        return dst.clone()
    x0, y0, x1, y1 = win
    s = convert(src, torch.float32)[y0 - y:y1 - y, x0 - x:x1 - x]
    d = convert(dst[y0:y1, x0:x1], torch.float32)
    a = s[..., 3:4]
    out_rgb = s[..., :3] * a + d[..., :3] * (1 - a)
    out_a = a + d[..., 3:4] * (1 - a)
    out = dst.clone()
    out[y0:y1, x0:x1] = convert(torch.cat([out_rgb, out_a], -1), dst.dtype)
    return out
