"""Baked and analytic noise and film-grain blue noise (counterpart of
clap_tpu/ops/noise.py; reference: core/noise.{c,h}, shaders noise.glsl).

- ``hash31`` / ``value_noise3d_periodic`` / ``fbm3_periodic`` /
  ``noise_grad3d``: the host bake in numpy, copied from the JAX package:
  the tileable 3-D fBm gradient volume as RGBA8
  (noise_grad3d_bake_rgba8, noise.c:223-270), equal to the reference's
  byte for byte.
- ``noise3d_field``: the normalised gradient of periodic value-noise fBm
  that the reference bakes into a 3-D texture (noise_grad3d_bake_rgba8,
  noise.c:223-270), evaluated per point instead of sampled. Its hash is
  hash31 (noise.h:9-17) with exact uint32 wraparound, done in int64 with
  a mask after every product and sum.
- ``noise_glsl`` / ``fog_cloud``: the shader's cheap value noise and the
  fog density built on the field (noise.glsl:5-38, 142-147).
- ``blue_noise2d`` / ``blue_noise_luma``: the film-grain texture
  (blue_noise2d_tex, noise.c:96-148), spectrally shaped from uniform
  draws. The JAX package draws them from ``jax.random.PRNGKey(0)``, which
  torch cannot reproduce, so the default 64² texture is that draw's
  result, committed in ``clap_tpu_torch/data/jax_tables.npz``
  (``tools/torch_jax_tables.py`` regenerates it).
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device

_M32 = 0xFFFFFFFF
TABLES = Path(__file__).resolve().parents[1] / "data" / "jax_tables.npz"


@functools.lru_cache(maxsize=None)
def jax_table(name: str) -> np.ndarray:
    """A table the JAX package draws from its PRNG, as committed:
    ``ssao_kernel`` (16, 3) or ``blue_noise2d`` (64, 64, 3), float32,
    read once (read-only)."""
    with np.load(TABLES) as z:
        t = z[name]
    t.setflags(write=False)
    return t


def _smooth(t):
    return t * t * (3.0 - 2.0 * t)


# ---------------------------------------------------------------------------
# the host bake (numpy)
# ---------------------------------------------------------------------------

def hash31(x, y, z, seed):
    """noise.h:9-17, exact integer replica (uint32 wraparound)."""
    x = np.asarray(x).astype(np.uint32)
    y = np.asarray(y).astype(np.uint32)
    z = np.asarray(z).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = (x * np.uint32(374761393) + y * np.uint32(668265263)
             + z * np.uint32(362437) + np.uint32(seed) * np.uint32(2246822519))
        h = (h ^ (h >> np.uint32(13))) * np.uint32(1274126177)
        h = h ^ (h >> np.uint32(16))
    return h.astype(np.float64) * (1.0 / 4294967296.0)


def value_noise3d_periodic(x, y, z, period: int, seed: int):
    """noise.c:172-204 vectorized (numpy, host bake)."""
    xi0 = np.floor(x).astype(np.int64)
    yi0 = np.floor(y).astype(np.int64)
    zi0 = np.floor(z).astype(np.int64)
    xf, yf, zf = x - xi0, y - yi0, z - zi0

    def wrap(i):
        return (i % period + period) % period

    c = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c[(dx, dy, dz)] = hash31(wrap(xi0 + dx), wrap(yi0 + dy),
                                         wrap(zi0 + dz), seed)
    ux, uy, uz = _smooth(xf), _smooth(yf), _smooth(zf)
    x00 = c[(0, 0, 0)] * (1 - ux) + c[(1, 0, 0)] * ux
    x10 = c[(0, 1, 0)] * (1 - ux) + c[(1, 1, 0)] * ux
    x01 = c[(0, 0, 1)] * (1 - ux) + c[(1, 0, 1)] * ux
    x11 = c[(0, 1, 1)] * (1 - ux) + c[(1, 1, 1)] * ux
    y0 = x00 * (1 - uy) + x10 * uy
    y1 = x01 * (1 - uy) + x11 * uy
    return y0 * (1 - uz) + y1 * uz


def fbm3_periodic(x, y, z, octaves: int, lacunarity: float, gain: float,
                  period: int, seed: int):
    """noise.c:206-221."""
    a, v = 0.5, np.zeros_like(np.asarray(x, np.float64))
    fx, fy, fz = (np.asarray(t, np.float64) for t in (x, y, z))
    p = period
    for i in range(octaves):
        v = v + value_noise3d_periodic(fx, fy, fz, p, seed + i) * a
        fx, fy, fz = fx * lacunarity, fy * lacunarity, fz * lacunarity
        p = int(round(p * lacunarity))
        a *= gain
    return v


def noise_grad3d(size: int = 32, octaves: int = 4, lacunarity: float = 2.0,
                 gain: float = 0.5, period_units: float = 8.0,
                 seed: int = 1337) -> np.ndarray:
    """(size, size, size, 4) uint8 baked gradient volume
    (noise_grad3d_bake_rgba8, noise.c:223-270)."""
    step = period_units / size
    eps = step
    zs, ys, xs = np.meshgrid(np.arange(size) * step, np.arange(size) * step,
                             np.arange(size) * step, indexing="ij")
    p = int(period_units)

    def f(px, py, pz):
        return fbm3_periodic(px, py, pz, octaves, lacunarity, gain, p, seed)

    gx = (f(xs + eps, ys, zs) - f(xs - eps, ys, zs)) * (0.5 / eps)
    gy = (f(xs, ys + eps, zs) - f(xs, ys - eps, zs)) * (0.5 / eps)
    gz = (f(xs, ys, zs + eps) - f(xs, ys, zs - eps)) * (0.5 / eps)
    ln = np.sqrt(np.maximum(gx * gx + gy * gy + gz * gz, 1e-30))
    out = np.zeros((size, size, size, 4), np.uint8)
    out[..., 0] = np.rint((gx / ln * 0.5 + 0.5) * 255).astype(np.uint8)
    out[..., 1] = np.rint((gy / ln * 0.5 + 0.5) * 255).astype(np.uint8)
    out[..., 2] = np.rint((gz / ln * 0.5 + 0.5) * 255).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# the device half
# ---------------------------------------------------------------------------

def _hash31(x, y, z, seed: int):
    """hash31 (noise.h:9-17) of integer tensors: uint32 arithmetic with
    wraparound, in int64 masked to 32 bits after every product and sum.
    Returns float32 in [0, 1)."""
    m = _M32
    x, y, z = (t.to(torch.int64) & m for t in (x, y, z))
    s = (seed & m) * 2246822519 & m
    h = ((x * 374761393 & m) + (y * 668265263 & m)) & m
    h = (h + (z * 362437 & m)) & m
    h = (h + s) & m
    h = (h ^ (h >> 13)) * 1274126177 & m
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _value_noise3d(x, y, z, period: int, seed: int):
    """value_noise3d_periodic (noise.c:172-204): trilinear value noise on
    an integer lattice that repeats every ``period`` cells."""
    xi0, yi0, zi0 = (torch.floor(t).to(torch.int32) for t in (x, y, z))
    xf, yf, zf = x - torch.floor(x), y - torch.floor(y), z - torch.floor(z)

    def wrap(i):
        return torch.remainder(i, period)

    c = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c[(dx, dy, dz)] = _hash31(wrap(xi0 + dx), wrap(yi0 + dy),
                                          wrap(zi0 + dz), seed)
    ux, uy, uz = _smooth(xf), _smooth(yf), _smooth(zf)
    x00 = c[(0, 0, 0)] * (1 - ux) + c[(1, 0, 0)] * ux
    x10 = c[(0, 1, 0)] * (1 - ux) + c[(1, 1, 0)] * ux
    x01 = c[(0, 0, 1)] * (1 - ux) + c[(1, 0, 1)] * ux
    x11 = c[(0, 1, 1)] * (1 - ux) + c[(1, 1, 1)] * ux
    y0 = x00 * (1 - uy) + x10 * uy
    y1 = x01 * (1 - uy) + x11 * uy
    return y0 * (1 - uz) + y1 * uz


def _fbm3(x, y, z, octaves: int, lacunarity: float, gain: float,
          period: int, seed: int):
    """fbm3_periodic (noise.c:206-221): each octave's period is the last
    one times the lacunarity, rounded."""
    a, v = 0.5, torch.zeros_like(x)
    p = period
    for i in range(octaves):
        v = v + _value_noise3d(x, y, z, p, seed + i) * a
        x, y, z = x * lacunarity, y * lacunarity, z * lacunarity
        p = int(round(p * lacunarity))
        a *= gain
    return v


def noise3d_field(pos, freq, octaves: int = 4, lacunarity: float = 2.0,
                  gain: float = 0.5, period: int = 8, seed: int = 1337,
                  size: int = 32):
    """sample_noise3d (noise.glsl:74-77) without the texture: the unit
    gradient of the periodic fBm at ``pos · freq`` (texture coordinates
    per world unit), central differences at the bake's voxel step
    ``period / size``. pos (..., 3) → (..., 3) in [-1, 1]."""
    q = pos * (freq * period)
    eps = period / size

    def f(dx, dy, dz):
        return _fbm3(q[..., 0] + dx, q[..., 1] + dy, q[..., 2] + dz,
                     octaves, lacunarity, gain, period, seed)

    gx = (f(eps, 0, 0) - f(-eps, 0, 0)) * (0.5 / eps)
    gy = (f(0, eps, 0) - f(0, -eps, 0)) * (0.5 / eps)
    gz = (f(0, 0, eps) - f(0, 0, -eps)) * (0.5 / eps)
    g = torch.stack([gx, gy, gz], dim=-1)
    return g / torch.clamp(torch.sqrt(torch.sum(g * g, -1, keepdim=True)),
                           min=1e-15)


def noise_glsl(p):
    """The shader's hash-based value noise (noise.glsl:5-38), the cheap
    jitter of the noise3d coordinates. p (..., 3) → (...)."""
    def hsh(q):
        q = q * 0.3183099 + mx.const([0.1, 0.2, 0.3], q.device, q.dtype)
        q = (q - torch.floor(q)) * 17.0
        v = q[..., 0] * q[..., 1] * q[..., 2] \
            * (q[..., 0] + q[..., 1] + q[..., 2])
        return v - torch.floor(v)

    i = torch.floor(p)
    f = p - i
    u = f * f * (3.0 - 2.0 * f)
    c = {}
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c[(dx, dy, dz)] = hsh(i + mx.const([dx, dy, dz], p.device,
                                                   p.dtype))
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    x0 = c[(0, 0, 0)] * (1 - ux) + c[(1, 0, 0)] * ux
    x1 = c[(0, 1, 0)] * (1 - ux) + c[(1, 1, 0)] * ux
    x2 = c[(0, 0, 1)] * (1 - ux) + c[(1, 0, 1)] * ux
    x3 = c[(0, 1, 1)] * (1 - ux) + c[(1, 1, 1)] * ux
    y0 = x0 * (1 - uy) + x1 * uy
    y1 = x2 * (1 - uy) + x3 * uy
    return y0 * (1 - uz) + y1 * uz


def fog_cloud(pos, amp, freq, **noise_kw):
    """fog_cloud (noise.glsl:142-147): fog density in [0, 1] from the
    gradient field's x component at the jittered position."""
    # (z, x, y): the jitter reads the swizzled position
    p = pos + noise_glsl(torch.roll(pos, 1, -1))[..., None]
    d = noise3d_field(p, freq, **noise_kw)[..., 0]
    return torch.clamp(d * amp, 0.0, 1.0)


def blue_noise2d(size: int = 64, draws=None, device=None):
    """(size, size, 3) blue noise (noise.c:96-148): per channel, uniform
    noise weighted by luma, high-passed by the gain r / r_max in frequency
    space. ``draws`` (3, size, size) are the channels' uniform draws in
    [0, 1); None gives the JAX package's default, ``blue_noise2d(64)`` on
    ``PRNGKey(0)``, as committed."""
    dev = resolve_device(device)
    if draws is None:
        if size != 64:
            raise ValueError("the committed blue noise is 64²; pass draws "
                             "for other sizes")
        return torch.tensor(jax_table("blue_noise2d"), device=dev)
    draws = torch.as_tensor(draws, dtype=torch.float32, device=dev)
    f = torch.fft.fftfreq(size, device=dev) * size
    r = torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    gain = r / (math.sqrt(2.0) * (size / 2))
    chans = []
    for u, w in zip(draws, (0.299, 0.587, 0.114)):
        v = (u * 4.0 - 1.0) / 3.0 * w
        chans.append(torch.fft.ifft2(torch.fft.fft2(v) * gain).real)
    return torch.stack(chans, -1)


def blue_noise_luma(size: int = 64, draws=None, device=None):
    """Single-channel grain: the blue noise's channel sum scaled to
    [0, 1]."""
    n = blue_noise2d(size, draws, device).sum(-1)
    lo, hi = n.min(), n.max()
    return (n - lo) / torch.clamp(hi - lo, min=1e-9)
