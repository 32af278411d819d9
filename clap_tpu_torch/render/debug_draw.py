"""Debug draw overlay (counterpart of clap_tpu/render/debug_draw.py;
reference: core/debug_draw.c + the MT_DEBUG_DRAW message channel,
messagebus.h:112-132 — physics capsules/contacts, camera/light frusta,
AABBs, grids drawn per camera).

Primitives accumulate into a fixed-capacity line buffer; ``draw_lines``
rasterizes them over one frame in plain torch (parametric line sampling;
no kernel at debug-overlay densities). AABB and cross helpers expand to
lines like the reference's consumers.

One deliberate difference: the JAX package scatters every sample and
writes a masked one's pixel back with the frame's own value, so an unused
slot (a = b = 0) or an off-screen sample clipped onto a border pixel can
erase a line drawn by an earlier slot. The port writes only valid
samples; where several hit one pixel, the one with the highest (line,
sample) index wins, the reference's order without the erasures. The
winner is found with a scatter-max of the sample ids, so the result is
the same on every run and on every device, and nothing is read back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx
from ..device import resolve_device

MAX_LINES = 512
LINE_SAMPLES = 256   # samples along each line

# the 12 edges of a box over its corners (corner k: x, y, z from bits 0-2)
_BOX_EDGES = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
              (0, 4), (1, 5), (2, 6), (3, 7))


class DebugLines(NamedTuple):
    a: torch.Tensor       # (N, 3) world-space start
    b: torch.Tensor       # (N, 3) end
    color: torch.Tensor   # (N, 3)
    valid: torch.Tensor   # (N,) bool


def lines_empty(n: int = MAX_LINES, device=None) -> DebugLines:
    dev = resolve_device(device)
    return DebugLines(
        a=torch.zeros(n, 3, device=dev), b=torch.zeros(n, 3, device=dev),
        color=torch.ones(n, 3, device=dev),
        valid=torch.zeros(n, dtype=torch.bool, device=dev))


def _put(dst, rows, value):
    """dst[rows] = value for a tensor (any device) or a host sequence of
    numbers, each number filled in (a kernel argument: no host-to-device
    copy, which would wait on the card)."""
    if isinstance(value, torch.Tensor):
        dst[rows] = value.to(dst.dtype)
    else:
        for k, v in enumerate(value):
            dst[rows, k].fill_(float(v))


def _copy(dl: DebugLines) -> DebugLines:
    return DebugLines(*(x.clone() for x in dl))


def add_line(dl: DebugLines, idx: int, a, b, color=(1.0, 1.0, 0.0)):
    """The buffer with slot ``idx`` set to the line a → b (a new buffer:
    ``dl`` is left as it is). Returns (buffer, idx + 1)."""
    dl = _copy(dl)
    _put(dl.a, idx, a)
    _put(dl.b, idx, b)
    _put(dl.color, idx, color)
    dl.valid[idx].fill_(True)
    return dl, idx + 1


def _fill(dl: DebugLines, idx: int, a, b, color):
    """Slots idx .. idx + len(a) - 1 set to the lines a[k] → b[k], all in
    one colour (in place)."""
    rows = slice(idx, idx + a.shape[0])
    dl.a[rows] = a
    dl.b[rows] = b
    _put(dl.color, rows, color)
    dl.valid[rows].fill_(True)
    return rows.stop


def add_aabb(dl: DebugLines, idx: int, mn, mx_, color=(0.0, 1.0, 0.0)):
    """12 edges of a box (debug_draw.c AABB consumer), slots idx .. idx +
    11 in the reference's edge order. Returns (buffer, idx + 12)."""
    dev = dl.a.device
    mn = torch.as_tensor(mn, dtype=torch.float32, device=dev)
    mx_ = torch.as_tensor(mx_, dtype=torch.float32, device=dev)
    bits = mx.const([[(k >> i) & 1 for i in range(3)] for k in range(8)],
                    dev, torch.bool)
    corners = torch.where(bits, mx_, mn)                   # (8, 3)
    e = mx.const(_BOX_EDGES, dev, torch.long)
    dl = _copy(dl)
    return dl, _fill(dl, idx, corners[e[:, 0]], corners[e[:, 1]], color)


def add_cross(dl: DebugLines, idx: int, p, size=0.25, color=(1.0, 0.0, 0.0)):
    """Three axis lines of half-length ``size`` through ``p``. Returns
    (buffer, idx + 3)."""
    dev = dl.a.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)
    off = mx.const([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]], dev) * size
    dl = _copy(dl)
    return dl, _fill(dl, idx, p - off, p + off, color)


def _project(p, vp, W: int, H: int):
    """Screen x, y of world points (N, 3) under vp (4, 4), and w > 1e-4.
    Each clip row is summed (m0·x + m1·y) + (m2·z + m3), the order of the
    JAX package's einsum on the CPU."""
    x, y, z = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    c = (vp[:, 0] * x + vp[:, 1] * y) + (vp[:, 2] * z + vp[:, 3])
    w = c[:, 3]
    ok = w > 1e-4
    ndc = c[:, :2] / torch.where(ok, w, 1.0)[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * W
    sy = (0.5 - ndc[:, 1] * 0.5) * H
    return sx, sy, ok


def draw_lines(frame, dl: DebugLines, view, proj):
    """Rasterize debug lines over one frame (H, W, C): project endpoints,
    sample LINE_SAMPLES points per line, and write each pixel hit by a
    valid sample (a valid line, both ends in front of the camera, the
    sample on screen) with the colour of its highest (line, sample) hit.
    Returns a new frame."""
    H, W = frame.shape[0], frame.shape[1]
    dev = frame.device
    vp = proj @ view
    ax, ay, aok = _project(dl.a, vp, W, H)
    bx, by, bok = _project(dl.b, vp, W, H)
    ok = dl.valid & aok & bok

    # jnp.linspace(0, 1, S) as XLA computes it: i · fl(1 / (S - 1)), the
    # last sample exactly 1
    i = torch.arange(LINE_SAMPLES, dtype=torch.float32, device=dev)
    t = torch.where(i == LINE_SAMPLES - 1, 1.0,
                    i * (1.0 / (LINE_SAMPLES - 1)))
    px = ax[:, None] * (1 - t)[None] + bx[:, None] * t[None]     # (N, S)
    py = ay[:, None] * (1 - t)[None] + by[:, None] * t[None]
    inb = ok[:, None] & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    xi = torch.clamp(px.to(torch.int32), 0, W - 1)
    yi = torch.clamp(py.to(torch.int32), 0, H - 1)
    pix = (yi.long() * W + xi.long()).reshape(-1)
    sid = torch.arange(pix.numel(), device=dev)
    winner = torch.full((H * W,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, pix, torch.where(inb.reshape(-1), sid, -1),
                           reduce="amax")
    col = dl.color.to(frame.dtype)[winner.clamp(min=0) // LINE_SAMPLES]
    flat = frame.reshape(H * W, -1)
    return torch.where((winner >= 0)[:, None], col, flat).reshape(
        frame.shape)
