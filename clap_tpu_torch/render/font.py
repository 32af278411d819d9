"""Text rendering (counterpart of clap_tpu/render/font.py; reference:
core/font.{c,h} — FreeType glyph atlas). Host numpy, no torch.

Two tiers, same API:

- ``GlyphAtlas``: a baked glyph atlas — ASCII 32..126 rasterized once
  from a TTF through PIL's FreeType bindings into one alpha atlas with
  per-glyph advances, the structure font.c bakes into its texture atlas.
  PIL is imported inside ``__init__``, so importing this module needs
  none. ``load_font()`` finds a system DejaVu face and caches the bake;
  it returns None when PIL or the face is missing.
- a built-in procedural 5×7 bitmap font (column bitmasks, LSB = top
  row), which callers use when ``load_font()`` gives None, and for tiny
  debug overlays.

``render_text`` rasterizes a string to an alpha bitmap on the host; the
UI layer composites it as a textured quad.
"""
from __future__ import annotations

import os

import numpy as np

# 5 columns per glyph, 7 bits per column (LSB = top row)
_G = {
    " ": (0x00, 0x00, 0x00, 0x00, 0x00),
    "A": (0x7E, 0x09, 0x09, 0x09, 0x7E),
    "B": (0x7F, 0x49, 0x49, 0x49, 0x36),
    "C": (0x3E, 0x41, 0x41, 0x41, 0x22),
    "D": (0x7F, 0x41, 0x41, 0x22, 0x1C),
    "E": (0x7F, 0x49, 0x49, 0x49, 0x41),
    "F": (0x7F, 0x09, 0x09, 0x09, 0x01),
    "G": (0x3E, 0x41, 0x49, 0x49, 0x7A),
    "H": (0x7F, 0x08, 0x08, 0x08, 0x7F),
    "I": (0x00, 0x41, 0x7F, 0x41, 0x00),
    "J": (0x20, 0x40, 0x41, 0x3F, 0x01),
    "K": (0x7F, 0x08, 0x14, 0x22, 0x41),
    "L": (0x7F, 0x40, 0x40, 0x40, 0x40),
    "M": (0x7F, 0x02, 0x0C, 0x02, 0x7F),
    "N": (0x7F, 0x04, 0x08, 0x10, 0x7F),
    "O": (0x3E, 0x41, 0x41, 0x41, 0x3E),
    "P": (0x7F, 0x09, 0x09, 0x09, 0x06),
    "Q": (0x3E, 0x41, 0x51, 0x21, 0x5E),
    "R": (0x7F, 0x09, 0x19, 0x29, 0x46),
    "S": (0x46, 0x49, 0x49, 0x49, 0x31),
    "T": (0x01, 0x01, 0x7F, 0x01, 0x01),
    "U": (0x3F, 0x40, 0x40, 0x40, 0x3F),
    "V": (0x1F, 0x20, 0x40, 0x20, 0x1F),
    "W": (0x3F, 0x40, 0x38, 0x40, 0x3F),
    "X": (0x63, 0x14, 0x08, 0x14, 0x63),
    "Y": (0x07, 0x08, 0x70, 0x08, 0x07),
    "Z": (0x61, 0x51, 0x49, 0x45, 0x43),
    "0": (0x3E, 0x51, 0x49, 0x45, 0x3E),
    "1": (0x00, 0x42, 0x7F, 0x40, 0x00),
    "2": (0x42, 0x61, 0x51, 0x49, 0x46),
    "3": (0x21, 0x41, 0x45, 0x4B, 0x31),
    "4": (0x18, 0x14, 0x12, 0x7F, 0x10),
    "5": (0x27, 0x45, 0x45, 0x45, 0x39),
    "6": (0x3C, 0x4A, 0x49, 0x49, 0x30),
    "7": (0x01, 0x71, 0x09, 0x05, 0x03),
    "8": (0x36, 0x49, 0x49, 0x49, 0x36),
    "9": (0x06, 0x49, 0x49, 0x29, 0x1E),
    ".": (0x00, 0x60, 0x60, 0x00, 0x00),
    ",": (0x00, 0x80, 0x60, 0x00, 0x00),
    ":": (0x00, 0x36, 0x36, 0x00, 0x00),
    "!": (0x00, 0x00, 0x5F, 0x00, 0x00),
    "?": (0x02, 0x01, 0x51, 0x09, 0x06),
    "-": (0x08, 0x08, 0x08, 0x08, 0x08),
    "+": (0x08, 0x08, 0x3E, 0x08, 0x08),
    "/": (0x60, 0x10, 0x08, 0x04, 0x03),
    "(": (0x00, 0x1C, 0x22, 0x41, 0x00),
    ")": (0x00, 0x41, 0x22, 0x1C, 0x00),
    "%": (0x23, 0x13, 0x08, 0x64, 0x62),
    "'": (0x00, 0x00, 0x07, 0x00, 0x00),
    "_": (0x40, 0x40, 0x40, 0x40, 0x40),
    "=": (0x14, 0x14, 0x14, 0x14, 0x14),
    ">": (0x41, 0x22, 0x14, 0x08, 0x00),
    "<": (0x08, 0x14, 0x22, 0x41, 0x00),
}

GLYPH_W, GLYPH_H = 5, 7


def glyph_bitmap(ch: str) -> np.ndarray:
    cols = _G.get(ch.upper(), _G["?"])
    g = np.zeros((GLYPH_H, GLYPH_W), np.float32)
    for x, col in enumerate(cols):
        for y in range(GLYPH_H):
            g[y, x] = (col >> y) & 1
    return g


def render_text(text: str, scale: int = 2) -> np.ndarray:
    """(H, W) float alpha bitmap for a single line of text."""
    if not text:
        return np.zeros((GLYPH_H * scale, scale), np.float32)
    glyphs = [glyph_bitmap(c) for c in text]
    pad = np.zeros((GLYPH_H, 1), np.float32)
    row = np.concatenate(sum(([g, pad] for g in glyphs), [])[:-1], axis=1)
    return np.kron(row, np.ones((scale, scale), np.float32))


def text_size(text: str, scale: int = 2) -> tuple[int, int]:
    w = len(text) * (GLYPH_W + 1) * scale - scale if text else scale
    return GLYPH_H * scale, max(w, 1)


# ---------------------------------------------------------------------------
# baked glyph atlas (font.c: FreeType glyphs → one atlas texture +
# per-glyph metrics; here baked through PIL's FreeType bindings)
# ---------------------------------------------------------------------------

_FONT_SEARCH = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
)

_ASCII_FIRST, _ASCII_LAST = 32, 126


class GlyphAtlas:
    """Baked glyph atlas: one (H, W) alpha image holding every ASCII
    glyph cell plus per-glyph advance widths (struct glyph / atlas
    layout of font.c)."""

    def __init__(self, ttf_path: str, size: int = 16):
        from PIL import Image, ImageDraw, ImageFont

        self.size = size
        font = ImageFont.truetype(ttf_path, size)
        ascent, descent = font.getmetrics()
        self.cell_h = ascent + descent
        n = _ASCII_LAST - _ASCII_FIRST + 1
        advances = []
        bitmaps = []
        for code in range(_ASCII_FIRST, _ASCII_LAST + 1):
            ch = chr(code)
            adv = int(round(font.getlength(ch)))
            w = max(adv, 1)
            img = Image.new("L", (w + 2, self.cell_h), 0)
            ImageDraw.Draw(img).text((0, 0), ch, fill=255, font=font)
            bitmaps.append(np.asarray(img, np.float32)[:, :w] / 255.0)
            advances.append(adv)
        self.advance = np.asarray(advances, np.int32)
        self.cell_w = int(self.advance.max()) + 1
        atlas = np.zeros((self.cell_h, self.cell_w * n), np.float32)
        for i, bm in enumerate(bitmaps):
            atlas[:, i * self.cell_w : i * self.cell_w + bm.shape[1]] = bm
        self.atlas = atlas          # (cell_h, cell_w · n_glyphs)

    def _cell(self, ch: str) -> tuple[np.ndarray, int]:
        code = ord(ch)
        if not (_ASCII_FIRST <= code <= _ASCII_LAST):
            code = ord("?")
        i = code - _ASCII_FIRST
        adv = int(self.advance[i])
        return self.atlas[:, i * self.cell_w : i * self.cell_w
                          + max(adv, 1)], adv

    def render_text(self, text: str, scale: int = 1) -> np.ndarray:
        """(H, W) float alpha bitmap for one line."""
        if not text:
            return np.zeros((self.cell_h * scale, scale), np.float32)
        cols = []
        for ch in text:
            bm, adv = self._cell(ch)
            cols.append(bm)
        row = np.concatenate(cols, axis=1)
        if scale != 1:
            row = np.kron(row, np.ones((scale, scale), np.float32))
        return row

    def text_size(self, text: str, scale: int = 1) -> tuple[int, int]:
        w = int(sum(max(int(self._cell(c)[1]), 1) for c in text)) if text \
            else 1
        return self.cell_h * scale, max(w * scale, 1)


_ATLAS_CACHE: dict = {}


def load_font(size: int = 16, path: str | None = None):
    """Bake (and cache) a glyph atlas from a system TTF; returns None
    when neither PIL nor a known font file is available — callers fall
    back to the procedural 5×7 font."""
    key = (path, size)
    if key in _ATLAS_CACHE:
        return _ATLAS_CACHE[key]
    candidates = [path] if path else list(_FONT_SEARCH)
    atlas = None
    for p in candidates:
        if p and os.path.exists(p):
            try:
                atlas = GlyphAtlas(p, size)
                break
            except Exception:
                continue
    _ATLAS_CACHE[key] = atlas
    return atlas
