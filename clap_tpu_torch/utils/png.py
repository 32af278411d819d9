"""PNG codec (counterpart of clap_tpu/utils/png.py; reference:
core/pngloader.c — libpng decode to RGBA).

stdlib-only (zlib + struct) decoder/encoder for the subset game assets
use: 8-bit gray/RGB/RGBA (+ palette), filters 0-4, no interlace. The
encoder also gives the demos real frame dumps (scene_save's screenshot
role).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def decode_png(data: bytes) -> np.ndarray:
    """→ (H, W, 4) uint8 RGBA (like pngloader.c's RGBA canvas)."""
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    plte = None
    trns = None
    w = h = depth = ctype = None
    while pos < len(data):
        ln, typ = struct.unpack_from(">I4s", data, pos)
        chunk = data[pos + 8 : pos + 8 + ln]
        pos += 12 + ln
        if typ == b"IHDR":
            w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(
                ">IIBBBBB", chunk)
            if depth != 8 or interlace:
                raise ValueError("only 8-bit non-interlaced PNGs supported")
        elif typ == b"PLTE":
            plte = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif typ == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif typ == b"IDAT":
            idat += chunk
        elif typ == b"IEND":
            break
    raw = zlib.decompress(idat)
    nch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = w * nch
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(h):
        f = raw[off]
        line = np.frombuffer(raw, np.uint8, stride, off + 1).astype(np.int32)
        off += 1 + stride
        if f == 0:
            cur = line
        elif f == 2:  # up
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + b) >> 1
                else:  # 4 paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        img[y] = cur.astype(np.uint8)
        prev = cur
    px = img.reshape(h, w, nch)
    out = np.zeros((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 0:
        out[..., 0] = out[..., 1] = out[..., 2] = px[..., 0]
    elif ctype == 2:
        out[..., :3] = px
    elif ctype == 3:
        out[..., :3] = plte[px[..., 0]]
        if trns is not None:
            pad = np.full(256, 255, np.uint8)
            pad[: len(trns)] = trns
            out[..., 3] = pad[px[..., 0]]
    elif ctype == 4:
        out[..., 0] = out[..., 1] = out[..., 2] = px[..., 0]
        out[..., 3] = px[..., 1]
    else:
        out[:] = px
    return out


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, {1,3,4}) uint8 (or floats in [0,1]) → PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.rint(np.asarray(img, np.float32) * 255), 0, 255
                      ).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nch = img.shape
    ctype = {1: 0, 3: 2, 4: 6}[nch]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(typ, payload):
        c = typ + payload
        return struct.pack(">I", len(payload)) + c \
            + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    return (_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6))
            + chunk(b"IEND", b""))


def save_png(path, img) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
