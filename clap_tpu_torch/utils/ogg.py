"""Ogg/Vorbis codec via ctypes bindings to the system libvorbis
(counterpart of clap_tpu/utils/ogg.py;
reference: core/sound.c decodes ogg through miniaudio's stb_vorbis;
here the native route is the real libvorbisfile/libvorbisenc, bound
directly — no Python decoder).

decode_ogg / decode_ogg_bytes → (float32 (N, C), rate)
encode_ogg(data, rate, quality) → ogg bytes (VBR)

The encoder follows the canonical libvorbis encoding sequence
(vorbis_analysis_buffer → blockout → bitrate_flushpacket →
ogg_stream_pageout). Opaque library structs are allocated as oversized
byte buffers; only ogg_packet/ogg_page need real layouts.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import tempfile

import numpy as np

__all__ = ["available", "decode_ogg", "decode_ogg_bytes", "encode_ogg"]


def _load(*names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_ogg = _load("libogg.so.0", "libogg.so")
_vorbis = _load("libvorbis.so.0", "libvorbis.so")
_vorbisfile = _load("libvorbisfile.so.3", "libvorbisfile.so")
_vorbisenc = _load("libvorbisenc.so.2", "libvorbisenc.so")


def available() -> bool:
    return all(x is not None for x in (_ogg, _vorbis, _vorbisfile,
                                       _vorbisenc))


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", ctypes.POINTER(ctypes.c_ubyte)),
                ("bytes", ctypes.c_long),
                ("b_o_s", ctypes.c_long),
                ("e_o_s", ctypes.c_long),
                ("granulepos", ctypes.c_int64),
                ("packetno", ctypes.c_int64)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", ctypes.POINTER(ctypes.c_ubyte)),
                ("header_len", ctypes.c_long),
                ("body", ctypes.POINTER(ctypes.c_ubyte)),
                ("body_len", ctypes.c_long)]


class _VorbisInfo(ctypes.Structure):
    # real layout (vorbis/codec.h) — needed to read channels/rate
    _fields_ = [("version", ctypes.c_int),
                ("channels", ctypes.c_int),
                ("rate", ctypes.c_long),
                ("bitrate_upper", ctypes.c_long),
                ("bitrate_nominal", ctypes.c_long),
                ("bitrate_lower", ctypes.c_long),
                ("bitrate_window", ctypes.c_long),
                ("codec_setup", ctypes.c_void_p)]


_OPAQUE = 16384  # oversized allocation for opaque library structs


def _buf():
    return ctypes.create_string_buffer(_OPAQUE)


# ---------------------------------------------------------------------------
# decode (libvorbisfile)
# ---------------------------------------------------------------------------

def decode_ogg(path: str) -> tuple[np.ndarray, int]:
    """Decode an .ogg file → (float32 samples (N, C) in [-1, 1], rate)."""
    if not available():
        raise RuntimeError("libvorbis not available")
    vf = _buf()                                  # OggVorbis_File (opaque)
    _vorbisfile.ov_fopen.restype = ctypes.c_int
    rc = _vorbisfile.ov_fopen(path.encode(), vf)
    if rc != 0:
        raise ValueError(f"ov_fopen failed ({rc})")
    try:
        _vorbisfile.ov_info.restype = ctypes.POINTER(_VorbisInfo)
        vi = _vorbisfile.ov_info(vf, -1).contents
        channels, rate = vi.channels, int(vi.rate)

        chunks = []
        buf = ctypes.create_string_buffer(65536)
        bitstream = ctypes.c_int(0)
        _vorbisfile.ov_read.restype = ctypes.c_long
        while True:
            n = _vorbisfile.ov_read(vf, buf, len(buf), 0, 2, 1,
                                    ctypes.byref(bitstream))
            if n <= 0:
                break
            chunks.append(bytes(buf.raw[:n]))
    finally:
        _vorbisfile.ov_clear(vf)
    pcm = np.frombuffer(b"".join(chunks), np.int16)
    pcm = pcm.reshape(-1, channels).astype(np.float32) / 32768.0
    return pcm, rate


def decode_ogg_bytes(data: bytes) -> tuple[np.ndarray, int]:
    with tempfile.NamedTemporaryFile(suffix=".ogg", delete=False) as f:
        f.write(data)
        tmp = f.name
    try:
        return decode_ogg(tmp)
    finally:
        os.unlink(tmp)


# ---------------------------------------------------------------------------
# encode (libvorbisenc) — canonical encoder_example.c sequence
# ---------------------------------------------------------------------------

def encode_ogg(data: np.ndarray, rate: int = 44100,
               quality: float = 0.4) -> bytes:
    """float32 (N,) or (N, C) in [-1, 1] → ogg/vorbis bytes (VBR)."""
    if not available():
        raise RuntimeError("libvorbis not available")
    data = np.asarray(data, np.float32)
    if data.ndim == 1:
        data = data[:, None]
    n_total, channels = data.shape

    vi = _buf()
    _vorbis.vorbis_info_init(vi)
    rc = _vorbisenc.vorbis_encode_init_vbr(
        vi, ctypes.c_long(channels), ctypes.c_long(rate),
        ctypes.c_float(quality))
    if rc != 0:
        raise ValueError(f"vorbis_encode_init_vbr failed ({rc})")
    vc = _buf()
    _vorbis.vorbis_comment_init(vc)
    vd = _buf()
    _vorbis.vorbis_analysis_init(vd, vi)
    vb = _buf()
    _vorbis.vorbis_block_init(vd, vb)
    osx = _buf()
    _ogg.ogg_stream_init(osx, 0x5EED)

    out = bytearray()
    page = _OggPage()
    pkt = _OggPacket()

    def drain(flush: bool):
        fn = _ogg.ogg_stream_flush if flush else _ogg.ogg_stream_pageout
        while fn(osx, ctypes.byref(page)) != 0:
            out.extend(ctypes.string_at(page.header, page.header_len))
            out.extend(ctypes.string_at(page.body, page.body_len))

    try:
        # 3 header packets, flushed onto their own pages
        hmain, hcomm, hcode = _OggPacket(), _OggPacket(), _OggPacket()
        _vorbis.vorbis_analysis_headerout(
            vd, vc, ctypes.byref(hmain), ctypes.byref(hcomm),
            ctypes.byref(hcode))
        for h in (hmain, hcomm, hcode):
            _ogg.ogg_stream_packetin(osx, ctypes.byref(h))
        drain(True)

        _vorbis.vorbis_analysis_buffer.restype = \
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float))

        CHUNK = 4096
        pos = 0
        while pos <= n_total:
            n = min(CHUNK, n_total - pos)
            if n > 0:
                bufpp = _vorbis.vorbis_analysis_buffer(vd, CHUNK)
                for c in range(channels):
                    ctypes.memmove(
                        bufpp[c],
                        data[pos : pos + n, c].tobytes(), n * 4)
            _vorbis.vorbis_analysis_wrote(vd, n)
            pos += CHUNK
            while _vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                _vorbis.vorbis_analysis(vb, None)
                _vorbis.vorbis_bitrate_addblock(vb)
                while _vorbis.vorbis_bitrate_flushpacket(
                        vd, ctypes.byref(pkt)) == 1:
                    _ogg.ogg_stream_packetin(osx, ctypes.byref(pkt))
                    drain(False)
            if n == 0:
                break
        drain(True)
    finally:
        _ogg.ogg_stream_clear(osx)
        _vorbis.vorbis_block_clear(vb)
        _vorbis.vorbis_dsp_clear(vd)
        _vorbis.vorbis_comment_clear(vc)
        _vorbis.vorbis_info_clear(vi)
    return bytes(out)
