"""Minimal RFC 6455 WebSocket framing + handshake (counterpart of
clap_tpu/utils/websocket.py; reference: core/networking.c:301-470 —
base64/SHA1 handshake, frame encode/decode for the browser-side
telemetry leg; stdlib only)."""
from __future__ import annotations

import base64
import hashlib
import os
import struct

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"   # RFC 6455 §1.3

OP_TEXT = 0x1
OP_BIN = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept from Sec-WebSocket-Key (networking.c:336)."""
    digest = hashlib.sha1((client_key + WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def parse_http_headers(data: bytes) -> dict:
    head = data.split(b"\r\n\r\n", 1)[0].decode("latin-1")
    out = {}
    for line in head.split("\r\n")[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            out[k.strip().lower()] = v.strip()
    return out


def handshake_response(request: bytes) -> bytes | None:
    """Server side: upgrade request → 101 response (None = not a WS
    upgrade)."""
    hdr = parse_http_headers(request)
    key = hdr.get("sec-websocket-key")
    if key is None or "websocket" not in hdr.get("upgrade", "").lower():
        return None
    return ("HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {accept_key(key)}\r\n\r\n"
            ).encode()


def handshake_request(host: str, port: int, path: str = "/") -> tuple:
    """Client side: returns (request bytes, expected accept key)."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (f"GET {path} HTTP/1.1\r\n"
           f"Host: {host}:{port}\r\n"
           "Upgrade: websocket\r\n"
           "Connection: Upgrade\r\n"
           f"Sec-WebSocket-Key: {key}\r\n"
           "Sec-WebSocket-Version: 13\r\n\r\n").encode()
    return req, accept_key(key)


def encode_frame(payload: bytes, opcode: int = OP_TEXT,
                 mask: bool = False) -> bytes:
    """One FIN frame (networking.c ws encode). Clients MUST mask."""
    out = bytearray([0x80 | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        out.append(mbit | n)
    elif n < 65536:
        out.append(mbit | 126)
        out += struct.pack(">H", n)
    else:
        out.append(mbit | 127)
        out += struct.pack(">Q", n)
    if mask:
        mk = os.urandom(4)
        out += mk
        out += bytes(b ^ mk[i % 4] for i, b in enumerate(payload))
    else:
        out += payload
    return bytes(out)


def decode_frames(buf: bytes) -> tuple[list, bytes]:
    """Decode complete frames → ([(opcode, payload)], remainder)."""
    msgs = []
    while True:
        if len(buf) < 2:
            return msgs, buf
        opcode = buf[0] & 0x0F
        masked = bool(buf[1] & 0x80)
        n = buf[1] & 0x7F
        off = 2
        if n == 126:
            if len(buf) < 4:
                return msgs, buf
            n = struct.unpack_from(">H", buf, 2)[0]
            off = 4
        elif n == 127:
            if len(buf) < 10:
                return msgs, buf
            n = struct.unpack_from(">Q", buf, 2)[0]
            off = 10
        need = off + (4 if masked else 0) + n
        if len(buf) < need:
            return msgs, buf
        if masked:
            mk = buf[off : off + 4]
            raw = bytes(b ^ mk[i % 4]
                        for i, b in enumerate(buf[off + 4 : need]))
        else:
            raw = bytes(buf[off:need])
        msgs.append((opcode, raw))
        buf = buf[need:]
