"""Browser display: live frame streaming + input return channel
(counterpart of clap_tpu/render/display.py; reference:
core/display-www.c drives clap_frame in the browser and core/input-www.c
feeds browser key events back as message_input; here the engine runs
host-side and the browser is a thin canvas client).

``DisplayServer`` is a tiny single-thread HTTP + WebSocket server:

- ``GET /``   → an embedded HTML page (canvas + WS client) that draws
  streamed PNG frames and reports keydown/keyup/pointer events.
- ``GET /ws`` → RFC 6455 upgrade (utils/websocket framing, the same
  code path as the telemetry WS leg, networking.c:301-470 parity).
- ``push_frame(img)`` broadcasts one binary PNG frame to every client
  (slow clients are dropped rather than back-pressuring the engine —
  the swapchain-over-network analogue of display_swap_buffers). A frame
  on the card is read back once, and only when a client will get it.
- browser events arrive as JSON text frames and fold into an
  ``InputRecord`` (engine/input.py), so a browser client is
  interchangeable with the keyboard/fuzzer/replay input sources.

This is deliberately NOT a GLFW window: the engine renders on a card,
usually a remote one — a socket is the only realistic display link.
"""
from __future__ import annotations

import json
import socket
import threading
import time

import numpy as np
import torch

from ..engine.input import InputRecord, apply_key
from ..utils import websocket as ws
from ..utils.png import encode_png

INDEX_HTML = b"""<!doctype html>
<html><head><title>clap-tpu</title><style>
 body { margin:0; background:#111; color:#ddd; font:12px monospace; }
 #hud { position:fixed; top:4px; left:6px; }
 canvas { display:block; margin:0 auto; image-rendering:pixelated; }
</style></head><body>
<div id="hud">clap-tpu &mdash; WASD move, arrows camera, space jump,
tab switch</div>
<canvas id="c"></canvas>
<script>
const c = document.getElementById('c'), ctx = c.getContext('2d');
const sock = new WebSocket(`ws://${location.host}/ws`);
sock.binaryType = 'blob';
let frames = 0;
sock.onmessage = (ev) => {
  if (typeof ev.data === 'string') return;
  createImageBitmap(ev.data).then((bm) => {
    if (c.width !== bm.width) { c.width = bm.width; c.height = bm.height; }
    ctx.drawImageSmoothingEnabled = false;
    ctx.drawImage(bm, 0, 0);
    frames++;
  });
};
const keymap = { 'w':'w','a':'a','s':'s','d':'d',' ':'space',
  'Tab':'tab','Enter':'enter','Escape':'escape','ArrowUp':'up',
  'ArrowDown':'down','ArrowLeft':'left','ArrowRight':'right',
  'Shift':'shift' };
function send(o) { if (sock.readyState === 1) sock.send(JSON.stringify(o)); }
window.addEventListener('keydown', (e) => {
  const k = keymap[e.key]; if (!k || e.repeat) return;
  e.preventDefault(); send({t:'key', key:k, down:true});
});
window.addEventListener('keyup', (e) => {
  const k = keymap[e.key]; if (!k) return;
  e.preventDefault(); send({t:'key', key:k, down:false});
});
c.addEventListener('pointermove', (e) => {
  const r = c.getBoundingClientRect();
  send({t:'ptr', x:(e.clientX-r.left)/r.width,
        y:(e.clientY-r.top)/r.height, click:e.buttons>0});
});
c.addEventListener('pointerdown', (e) => send({t:'ptr_click', down:true}));
c.addEventListener('pointerup', (e) => send({t:'ptr_click', down:false}));
</script></body></html>
"""


class DisplayServer:
    """Serve the display page and stream frames; collect input events."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_fps: float = 60.0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.host, self.port = self._srv.getsockname()
        self._clients: list[socket.socket] = []   # upgraded WS clients
        self._bufs: dict[socket.socket, bytes] = {}
        self._lock = threading.Lock()
        self.record = InputRecord()
        self._events: list[dict] = []
        self._min_dt = 1.0 / max_fps if max_fps > 0 else 0.0
        self._last_push = 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # --- server loop (accept + HTTP + WS upgrade + input frames) ------
    def _run(self):
        import select

        pending: dict[socket.socket, bytes] = {}   # pre-upgrade reads
        while not self._stop.is_set():
            with self._lock:
                socks = [self._srv] + list(pending) + list(self._clients)
            try:
                ready, _, _ = select.select(socks, [], [], 0.1)
            except OSError:
                continue
            for s in ready:
                if s is self._srv:
                    try:
                        conn, _ = self._srv.accept()
                        conn.setblocking(True)
                        pending[conn] = b""
                    except OSError:
                        pass
                    continue
                try:
                    data = s.recv(65536)
                except OSError:
                    data = b""
                if not data:
                    self._drop(s, pending)
                    continue
                if s in pending:
                    pending[s] += data
                    if b"\r\n\r\n" not in pending[s]:
                        continue
                    req = pending.pop(s)
                    resp = ws.handshake_response(req)
                    if resp is not None:            # WS upgrade
                        try:
                            s.sendall(resp)
                        except OSError:
                            self._drop(s, pending)
                            continue
                        with self._lock:
                            self._clients.append(s)
                            self._bufs[s] = b""
                    else:                           # plain HTTP GET
                        body = INDEX_HTML
                        try:
                            s.sendall(
                                b"HTTP/1.1 200 OK\r\n"
                                b"Content-Type: text/html\r\n"
                                b"Content-Length: "
                                + str(len(body)).encode() + b"\r\n\r\n"
                                + body)
                        except OSError:
                            pass
                        s.close()
                else:                               # WS input frames
                    with self._lock:
                        self._bufs[s] = self._bufs.get(s, b"") + data
                        msgs, rest = ws.decode_frames(self._bufs[s])
                        self._bufs[s] = rest
                    for op, payload in msgs:
                        if op == ws.OP_CLOSE:
                            self._drop(s, pending)
                            break
                        if op == ws.OP_PING:
                            try:
                                s.sendall(ws.encode_frame(payload,
                                                          ws.OP_PONG))
                            except OSError:
                                pass
                        elif op == ws.OP_TEXT:
                            self._handle_event(payload)

    def _handle_event(self, payload: bytes):
        try:
            ev = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        with self._lock:
            self._events.append(ev)
            if ev.get("t") == "key":
                apply_key(self.record, ev.get("key", ""),
                          bool(ev.get("down")))
            elif ev.get("t") == "ptr":
                self.record.mouse_x = float(ev.get("x", 0.0))
                self.record.mouse_y = float(ev.get("y", 0.0))
                self.record.mouse_click = bool(ev.get("click"))
            elif ev.get("t") == "ptr_click":
                self.record.mouse_click = bool(ev.get("down"))

    def _drop(self, s, pending=None):
        with self._lock:
            if s in self._clients:
                self._clients.remove(s)
            self._bufs.pop(s, None)
        if pending is not None:
            pending.pop(s, None)
        try:
            s.close()
        except OSError:
            pass

    # --- engine-facing API --------------------------------------------
    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def push_frame(self, img) -> bool:
        """Broadcast one frame (f32 [0,1] or uint8 (H, W, 3), a tensor on
        any device or an array). Returns False when throttled (max_fps)
        or no client is connected; only then is the frame not read."""
        now = time.monotonic()
        if now - self._last_push < self._min_dt:
            return False
        with self._lock:
            clients = list(self._clients)
        if not clients:
            return False
        self._last_push = now
        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()          # the one read back
        frame = ws.encode_frame(encode_png(np.asarray(img)), ws.OP_BIN)
        for s in clients:
            try:
                s.sendall(frame)
            except OSError:
                self._drop(s)
        return True

    def poll_events(self) -> list[dict]:
        """Drain raw browser events (key/ptr dicts)."""
        with self._lock:
            ev, self._events = self._events, []
        return ev

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        with self._lock:
            for s in self._clients:
                try:
                    s.close()
                except OSError:
                    pass
            self._clients.clear()
        try:
            self._srv.close()
        except OSError:
            pass
