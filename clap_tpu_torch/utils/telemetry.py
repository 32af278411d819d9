"""Telemetry networking (counterpart of clap_tpu/utils/telemetry.py;
reference: core/networking.c, 1074 LoC).

The reference's only distributed component is a poll()-based TCP (21044)
+ WebSocket (21045) layer forwarding logs to a collector and accepting
remote-restart commands (SURVEY §2.10/§5.8) — dev tooling, not
simulation traffic. This re-provides that role with a line-delimited
JSON protocol over TCP:

- ``TelemetryClient``: non-blocking log/status forwarding from the
  engine host loop (the logger ring-buffer sink analogue,
  networking.c:98) + restart-command callback.
- ``TelemetryServer``: collector used by tools/server.py
  (tools/server/server.c) with broadcast_restart.

Simulation state never crosses this socket; cross-chip scale-out rides
XLA collectives (parallel/sharding.py).
"""
from __future__ import annotations

import json
import socket
import threading
import time

DEFAULT_PORT = 21044     # networking.c default (TCP)
DEFAULT_WS_PORT = 21045  # networking.c WebSocket leg (RFC 6455)


class TelemetryClient:
    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 on_command=None, connect_timeout: float = 0.5):
        self.addr = (host, port)
        self.sock = None
        self.on_command = on_command
        self._rx = b""
        try:
            self.sock = socket.create_connection(self.addr, connect_timeout)
            self.sock.setblocking(False)
        except OSError:
            self.sock = None  # degrade silently like the reference client

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def send(self, mtype: str, **payload) -> None:
        if not self.sock:
            return
        try:
            line = json.dumps({"type": mtype, "ts": time.time(), **payload})
            self.sock.sendall(line.encode() + b"\n")
        except OSError:
            self.close()

    def log(self, level: str, msg: str) -> None:
        self.send("log", level=level, msg=msg)

    def status(self, **fields) -> None:
        """1 Hz status broadcast analogue (clap.c:224-258 FPS message)."""
        self.send("status", **fields)

    def poll(self) -> None:
        """networking_poll: drain commands (e.g. restart)."""
        if not self.sock:
            return
        try:
            data = self.sock.recv(65536)
            if not data:
                self.close()
                return
            self._rx += data
        except BlockingIOError:
            return
        except OSError:
            self.close()
            return
        while b"\n" in self._rx:
            line, self._rx = self._rx.split(b"\n", 1)
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            if msg.get("type") == "command" and self.on_command:
                self.on_command(msg)

    def close(self) -> None:
        if self.sock:
            try:
                self.sock.close()
            finally:
                self.sock = None


class WsTelemetryClient:
    """WebSocket flavor of the telemetry client (the reference's
    browser-side leg, networking.c:301-470): same JSON payloads carried
    in RFC 6455 text frames (client frames masked, as required)."""

    def __init__(self, host: str = "127.0.0.1",
                 port: int = DEFAULT_WS_PORT, on_command=None,
                 connect_timeout: float = 0.5):
        from . import websocket as ws

        self.on_command = on_command
        self.sock = None
        self._rx = b""
        try:
            self.sock = socket.create_connection((host, port),
                                                 connect_timeout)
            req, expect = ws.handshake_request(host, port)
            self.sock.sendall(req)
            self.sock.settimeout(connect_timeout)
            resp = b""
            while b"\r\n\r\n" not in resp:
                chunk = self.sock.recv(4096)
                if not chunk:
                    raise OSError("handshake EOF")
                resp += chunk
            hdr = ws.parse_http_headers(resp)
            if hdr.get("sec-websocket-accept") != expect:
                raise OSError("bad Sec-WebSocket-Accept")
            self.sock.setblocking(False)
        except OSError:
            self.close()

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def send(self, mtype: str, **payload) -> None:
        from . import websocket as ws

        if not self.sock:
            return
        try:
            line = json.dumps({"type": mtype, "ts": time.time(), **payload})
            self.sock.sendall(ws.encode_frame(line.encode(), mask=True))
        except OSError:
            self.close()

    def log(self, level: str, msg: str) -> None:
        self.send("log", level=level, msg=msg)

    def status(self, **fields) -> None:
        self.send("status", **fields)

    def poll(self) -> None:
        from . import websocket as ws

        if not self.sock:
            return
        try:
            data = self.sock.recv(65536)
            if not data:
                self.close()
                return
            self._rx += data
        except BlockingIOError:
            return
        except OSError:
            self.close()
            return
        msgs, self._rx = ws.decode_frames(self._rx)
        for opcode, raw in msgs:
            if opcode != ws.OP_TEXT:
                continue
            try:
                msg = json.loads(raw)
            except json.JSONDecodeError:
                continue
            if msg.get("type") == "command" and self.on_command:
                self.on_command(msg)

    def close(self) -> None:
        if self.sock:
            try:
                self.sock.close()
            finally:
                self.sock = None


class TelemetryServer:
    """Log collector + restart broadcaster (tools/server/server.c),
    listening on BOTH legs like the reference: line-JSON TCP (21044)
    and WebSocket (21045, RFC 6455 handshake + frames)."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 on_message=None, ws_port: int | None = 0):
        self.on_message = on_message or (lambda m, a: None)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen(16)
        self.port = self.listener.getsockname()[1]
        self.ws_listener = None
        self.ws_port = None
        if ws_port is not None:
            self.ws_listener = socket.socket(socket.AF_INET,
                                             socket.SOCK_STREAM)
            self.ws_listener.setsockopt(socket.SOL_SOCKET,
                                        socket.SO_REUSEADDR, 1)
            self.ws_listener.bind((host, ws_port))
            self.ws_listener.listen(16)
            self.ws_port = self.ws_listener.getsockname()[1]
        self.clients: list[socket.socket] = []
        self.ws_clients: list[socket.socket] = []   # handshake complete
        self._ws_pending: dict = {}                 # sock → request buf
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        import select

        from . import websocket as ws

        buffers = {}
        while not self._stop.is_set():
            socks = [self.listener] + self.clients + self.ws_clients \
                + list(self._ws_pending)
            if self.ws_listener is not None:
                socks.append(self.ws_listener)
            ready, _, _ = select.select(socks, [], [], 0.2)
            for s in ready:
                if s is self.listener:
                    conn, _addr = self.listener.accept()
                    conn.setblocking(False)
                    self.clients.append(conn)
                    buffers[conn] = b""
                    continue
                if s is self.ws_listener:
                    conn, _addr = self.ws_listener.accept()
                    conn.setblocking(False)
                    self._ws_pending[conn] = b""
                    continue
                try:
                    data = s.recv(65536)
                except OSError:
                    data = b""
                if not data:
                    self._drop(s, buffers)
                    continue
                if s in self._ws_pending:
                    self._ws_pending[s] += data
                    if b"\r\n\r\n" in self._ws_pending[s]:
                        resp = ws.handshake_response(self._ws_pending[s])
                        if resp is None:
                            self._drop(s, buffers)
                            continue
                        try:
                            s.sendall(resp)
                        except OSError:
                            self._drop(s, buffers)
                            continue
                        del self._ws_pending[s]
                        self.ws_clients.append(s)
                        buffers[s] = b""
                    continue
                buffers[s] = buffers.get(s, b"") + data
                if s in self.ws_clients:
                    msgs, buffers[s] = ws.decode_frames(buffers[s])
                    for opcode, raw in msgs:
                        if opcode == ws.OP_CLOSE:
                            self._drop(s, buffers)
                            break
                        if opcode != ws.OP_TEXT:
                            continue
                        try:
                            self.on_message(json.loads(raw), s)
                        except json.JSONDecodeError:
                            pass
                else:
                    while b"\n" in buffers[s]:
                        line, buffers[s] = buffers[s].split(b"\n", 1)
                        try:
                            self.on_message(json.loads(line), s)
                        except json.JSONDecodeError:
                            pass

    def _drop(self, s, buffers):
        for lst in (self.clients, self.ws_clients):
            if s in lst:
                lst.remove(s)
        self._ws_pending.pop(s, None)
        buffers.pop(s, None)
        try:
            s.close()
        except OSError:
            pass

    def broadcast_restart(self) -> None:
        """networking_broadcast_restart (networking.c:552) — both legs."""
        from . import websocket as ws

        payload = json.dumps({"type": "command", "command": "restart"}
                             ).encode()
        for c in list(self.clients):
            try:
                c.sendall(payload + b"\n")
            except OSError:
                pass
        frame = ws.encode_frame(payload)
        for c in list(self.ws_clients):
            try:
                c.sendall(frame)
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1)
        for c in self.clients + self.ws_clients + list(self._ws_pending):
            try:
                c.close()
            except OSError:
                pass
        self.listener.close()
        if self.ws_listener is not None:
            self.ws_listener.close()
