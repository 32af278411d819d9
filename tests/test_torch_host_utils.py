"""The port's host rim against the JAX package's: each ``clap_tpu_torch.
utils`` module (and the display server) beside its ``clap_tpu``
counterpart, on the same seeded numpy inputs.

Bars: bytes (WebSocket frames, PNG frames, packs, settings files) equal;
audio equal to the last bit (both packages run the same numpy code);
behaviour (bus dispatch counts, log rings, input records) equal. The
network tests talk over loopback sockets with ephemeral ports, each
package's client against the other package's server."""
import importlib
import json
import socket
import time

import numpy as np
import pytest
import torch

import test_torch_common  # noqa: F401  (one torch thread per worker)

PKGS = ("clap_tpu", "clap_tpu_torch")
# (server package, client package): each client against each server
PAIRS = [(a, b) for a in PKGS for b in PKGS]


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _wait(pred, timeout=5.0, poll=None):
    end = time.time() + timeout
    while not pred() and time.time() < end:
        if poll is not None:
            poll()
        time.sleep(0.02)
    return pred()


# ---------------------------------------------------------------------------
# bus, logger, profiler
# ---------------------------------------------------------------------------

def _bus_trace(pkg):
    B = mod(pkg, "utils.bus")
    bus = B.MessageBus()
    got = []

    def consume(m):
        got.append(("c", dict(m.data)))
        return 0

    def decline(m):
        got.append(("d", dict(m.data)))
        return -1

    bus.subscribe(B.MT.COMMAND, consume)
    bus.subscribe(B.MT.COMMAND, decline)
    bus.subscribe(B.MT.LOG, consume)
    n = [bus.send(B.Message(B.MT.COMMAND, data={"cmd": "restart"})),
         bus.send(B.Message(B.MT.LOG, data={"msg": "x"})),
         bus.send(B.Message(B.MT.INPUT))]
    bus.unsubscribe(B.MT.COMMAND, consume)
    n.append(bus.send(B.Message(B.MT.COMMAND, data={"cmd": "exit"})))
    return n, got, [int(t) for t in B.MT]


def test_bus_matches_jax():
    assert _bus_trace("clap_tpu_torch") == _bus_trace("clap_tpu")


def _logger_trace(pkg):
    L = mod(pkg, "utils.logger")
    log = L.Logger(level=L.NORMAL, stdio=False)
    ring = L.RingSink(capacity=3, level=L.NORMAL)
    log.add_sink(ring)
    log.dbg("below level")
    log.msg("one")
    log.warn("two", mod="m")
    log.err("three")
    log.msg("four")
    got = [(e.level, e.msg) for e in ring.drain()]
    abort = L.Logger(abort_on_error=True, stdio=False)
    abort.warn("fine")
    with pytest.raises(RuntimeError):
        abort.err("boom")
    return got, ring.drain(), (L.DBG, L.NORMAL, L.WARN, L.ERR)


def test_logger_matches_jax():
    assert _logger_trace("clap_tpu_torch") == _logger_trace("clap_tpu")


@pytest.mark.parametrize("pkg", PKGS)
def test_profiler_report_keys(pkg):
    P = mod(pkg, "utils.profiler").Profiler()
    for _ in range(3):
        P.frame_begin()
        P.step("move")
        time.sleep(0.001)
        P.step("phys")
        P.frame_end()
    r = P.report()
    assert set(r) == {"fps", "move_ms", "phys_ms"} and r["fps"] > 0
    assert r["phys_ms"] >= 0.5


def test_profiler_trace_writes_chrome_trace(tmp_path):
    from clap_tpu_torch.utils.profiler import trace

    with trace(str(tmp_path)):
        torch.ones(8).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert doc["traceEvents"]


# ---------------------------------------------------------------------------
# settings and the librarian (one state directory for both packages)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_settings_written_by_one_read_by_the_other(tmp_path, monkeypatch,
                                                   writer, reader):
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path))
    w = mod(writer, "utils.settings")
    r = mod(reader, "utils.settings")
    assert w.state_dir() == r.state_dir() == tmp_path / "clap_tpu"
    s = w.Settings("t.json")
    s.set("window.width", 1280)
    s.set("sound.volume", 0.5)
    s2 = r.Settings("t.json")
    assert s2.get("window.width") == 1280
    assert s2.get("sound.volume") == 0.5
    assert s2.get("missing.key", 42) == 42
    assert s2.doc == s.doc


def test_librarian_packs_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "st"))
    rng = np.random.default_rng(11)
    files = {f"asset/f{i}.bin": rng.bytes(int(n))
             for i, n in enumerate(rng.integers(1, 4000, 6))}
    files["config/keys.json"] = b"{}"
    base = tmp_path / "game"
    (base / "asset").mkdir(parents=True)
    (base / "asset" / "f0.bin").write_bytes(b"disk")
    (base / "asset" / "disk_only").write_bytes(b"on disk")
    out = {}
    for pkg in PKGS:
        L = mod(pkg, "utils.librarian")
        pak = tmp_path / f"{pkg}.pak"
        L.make_pack(pak, files)
        lib = L.Librarian(base=base)
        n = lib.add_pack(pak)
        got = []
        h = lib.lib_request(L.RES.ASSET, "missing",
                            lambda hh: got.append(hh.state))
        out[pkg] = (pak.read_bytes(), n,
                    [lib.fetch(L.RES.ASSET, f"f{i}.bin") for i in range(6)],
                    lib.fetch(L.RES.ASSET, "disk_only"),
                    lib.fetch(L.RES.CONFIG, "keys.json"),
                    str(lib.resolve(L.RES.STATE, "s.json")), got, h.data)
    assert out["clap_tpu_torch"] == out["clap_tpu"]
    assert out["clap_tpu"][2][0] == files["asset/f0.bin"]   # pack wins


# ---------------------------------------------------------------------------
# WebSocket framing and telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 5, 125, 126, 500, 70000])
@pytest.mark.parametrize("op", ["OP_TEXT", "OP_BIN", "OP_PING"])
def test_websocket_frames_byte_equal(n, op):
    J, T = mod("clap_tpu", "utils.websocket"), mod("clap_tpu_torch",
                                                   "utils.websocket")
    payload = np.random.default_rng(n).bytes(n)
    a = J.encode_frame(payload, getattr(J, op))
    b = T.encode_frame(payload, getattr(T, op))
    assert a == b
    # masked frames (random masks) decode the same in either package
    masked = T.encode_frame(payload, getattr(T, op), mask=True)
    assert J.decode_frames(masked) == T.decode_frames(masked)
    assert T.decode_frames(masked + a[:2]) == J.decode_frames(masked + a[:2])


def test_websocket_handshake_equal():
    J, T = mod("clap_tpu", "utils.websocket"), mod("clap_tpu_torch",
                                                   "utils.websocket")
    req, expect = J.handshake_request("h", 1, "/ws")
    assert J.handshake_response(req) == T.handshake_response(req)
    resp = T.handshake_response(req)
    assert T.parse_http_headers(resp)["sec-websocket-accept"] == expect
    assert T.handshake_response(b"GET / HTTP/1.1\r\n\r\n") is None


@pytest.mark.parametrize("server,client", PAIRS)
def test_telemetry_client_against_server(server, client):
    """A log and a status line reach the collector; the restart broadcast
    reaches the client (TCP leg)."""
    S, C = mod(server, "utils.telemetry"), mod(client, "utils.telemetry")
    received = []
    srv = S.TelemetryServer(port=0, on_message=lambda m, a: received.append(m))
    try:
        cli = C.TelemetryClient(port=srv.port)
        assert cli.connected
        cli.log("info", "hello")
        cli.status(fps=60, frame=7)
        assert _wait(lambda: len(received) >= 2)
        assert received[0]["type"] == "log" and received[0]["msg"] == "hello"
        assert received[1]["type"] == "status" and received[1]["frame"] == 7
        cmds = []
        cli.on_command = cmds.append
        srv.broadcast_restart()
        assert _wait(lambda: bool(cmds), poll=cli.poll)
        assert cmds[0]["command"] == "restart"
        cli.close()
    finally:
        srv.close()


@pytest.mark.parametrize("server,client", PAIRS)
def test_ws_telemetry_client_against_server(server, client):
    """The browser leg (WebSocket): the same JSON payloads."""
    S, C = mod(server, "utils.telemetry"), mod(client, "utils.telemetry")
    received = []
    srv = S.TelemetryServer(port=0, ws_port=0,
                            on_message=lambda m, a: received.append(m))
    try:
        cli = C.WsTelemetryClient(port=srv.ws_port)
        assert cli.connected
        cli.log("msg", "hello over ws")
        assert _wait(lambda: bool(received))
        assert received[0]["msg"] == "hello over ws"
        cmds = []
        cli.on_command = cmds.append
        assert _wait(lambda: bool(srv.ws_clients))
        srv.broadcast_restart()
        assert _wait(lambda: bool(cmds), poll=cli.poll)
        assert cmds[0]["command"] == "restart"
        cli.close()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# sound
# ---------------------------------------------------------------------------

def _mix_trace(pkg):
    S = mod(pkg, "utils.sound")
    rng = np.random.default_rng(5)
    eng = S.SoundEngine(rate=8000)
    a = eng.add_sound(rng.uniform(-0.5, 0.5, 900).astype(np.float32))
    b = eng.add_sound(S.synth_tone(220.0, 0.05, rate=8000))
    c = eng.add_sound(rng.uniform(-0.2, 0.2, 300).astype(np.float32))
    eng.set_effect_chain(b, [S.DelayEffect(delay_ms=20.0, feedback=0.4,
                                           wet_dry=0.5, rate=8000)])
    eng.set_effect_chain(c, [S.ReverbEffect("small_room", room_size=0.3,
                                            damping=0.3, wet_dry=0.6)])
    eng.play(a, gain=0.7)
    eng.play(b, loop=True)
    out = [eng.mix(256)]
    eng.play(c, gain=0.5)
    out += [eng.mix(n) for n in (100, 700, 333)]
    return np.concatenate(out), [v.playing for v in eng.voices]


def test_sound_mix_matches_jax():
    ref, rp = _mix_trace("clap_tpu")
    got, gp = _mix_trace("clap_tpu_torch")
    assert rp == gp
    assert np.array_equal(ref, got) and np.abs(got).max() > 0.05


def test_lowpass_fft_matches_jax():
    rng = np.random.default_rng(3)
    sig = rng.standard_normal(4410).astype(np.float32)
    ref = mod("clap_tpu", "utils.sound").lowpass_fft(sig, 1000)
    got = mod("clap_tpu_torch", "utils.sound").lowpass_fft(sig, 1000)
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("chain", ["delay", "delay_stereo", "reverb",
                                   "reverb_delay"])
def test_effect_chains_match_jax(chain):
    rng = np.random.default_rng(9)
    stereo = chain == "delay_stereo"
    x = rng.uniform(-1, 1, (3000, 2) if stereo else 3000).astype(np.float32)

    def run(pkg):
        S = mod(pkg, "utils.sound")
        fx = {"delay": [S.DelayEffect(delay_ms=37.0, feedback=0.6,
                                      wet_dry=0.4, rate=8000)],
              "delay_stereo": [S.DelayEffect(delay_ms=[25.0, 60.0],
                                             feedback=0.3, wet_dry=0.7,
                                             rate=8000, channels=2)],
              "reverb": [S.ReverbEffect("small_room", room_size=0.5,
                                        damping=0.4, wet_dry=0.5)],
              "reverb_delay": [S.ReverbEffect("small_room", room_size=0.2,
                                              wet_dry=0.3),
                               S.DelayEffect(delay_ms=10.0, feedback=0.2,
                                             wet_dry=0.5, rate=8000)]}[chain]
        outs = []
        for blk in (slice(0, 1000), slice(1000, 3000)):   # streamed
            yb = x[blk]
            for f in fx:
                yb = f.process(yb)
            outs.append(yb)
        return np.concatenate(outs)

    assert np.array_equal(run("clap_tpu"), run("clap_tpu_torch"))


@pytest.mark.parametrize("writer,reader", [PKGS, PKGS[::-1]])
def test_wav_written_by_one_read_by_the_other(tmp_path, writer, reader):
    tone = mod(writer, "utils.sound").synth_tone(440, 0.05)
    p = tmp_path / "t.wav"
    mod(writer, "utils.sound").save_wav(p, tone)
    back = mod(reader, "utils.sound").load_wav(p)
    assert np.array_equal(back, mod(writer, "utils.sound").load_wav(p))
    assert np.abs(back - tone).max() < 1e-3


needs_ogg = pytest.mark.skipif(
    not mod("clap_tpu_torch", "utils.ogg").available(),
    reason="libvorbis not present")


@needs_ogg
@pytest.mark.parametrize("encoder,decoder", [PKGS, PKGS[::-1]])
def test_ogg_round_trip_across_packages(encoder, decoder):
    t = np.linspace(0, 0.5, 22050, endpoint=False)
    stereo = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                       0.3 * np.sin(2 * np.pi * 660 * t)], -1
                      ).astype(np.float32)
    data = mod(encoder, "utils.ogg").encode_ogg(stereo, 44100, quality=0.4)
    assert data[:4] == b"OggS"
    pcm, rate = mod(decoder, "utils.ogg").decode_ogg_bytes(data)
    ref, rref = mod(encoder, "utils.ogg").decode_ogg_bytes(data)
    assert rate == rref == 44100 and np.array_equal(pcm, ref)
    for ch, f_expect in ((0, 440.0), (1, 660.0)):
        spec = np.abs(np.fft.rfft(pcm[:, ch]))
        assert abs(spec.argmax() * rate / len(pcm) - f_expect) < 5.0


def test_ogg_availability_agrees():
    assert mod("clap_tpu_torch", "utils.ogg").available() == \
        mod("clap_tpu", "utils.ogg").available()


# ---------------------------------------------------------------------------
# the display server
# ---------------------------------------------------------------------------

def _recv_until(sock, pred, timeout=5.0):
    buf = b""
    sock.settimeout(timeout)
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            data = sock.recv(65536)
        except socket.timeout:
            break
        if not data:
            break
        buf += data
        if pred(buf):
            break
    return buf


EVENTS = [{"t": "key", "key": "w", "down": True},
          {"t": "key", "key": "space", "down": True},
          {"t": "key", "key": "left", "down": True},
          {"t": "key", "key": "space", "down": False},
          {"t": "ptr", "x": 0.25, "y": 0.75, "click": True},
          {"t": "ptr_click", "down": False},
          {"t": "key", "key": "shift", "down": True}]


def _display_session(pkg, frame):
    """One WS client: the PNG frame bytes it receives and the input record
    the server folds its events into."""
    D = mod(pkg, "render.display")
    ws = mod(pkg, "utils.websocket")
    d = D.DisplayServer(port=0, max_fps=0)
    try:
        s = socket.create_connection((d.host, d.port), timeout=5)
        req, accept = ws.handshake_request(d.host, d.port, "/ws")
        s.sendall(req)
        assert accept.encode() in _recv_until(s, lambda b: b"\r\n\r\n" in b)
        assert _wait(lambda: d.n_clients == 1)
        assert d.push_frame(frame)
        raw = _recv_until(s, lambda b: len(ws.decode_frames(b)[0]) > 0)
        msgs, _ = ws.decode_frames(raw)
        for ev in EVENTS:
            s.sendall(ws.encode_frame(json.dumps(ev).encode(), ws.OP_TEXT,
                                      mask=True))
        evs = []
        assert _wait(lambda: len(evs) >= len(EVENTS),
                     poll=lambda: evs.extend(d.poll_events()))
        s.close()
        return msgs, evs, vars(d.record)
    finally:
        d.close()


@pytest.mark.parametrize("kind", ["float", "uint8", "tensor"])
def test_display_png_bytes_and_input_records_match_jax(kind):
    from clap_tpu.utils.png import decode_png

    img = np.random.default_rng(4).uniform(size=(24, 40, 3)).astype(
        np.float32)
    if kind == "uint8":
        img = (img * 255).astype(np.uint8)
    ref = _display_session("clap_tpu", img)
    got = _display_session("clap_tpu_torch",
                           torch.as_tensor(img) if kind == "tensor" else img)
    assert got[0] == ref[0] and ref[0][0][0] == 2          # one OP_BIN
    assert decode_png(got[0][0][1]).shape == (24, 40, 4)
    assert got[1] == ref[1] == EVENTS
    assert got[2] == ref[2]
    assert got[2]["up"] and got[2]["yaw_left"] and not got[2]["space"]


def test_display_reads_nothing_without_a_client():
    """push_frame with no client connected returns False before touching
    the frame (a tensor that cannot be read back is never read)."""
    from clap_tpu_torch.render.display import DisplayServer

    class Unreadable(torch.Tensor):
        def cpu(self):
            raise AssertionError("read back with no client")

    d = DisplayServer(port=0, max_fps=0)
    try:
        assert not d.push_frame(torch.zeros(4, 4, 3).as_subclass(Unreadable))
    finally:
        d.close()
