"""The host tools' twins on the port (tools/torch_server.py,
tools/torch_packer.py) against the JAX package's tools (tools/server.py,
tools/packer.py): each twin loads neither JAX nor the JAX package; a pack
made by one packer is listed and extracted by the other with the same
bytes; a client of each package logs to the other package's server over
loopback (ephemeral ports) and gets its restart broadcast."""
import importlib
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import test_torch_common  # noqa: F401  (one torch thread per worker)

REPO = Path(__file__).resolve().parents[1]
PACKERS = {"clap_tpu": "tools/packer.py",
           "clap_tpu_torch": "tools/torch_packer.py"}
SERVERS = {"clap_tpu": "tools/server.py",
           "clap_tpu_torch": "tools/torch_server.py"}
PAIRS = [("clap_tpu", "clap_tpu_torch"), ("clap_tpu_torch", "clap_tpu")]


@pytest.mark.parametrize("script", ["tools/torch_server.py",
                                    "tools/torch_packer.py"])
def test_twin_loads_no_jax(script):
    """The twin's module level (its imports) in a fresh process, with no
    JAX and no JAX package in it afterwards."""
    code = ("import runpy, sys; runpy.run_path(%r, run_name='twin'); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'clap_tpu')]; assert not bad, bad; "
            "assert 'clap_tpu_torch' in sys.modules" % script)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _run(script, *args, cwd):
    r = subprocess.run([sys.executable, str(REPO / script), *map(str, args)],
                       cwd=cwd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.parametrize("maker,reader", PAIRS)
def test_pack_made_by_one_packer_read_by_the_other(tmp_path, maker, reader):
    (tmp_path / "assets").mkdir()
    files = {"assets/a.txt": b"hello pack\n",
             "assets/b.bin": bytes(range(256)) * 7,
             "assets/empty": b""}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    out = _run(PACKERS[maker], "create", "out.pak", *files, cwd=tmp_path)
    assert out.strip() == f"packed {len(files)} files -> out.pak"
    listing = _run(PACKERS[reader], "list", "out.pak", cwd=tmp_path)
    assert listing == _run(PACKERS[maker], "list", "out.pak", cwd=tmp_path)
    assert sorted(line.split()[-1] for line in listing.splitlines()) \
        == sorted(files)
    out = _run(PACKERS[reader], "extract", "out.pak", "x", cwd=tmp_path)
    assert out.strip() == "extracted to x"
    for name, data in files.items():
        assert (tmp_path / "x" / name).read_bytes() == data


def _wait(cond, timeout=10.0, poll=None):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if poll is not None:
            poll()
        if cond():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("server,client", PAIRS)
def test_client_logs_to_the_other_packages_server(server, client):
    """The server tool of one package on an ephemeral port, a client of
    the other package: its log and status lines are printed as the
    server prints them, and 'restart' on the server's stdin reaches the
    client."""
    C = importlib.import_module(f"{client}.utils.telemetry")
    proc = subprocess.Popen(
        [sys.executable, "-u", str(REPO / SERVERS[server]), "--port", "0"],
        cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: [lines.append(x.rstrip("\n")) for x in proc.stdout],
        daemon=True)
    reader.start()
    try:
        assert _wait(lambda: bool(lines), timeout=120), proc.stderr.read()
        head = lines[0]
        assert head.startswith("clap-tpu telemetry server on :")
        port = int(head.split(":")[1].split()[0])
        cli = C.TelemetryClient(port=port)
        assert cli.connected
        cli.log("info", "hello from the other package")
        cli.status(fps=60, frame=7)
        assert _wait(lambda: len(lines) >= 3)
        assert lines[1] == "[info ] hello from the other package"
        assert lines[2] == "status: {'fps': 60, 'frame': 7}"
        cmds = []
        cli.on_command = cmds.append
        proc.stdin.write("restart\n")
        proc.stdin.flush()
        assert _wait(lambda: bool(cmds), poll=cli.poll)
        assert cmds[0]["command"] == "restart"
        assert _wait(lambda: "broadcast restart" in lines)
        cli.close()
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.stdout.close()
            proc.stderr.close()
