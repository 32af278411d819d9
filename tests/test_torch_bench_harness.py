"""The port's bench harness (clap_tpu_torch/bench.py) against bench.py's,
on stub configs: each stub is a child process (a small script written
here) that the harness runs as it runs ``bench_torch.py --config KEY``.
bench.py is read as source (``ast``), never imported: the keys, their
order and the line's fields must be its own. Runs in seconds."""
import ast
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from clap_tpu_torch import bench as port

REPO = Path(__file__).resolve().parents[1]
BENCH_PY = ast.parse((REPO / "bench.py").read_text())

# a child per key: it sleeps, then prints its marked line (or nothing)
STUB = r'''
import json, os, sys, time
key, pids = sys.argv[1], sys.argv[2]
with open(os.path.join(pids, key), "w") as f:
    f.write(str(os.getpid()))
print("a line of the child's own")
if key == "headless":
    out = {"result": {"env_steps_per_s": 100.0},
           "headline": {"value": 100.0, "vs_baseline": 0.0004,
                        "n_envs": 4096, "sub": {"headless_single_ms": 1.5}}}
elif key in ("slow", "hang"):
    time.sleep(120)
elif key == "fail":
    sys.exit(1)
elif key.startswith("step_and_render"):
    row = "64tex" if key.endswith("textured") else "64"
    out = {"result": {row: {"metric": f"step_and_render_{row}_ms",
                            "value": 2.0}}}
else:
    out = {"result": {"metric": key, "value": 1.0}}
print("BENCHCFG " + json.dumps(dict(out, headline=out.get("headline"))))
'''


def _function(name):
    return next(n for n in BENCH_PY.body
                if isinstance(n, ast.FunctionDef) and n.name == name)


def bench_py_keys():
    """bench.py's ``_configs`` keys: (every backend's, the TPU branch's)."""
    fn = _function("_configs")

    def keys(lst):
        return [e.elts[0].value for e in lst.elts]

    base = next(keys(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and n.targets[0].id == "configs")
    tpu = next(keys(n.value) for n in ast.walk(fn)
               if isinstance(n, ast.AugAssign))
    return base, tpu


def bench_py_line_keys():
    """The top-level keys of bench.py's line on a finished run: its
    ``_RESULTS`` literal and every key it assigns, but the signal's."""
    lit = next(n.value for n in BENCH_PY.body if isinstance(n, ast.Assign)
               and n.targets[0].id == "_RESULTS")
    keys = {k.value for k in lit.keys}
    keys |= {n.slice.value for n in ast.walk(BENCH_PY)
             if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
             and isinstance(n.value, ast.Name) and n.value.id == "_RESULTS"
             and isinstance(n.slice, ast.Constant)}
    return keys - {"killed_by_signal"}


@pytest.fixture
def stub(tmp_path):
    """(command(key), pid directory) of the stub child."""
    script = tmp_path / "stub.py"
    script.write_text(STUB)
    pids = tmp_path / "pids"
    pids.mkdir()
    return (lambda key: [sys.executable, str(script), key, str(pids)]), pids


def _gone(pid):
    """The process has ended (reaped, or a zombie left to init)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except FileNotFoundError:
        return True
    return state.split()[0] in ("Z", "X")


def test_config_keys_and_order_are_bench_py_s():
    base, tpu = bench_py_keys()
    assert len(base) + len(tpu) == 12
    assert [k for k, _, _ in port._configs("gpu")] == base + tpu
    assert [k for k, _, _ in port._configs("cpu")] == base
    assert all(est > 0 for _, est, _ in port._configs("gpu"))


def test_public_functions_are_bench_py_s():
    names = {n.name for n in BENCH_PY.body if isinstance(n, ast.FunctionDef)}
    for name in ("bench_ca2d", "bench_skinning", "bench_headless",
                 "bench_full_frame", "bench_full_frame_production",
                 "bench_batched_render", "bench_step_and_render",
                 "bench_shading_rate", "kernel_parity_check",
                 "run_headless", "run_shading_rate", "_configs",
                 "child_main", "main"):
        assert name in names and callable(getattr(port, name)), name


def test_harness_line_budget_timeout_and_merge(stub, tmp_path, capsys):
    """The headline runs though its estimate exceeds the budget; a slow
    child is cut at twice its estimate (``config-timeout``) and its
    process is gone; an estimate over what is left is ``skipped: budget``
    with ``est_s`` and ``remaining_s``; the step_and_render rows merge; a
    child without a result is an error row; the line is printed after
    every config that ran and mirrored."""
    command, pids = stub
    mirror = tmp_path / "mirror.json"
    h = port.Harness("cpu", 30.0, mirror=mirror)
    configs = [("headless", 1e6, None), ("slow", 0.5, None),
               ("step_and_render", 1, None), ("big", 1e6, None),
               ("step_and_render_textured", 1, None), ("fail", 1, None),
               ("ca2d", 1, None)]
    h.run(configs, command)
    h.finish()
    out = capsys.readouterr().out.splitlines()
    lines = [json.loads(ln) for ln in out if ln.startswith("{")]
    last = lines[-1]
    assert len(lines) == 7          # six configs ran, then the final line
    assert "[headless] a line of the child's own" in out
    assert set(last) == bench_py_line_keys() | {"device"}
    assert last["final"] is True and last["backend"] == "cpu"
    assert last["budget_s"] == 30.0
    assert (last["value"], last["vs_baseline"], last["n_envs"]) \
        == (100.0, 0.0004, 4096)
    sub = last["sub"]
    assert sub["headless_single_ms"] == 1.5
    assert sub["headless"]["env_steps_per_s"] == 100.0
    assert sub["slow"]["skipped"] == "config-timeout"
    assert sub["slow"]["deadline_s"] == 1.0 and sub["slow"]["took_s"] < 60
    assert _gone(int((pids / "slow").read_text()))
    big = sub["big"]
    assert big["skipped"] == "budget" and big["est_s"] == 1e6
    assert 0 < big["remaining_s"] < 30.0 and not (pids / "big").exists()
    sr = sub["step_and_render"]
    assert set(sr) == {"64", "64tex", "took_s"}
    assert "step_and_render_textured" not in sub
    assert "error" in sub["fail"]
    assert sub["ca2d"]["value"] == 1.0 and "took_s" in sub["ca2d"]
    assert json.loads(mirror.read_text()) == last


def test_sigterm_leaves_a_parseable_last_line(stub, tmp_path):
    """SIGTERM mid-config: the running child is stopped and the last line
    parses, with ``killed_by_signal`` and the configs done so far."""
    command, pids = stub
    code = ("import sys\nfrom clap_tpu_torch import bench as port\n"
            f"h = port.Harness('cpu', 600.0, mirror={str(tmp_path / 'm')!r})\n"
            "h.install()\n"
            f"cmd = {command('KEY')!r}\n"
            "h.run([('headless', 10, None), ('hang', 100, None)],\n"
            "      lambda k: [k if a == 'KEY' else a for a in cmd])\n"
            "h.finish()\n")
    p = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                         stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while not (pids / "hang").exists() and time.monotonic() - t0 < 60:
            time.sleep(0.05)
        time.sleep(0.3)
        p.send_signal(signal.SIGTERM)
        out, _ = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
    last = json.loads(out.strip().splitlines()[-1])
    assert p.returncode == 1
    assert last["killed_by_signal"] == signal.SIGTERM
    assert last["final"] is False and last["value"] == 100.0
    assert "headless" in last["sub"] and "hang" not in last["sub"]
    assert _gone(int((pids / "hang").read_text()))


def test_mirror_is_not_the_jax_bench_s_file():
    assert port.MIRROR.name != "BENCH_PARTIAL.json"
    assert port.MIRROR.parent == REPO / "bench_out"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "bench_out/" in ignored


def test_no_card_and_no_cpu_flag_exits_nonzero_naming_the_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert "CUDA card" in last["error"] and last["final"] is False
    assert last["sub"] == {} and last["backend"] == "gpu"
    assert "CUDA card" in r.stderr


def test_child_runs_one_config_on_the_cpu():
    """``bench_torch.py --config kernel_parity --device cpu``: one marked
    line, the wrappers' plain versions (no kernel launch counted)."""
    r = subprocess.run([sys.executable, "bench_torch.py", "--config",
                        "kernel_parity", "--device", "cpu"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    marked = [ln for ln in r.stdout.splitlines() if ln.startswith("BENCHCFG ")]
    assert len(marked) == 1
    out = json.loads(marked[0][len("BENCHCFG "):])
    assert out["result"] is True and out["headline"] is None
    assert out["launches"] == {"raster_tile": 0, "raster_depth": 0,
                               "ca2d_run_fused": 0}
