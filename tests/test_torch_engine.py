"""The port's engine shell (``clap_tpu_torch.engine.core``) against the JAX
package's Engine on the small testbed of tests/test_ui_core.py (seed 7,
side 32, nr_v 32, 2 dynamic bodies, 16 entities), both built from the
JAX package's scene through the bridge.

- 10 headless frames with the same seeded inputs: the state within 1e-4
  (ints exact); the profiler reports the same keys;
- ``parse_cli`` gives the same config for the same command lines;
- timers, the ``exit`` / ``restart`` bus commands (``os.execv``
  monkeypatched) and ``exit_after`` (a fake clock) behave as the JAX
  package's;
- the NaN watchdog resets a state poisoned in place to the initial state
  (which later in-place writes to the live state leave alone) and, with
  ``-E``, raises; the fuzzer drives frames;
- ``attach_editor`` / ``route_editor`` edit the live state as the JAX
  package's do."""
import dataclasses
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from clap_tpu.engine import core as J
from clap_tpu_torch.engine import core as T
from clap_tpu_torch.engine.step import Inputs
from test_torch_common import assert_tree_close, assert_tree_equal, to_port

SCENE = dict(seed=7, side=32.0, nr_v=32, n_dynamic=2, max_entities=16)


@pytest.fixture(scope="module")
def testbed():
    """The JAX package's testbed and its port copy (cfg, state0)."""
    from clap_tpu.scene.testbed import build_testbed

    jtb = build_testbed(**SCENE)
    return jtb, to_port(jtb.cfg), to_port(jtb.state0)


def port_engine(testbed, argv=(), **cfg):
    _, tcfg, tst = testbed
    return T.Engine(T.ClapConfig(title="t", settings=False, **cfg), tcfg, tst,
                    argv=argv, device="cpu")


@pytest.fixture(scope="module")
def engines(testbed):
    """Both Engines after 10 frames of the same seeded inputs: (JAX
    engine, port engine, [(JAX state, port state)] per frame)."""
    from clap_tpu.engine.step import inputs_zero

    jtb = testbed[0]
    jeng = J.Engine(J.ClapConfig(title="t", settings=False), jtb.cfg,
                    jtb.state0)
    teng = port_engine(testbed)
    rng = np.random.default_rng(0)
    out = []
    for _ in range(10):
        mot = rng.uniform(-1, 1, (1, 2)).astype(np.float32)
        jmp = rng.uniform(size=1) < 0.3
        cam = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        jeng.frame(inputs_zero(1)._replace(motion=mot, jump=jmp,
                                           cam_delta=cam))
        teng.frame(Inputs(motion=torch.as_tensor(mot),
                          jump=torch.as_tensor(jmp),
                          cam_delta=torch.as_tensor(cam),
                          dash=torch.zeros(1, dtype=torch.bool)))
        out.append((jax.tree.map(lambda x: np.asarray(x)[None], jeng.state),
                    teng.state))
    return jeng, teng, out


def _reset_flags(*engs):
    for e in engs:
        e._stop = e._restart = False
        e.timers.clear()


@pytest.mark.parametrize("frame", [0, 4, 9])
def test_engine_frames_match_jax(engines, frame):
    ref, got = engines[2][frame]
    assert_tree_close(ref, got, path=f"frame{frame}")
    assert int(got.frame[0]) == frame + 1


def test_engine_counts_and_profiler_keys_match_jax(engines):
    jeng, teng, _ = engines
    assert teng.frame_no == jeng.frame_no == 10
    assert set(teng.profiler.report()) == set(jeng.profiler.report())
    assert teng.profiler.report()["fps"] > 0
    assert teng.state.pos.shape[0] == 1               # the 1-env batch


@pytest.mark.parametrize("argv", [[], ["-e", "3"], ["-E", "--fuzzer"],
                                  ["-S", "10.0.0.2", "--exitafter", "7",
                                   "--unknown", "x"], ["-F", "--aoe"]])
def test_parse_cli_matches_jax(argv):
    def fields(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if not callable(v)}

    ref = J.parse_cli(argv, J.ClapConfig(title="t"))
    got = T.parse_cli(argv, T.ClapConfig(title="t"))
    assert fields(got) == fields(ref)


def _timer_trace(eng):
    fired = []
    eng.timer_set(0.0, lambda e: fired.append(("a", e.frame_no)))
    eng.timer_set(-1.0, lambda e: fired.append(("first", e.frame_no)))
    eng.timer_set(3600.0, lambda e: fired.append(("never", e.frame_no)))
    f0 = eng.frame_no
    eng.frame()
    eng.frame()
    return [(n, f - f0) for n, f in fired], len(eng.timers)


def test_timers_match_jax(engines):
    jeng, teng, _ = engines
    _reset_flags(jeng, teng)
    assert _timer_trace(teng) == _timer_trace(jeng) == \
        ([("first", 0), ("a", 0)], 1)
    _reset_flags(jeng, teng)


def _command_trace(eng, bus, monkeypatch, core):
    execs = []
    monkeypatch.setattr(core.os, "execv", lambda *a: execs.append(a))
    f0 = eng.frame_no
    eng.bus.send(bus.Message(bus.MT.COMMAND, data={"cmd": "exit"}))
    eng.run(max_frames=f0 + 100)
    stopped = eng.frame_no - f0
    _reset_flags(eng)
    eng.bus.send(bus.Message(bus.MT.COMMAND, data={"cmd": "restart"}))
    eng.run(max_frames=eng.frame_no + 100)
    restarted = eng.frame_no - f0 - stopped
    _reset_flags(eng)
    return stopped, restarted, len(execs), execs


def test_exit_and_restart_commands_match_jax(engines, monkeypatch):
    from clap_tpu.utils import bus as jbus
    from clap_tpu_torch.utils import bus as tbus

    jeng, teng, _ = engines
    ref = _command_trace(jeng, jbus, monkeypatch, J)
    got = _command_trace(teng, tbus, monkeypatch, T)
    assert got[:3] == ref[:3] == (0, 0, 1)      # no frame runs after either
    # the port re-executes the command line it was started with
    assert got[3][0] == (sys.executable,
                         [sys.executable] + sys.orig_argv[1:])


def test_net_command_reaches_the_bus(engines):
    jeng, teng, _ = engines
    for eng in (jeng, teng):
        eng._net_command({"command": "restart"})
        assert eng._restart
        _reset_flags(eng)


def test_exit_after_matches_jax(engines, monkeypatch):
    """-e 1: the run stops once a second has passed (a fake clock that
    moves 0.3 s per reading)."""
    jeng, teng, _ = engines
    counts = []
    for eng, core in ((jeng, J), (teng, T)):
        clock = iter(np.arange(1000) * 0.3)
        monkeypatch.setattr(core.time, "monotonic", lambda: next(clock))
        cfg = eng.cfg.exit_after
        eng.cfg.exit_after = 1
        f0 = eng.frame_no
        eng.run(max_frames=f0 + 50)
        counts.append(eng.frame_no - f0)
        eng.cfg.exit_after = cfg
        _reset_flags(eng)
    assert counts[0] == counts[1] and 0 < counts[1] < 50


def test_exit_after_from_the_command_line(testbed):
    eng = port_engine(testbed, argv=["-e", "1", "-E"])
    assert eng.cfg.exit_after == 1 and eng.cfg.abort_on_error


def test_watchdog_resets_a_state_poisoned_in_place(testbed):
    """A NaN written into the live body positions at frame 58 survives
    frame 59 and is reset at 60 to a copy of the initial state (the JAX
    package's state0, bit for bit); in-place writes to the live state
    after the reset leave the kept initial state alone, so a second reset
    is clean too. The reset is logged."""
    jst0 = jax.tree.map(lambda x: np.asarray(x)[None], testbed[0].state0)
    eng = port_engine(testbed)
    eng.frame_no = 58
    eng.state.phys.pos[0, 0, 1] = float("nan")       # in place, live
    eng.frame()                                       # frame 59: no check
    assert not bool(torch.isfinite(eng.state.phys.pos).all())
    eng.frame()                                       # frame 60: reset
    assert eng.frame_no == 60
    assert_tree_equal(jst0, eng.state)
    assert any("resetting" in e.msg for e in eng.log_ring.drain())
    eng.state.phys.pos[0, 0, 1] = float("nan")
    eng.state.pos.zero_()
    assert_tree_equal(jst0, eng._state0)
    eng.frame_no = 119
    eng.frame()
    assert_tree_equal(jst0, eng.state)


def test_watchdog_aborts_under_aoe(testbed):
    eng = port_engine(testbed, argv=["-E"])
    eng.frame_no = 59
    eng.state.phys.pos[0, 0, 1] = float("nan")
    with pytest.raises(FloatingPointError, match="leaf"):
        eng.frame()


def test_fuzzer_drives_frames(testbed):
    eng = port_engine(testbed, fuzzer=True)
    eng.run(max_frames=6)
    assert eng.frame_no == 6
    assert bool(torch.isfinite(eng.state.phys.pos).all())
    assert float((eng.state.phys.pos[0, 0] - eng._state0.phys.pos[0, 0]
                  ).abs().max()) > 1e-4                 # the body moved
    rep = eng.profiler.report()
    assert rep["fps"] > 0 and "sim_ms" in rep


def _level():
    from clap_tpu.scene.loader import load_scene as jload
    from clap_tpu_torch.scene.assets57 import asset_loader
    from clap_tpu_torch.scene.loader import load_scene as tload

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))
    import assets57

    doc = (Path(__file__).resolve().parents[1] / "demo"
           / "level57.json").read_text()
    kw = dict(max_entities=16, max_bodies=4)
    return (jload(doc, asset_loader=assets57.asset_loader, **kw),
            tload(doc, asset_loader=asset_loader, device="cpu", **kw))


def test_editor_through_engine_matches_jax(engines):
    """tests/test_editor.py's wiring on both Engines: F1 toggles the
    editor, the selected entity moves by one step in the live state, and
    the next frame steps the edited world."""
    from clap_tpu.engine.input import InputRecord as JRec
    from clap_tpu_torch.engine.input import InputRecord as TRec

    jeng, teng, _ = engines
    jscene, tscene = _level()
    out = []
    for eng, scene, Rec in ((jeng, jscene, JRec), (teng, tscene, TRec)):
        ed = eng.attach_editor(scene)
        assert eng.route_editor(Rec(edit_toggle=True))
        ed.sel = 3
        x0 = float(np.asarray(eng.state.pos).reshape(-1, 3)[3, 0])
        assert eng.route_editor(Rec(right=True))
        x1 = float(np.asarray(eng.state.pos).reshape(-1, 3)[3, 0])
        assert math.isclose(x1, x0 + ed.step, abs_tol=1e-6)
        f0 = eng.frame_no
        eng.frame()
        assert eng.frame_no == f0 + 1
        out.append((ed.status(), np.asarray(eng.state.pos).reshape(-1, 3)))
        eng.editor = None
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[1][1], out[0][1], atol=1e-4)


def test_restart_reexecs_the_module_command_line(testbed, monkeypatch):
    """``python -m clap_tpu_torch.demo.testbed`` restarts as
    ``python -m ...``, not as the module's file."""
    execs = []
    monkeypatch.setattr(T.os, "execv", lambda *a: execs.append(a))
    monkeypatch.setattr(T.sys, "orig_argv",
                        ["python3", "-m", "clap_tpu_torch.demo.testbed",
                         "--render"])
    port_engine(testbed).restart()
    assert execs == [(sys.executable, [sys.executable, "-m",
                                       "clap_tpu_torch.demo.testbed",
                                       "--render"])]
