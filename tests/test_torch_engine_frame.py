"""The graphics Engine of the port.

- The Engine with graphics attached as demo/testbed.py attaches them
  (``clap_tpu_torch.demo.testbed.build_world`` over
  tests/test_torch_game_frame.py's SCENE, 256 × 128) gives, frame by
  frame, the session and the image of ``game_frame_step`` from the same
  state, inputs and generator seed, bit for bit. No JAX here: the JAX
  parity of that frame is tests/test_torch_game_frame_demo.py's.
- A NaN state goes through the frame's step and render, and the
  watchdog resets it.
- ``lut_autoswitch_set`` cycles grading volumes with the renderer built
  once: each frame is the renderer's image under the volume of the
  moment.

The sound Engine against the JAX package's is in
tests/test_torch_engine_sound.py."""
import numpy as np
import pytest
import torch

from clap_tpu_torch.bridge import tree_leaves, tree_map
from clap_tpu_torch.demo.testbed import build_world
from clap_tpu_torch.engine import core as T
from clap_tpu_torch.engine.frame import game_frame_step
from clap_tpu_torch.engine.step import inputs_zero
from clap_tpu_torch.scene.testbed import replicate_state
from test_torch_game_frame import SCENE

W, H = 256, 128


def graphics_engine(seed=11, out_dir=None, lighting_lut=False):
    """The demo's world on the CPU and an Engine with its graphics
    (``lighting_lut``: the grading LUT on)."""
    import dataclasses

    w = build_world("cpu", width=W, height=H, scene=SCENE)
    eng = T.Engine(T.ClapConfig(title="testbed", settings=False, width=W,
                                height=H),
                   w["tb"].cfg, w["tb"].state0, game_world=w["gw"],
                   session0=w["session0"], device="cpu", seed=seed)
    g = dict(w["graphics"])
    g["opts"] = dataclasses.replace(g["opts"], lighting_lut=lighting_lut)
    eng.attach_graphics(**g, out_dir=out_dir)
    return w, eng


@pytest.fixture(scope="module")
def engine_frames():
    """3 frames of the graphics Engine and of game_frame_step (a renderer
    made apart, the same seed) from the same session and inputs."""
    w, eng = graphics_engine()
    renderer = T.graphics_renderer(w["tb"].state0.mx, **w["graphics"])
    gs = replicate_state(w["session0"], 1)
    gen = torch.Generator().manual_seed(11)
    ins = inputs_zero(2, device="cpu")
    ins.motion[0, 0] = 1.0
    ins.motion[1] = torch.tensor([0.3, -0.6])
    out = []
    for _ in range(3):
        eng.frame(ins)
        gs, img = game_frame_step(w["gw"], renderer, gs,
                                  tree_map(lambda x: x[None], ins),
                                  generator=gen)
        out.append((eng.session, eng.last_frame, gs, img))
    return eng, out


@pytest.mark.parametrize("frame", range(3))
def test_graphics_engine_equals_game_frame_step(engine_frames, frame):
    sess, last, gs, img = engine_frames[1][frame]
    assert last.shape == (H, W, 3) and torch.equal(last, img[0])
    a, b = tree_leaves(sess), tree_leaves(gs)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(last.std()) > 0.01 and bool(torch.isfinite(last).all())


def test_graphics_engine_wiring(engine_frames):
    """attach_graphics turns the camera occlusion on, renders the
    particles, and keeps the initial session apart from the live one."""
    eng = engine_frames[0]
    assert eng.cfg.graphics and eng._camera_occlusion is True
    assert eng._render_particles and eng.renderer.particle_active is not None
    assert int(eng.renderer.particle_active.sum()) == 512
    assert eng.renderer.static_shadow is not None          # baked once
    assert not torch.equal(eng.session.engine.pos, eng._session0.engine.pos)
    assert eng.frame_no == 3


def test_watchdog_resets_a_nan_that_reaches_the_render():
    """A NaN written into the live body positions before frame 59 goes
    through that frame's step and render (game_frame_step's, and the
    Engine's) without an out-of-range index; the frame is not finite; the
    watchdog at 60 resets the session to the initial one, and frame 60
    renders a finite frame again."""
    w, eng = graphics_engine()
    gs = replicate_state(w["session0"], 1)
    gs.engine.phys.pos[0, 0, 1] = float("nan")
    renderer = T.graphics_renderer(w["tb"].state0.mx, **w["graphics"])
    gs, img = game_frame_step(w["gw"], renderer, gs,
                              tree_map(lambda x: x[None], eng._zero_inputs),
                              generator=torch.Generator().manual_seed(1))
    assert not bool(torch.isfinite(gs.engine.phys.pos).all())
    assert not bool(torch.isfinite(img).all())
    eng.frame_no = 59
    eng.state.phys.pos[0, 0, 1] = float("nan")         # live, in place
    eng.frame()
    assert eng.frame_no == 60
    assert not bool(torch.isfinite(eng.last_frame).all())
    a, b = tree_leaves(eng.session), tree_leaves(eng._session0)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    eng.frame()
    assert bool(torch.isfinite(eng.last_frame).all())
    assert float(eng.last_frame.std()) > 0.01


def test_frame_dump_writes_the_last_frame(tmp_path):
    """out_dir: frame N's PNG decodes to last_frame (8-bit)."""
    from clap_tpu_torch.utils.png import decode_png

    w, eng = graphics_engine(out_dir=str(tmp_path / "frames"))
    eng.run(max_frames=2)
    png = decode_png((tmp_path / "frames" / "frame_0001.png").read_bytes())
    want = np.clip(np.rint(eng.last_frame.numpy() * 255), 0, 255)
    assert png.shape[:2] == (H, W)
    assert np.array_equal(png[..., :3], want.astype(np.uint8))


def test_lut_autoswitch_cycles_without_rebuilding(monkeypatch):
    """Three volumes, a period of one (fake) second: the timer swaps the
    Engine's volume each second and re-arms; the renderer object and its
    buffers stay the same; each frame is the renderer's image under the
    volume of the moment (lighting_lut on); a period of 0 cancels."""
    from clap_tpu_torch.render.lut import LUT_PRESETS, bake_lut

    now = [0.0]
    monkeypatch.setattr(T.time, "monotonic", lambda: now[0])
    w, eng = graphics_engine(lighting_lut=True)
    renderer = eng.renderer
    buffers = {k: v.data_ptr() for k, v in renderer.named_buffers()}
    vols = [bake_lut(p, 8, device="cpu") for p in LUT_PRESETS[:3]]
    eng.lut_autoswitch_set(1.0, vols)
    assert eng._lut_volume is vols[0]
    seen = []
    for step in range(5):
        now[0] = step + 0.5
        eng.frame()
        seen.append(eng._lut_volume)
        st = eng.session
        want = renderer(st.engine, st.particles, eng._lut_volume,
                        st.joint_mats)[0]
        assert torch.equal(eng.last_frame, want)
    assert [next(i for i, v in enumerate(vols) if v is s) for s in seen] \
        == [0, 1, 2, 0, 1]
    assert eng.renderer is renderer
    assert {k: v.data_ptr() for k, v in renderer.named_buffers()} == buffers
    eng.lut_autoswitch_set(0)
    now[0] = 10.0
    eng.frame()
    assert eng._lut_volume is seen[-1] and not eng.timers
    # the default list bakes every preset on the Engine's device
    eng.lut_autoswitch_set(5.0)
    assert len(eng._lut_cycle) == len(LUT_PRESETS)
    assert eng._lut_cycle[0].device.type == "cpu"
