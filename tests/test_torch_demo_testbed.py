"""``python -m clap_tpu_torch.demo.testbed`` (the port's demo/testbed.py)
on the CPU at a cut size (the terrain at 12² verts on a 16-unit side,
frames of 64 × 32): headless, with ``--fuzzer``, with ``--render
--fuzzer --dump`` and the batched soak ``--envs``; the lines it prints
are demo/testbed.py:198-208's."""
import re

import numpy as np
import pytest
import torch

from clap_tpu_torch.demo import testbed as demo
import test_torch_common  # noqa: F401  (one torch thread per worker)

CUT = dict(scene=dict(nr_v=12, side=16.0, max_entities=32),
           frame_size=(64, 32))


@pytest.mark.parametrize("flags", [[], ["--fuzzer"], ["-e", "60"]])
def test_headless(capsys, flags):
    eng = demo.main(["--device", "cpu", "--frames", "3", *flags], **CUT)
    out = capsys.readouterr().out
    assert eng.frame_no == 3 and eng.session is None
    assert eng.cfg.fuzzer == ("--fuzzer" in flags)
    assert re.search(r"^frames: 3 profiler \(host dispatch\): \{'fps'", out,
                     re.M)
    assert "character at" in out and "last frame" not in out
    assert bool(torch.isfinite(eng.state.phys.pos).all())


def test_render_fuzzer_dump(capsys, tmp_path):
    from clap_tpu_torch.utils.png import decode_png

    eng = demo.main(["--device", "cpu", "--render", "--fuzzer", "--frames",
                     "3", "--dump", str(tmp_path)], **CUT)
    out = capsys.readouterr().out
    assert eng.frame_no == 3 and eng.cfg.graphics and eng.cfg.fuzzer
    assert eng.last_frame.shape == (32, 64, 3)
    assert bool(torch.isfinite(eng.last_frame).all())
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"frame_{i:04d}.png" for i in range(3)]
    png = decode_png((tmp_path / "frame_0002.png").read_bytes())
    want = np.clip(np.rint(eng.last_frame.numpy() * 255), 0, 255)
    assert np.array_equal(png[..., :3], want.astype(np.uint8))
    assert "last frame: (32, 64, 3) mean" in out
    assert "rigs animating: 2 poses differ from bind: True" in out
    # both characters took the fuzzer's stream (the JAX Engine's single
    # draw reaches every character)
    moved = (eng.state.phys.pos[0, 1:3] - eng._session0.engine.phys.pos[
        0, 1:3]).norm(dim=-1)
    assert bool((moved > 1e-4).all())


def test_batched_soak(capsys):
    sts, rate = demo.main(["--device", "cpu", "--envs", "4", "--frames",
                           "3"], **CUT)
    out = capsys.readouterr().out
    assert re.search(r"^4 envs x 3 frames: \d+ env-steps/s", out, re.M)
    assert rate > 0 and sts.pos.shape[0] == 4
    assert bool((sts.frame == 3).all())
    # each env took its own stream
    assert float(sts.phys.pos[:, 0, 0].std()) > 0


def test_build_world_wiring():
    """The demo's world: 2 characters, 2 × 256 live particles, 3 texture
    layers, one sun; headless, 1 character."""
    w = demo.build_world("cpu", width=64, height=32, scene=CUT["scene"])
    assert w["tb"].cfg.char_params.body.shape[0] == 2
    assert int(w["graphics"]["particle_world"].count.sum()) == 512
    assert w["textures"].diffuse.shape == (3, 32, 32, 3)
    assert int(w["lights"].active.sum()) == 1
    assert w["session0"].engine.pos.dim() == 2            # unbatched
    assert (w["opts"].width, w["opts"].height, w["opts"].shadow_size) == (
        64, 32, 256)
    assert w["gw"].sfx is None and w["session0"].sfx_events is None
    h = demo.build_world("cpu", render=False, scene=CUT["scene"])
    assert set(h) == {"tb"} and h["tb"].cfg.char_params.body.shape[0] == 1


def test_footsteps_reach_the_sound_engine():
    """build_world(footsteps=True) wires the motion clip's footstep table
    (demo/platformer.py's), and an Engine with sound plays them while both
    characters walk."""
    from clap_tpu_torch.engine.core import ClapConfig, Engine
    from clap_tpu_torch.engine.step import inputs_zero

    w = demo.build_world("cpu", scene=CUT["scene"], footsteps=True)
    assert w["gw"].sfx is not None
    assert w["session0"].sfx_events.shape == (2, 2)
    eng = Engine(ClapConfig(settings=False), w["tb"].cfg, w["tb"].state0,
                 game_world=w["gw"], session0=w["session0"], device="cpu")
    eng.attach_sound()
    walk = inputs_zero(2, device="cpu")
    walk.motion[:, 0] = 1.0
    for _ in range(60):
        eng.frame(walk)
    assert {c for _f, _foot, c in eng.voice_log} == {0, 1}
    assert sum(len(b) for b in eng.audio_buffer) == 60 * 735
