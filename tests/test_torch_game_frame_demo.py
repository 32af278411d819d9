"""2 frames of the game's own rendered frame, the port against the JAX
package: demo/testbed.py:62-200's scene (the terrain cut to 32² verts,
tests/test_torch_game_frame.py's SCENE) through ``game_frame_step``
(``game_step`` with the camera occlusion, then ``GameFrameRenderer``:
particles, film grain, textures, skinned characters, the static bake) at
256 × 128, against the JAX package's ``Engine.frame`` with
``attach_graphics``'s render closure. The reference cannot raster the
demo's own 640 × 360 (its sub-column grid fails there, ROADMAP §3).

Bars: the session state within 1e-4 (the particles' draws are the JAX
package's), LDR PSNR >= 35 dB (texture layers 1 and 2 alike,
``parity_textures``); particles and grain change pixels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clap_tpu_torch.engine.frame import game_frame_step
from clap_tpu_torch.ops import particles as Tp
from test_torch_common import assert_tree_close, jnp_tree, psnr, to_port
from test_torch_game_frame import H, W, jax_demo_engine, port_demo, t


@pytest.fixture(scope="module")
def game_frames():
    from clap_tpu.engine.step import inputs_zero
    from clap_tpu_torch.bridge import tree_map
    from test_torch_game import jax_particle_draws, port_session

    eng, _ = jax_demo_engine(W, H)
    w = port_demo(W, H)
    tgw = to_port(eng._game_world)._replace(scene=w["tb"].cfg)
    tgs = port_session(eng.session, 1)
    ins = inputs_zero(2)._replace(
        motion=jnp.zeros((2, 2)).at[0, 0].set(1.0).at[1].set(
            jnp.array([0.3, -0.6])))
    tins = tree_map(lambda x: x[None], to_port(ins))
    renderer = w["renderer"]
    out = []
    with pytest.MonkeyPatch.context() as mp:
        for _ in range(2):
            d = [t(x)[None] for x in jax_particle_draws(
                eng.session.particles.key, 2)]
            mp.setattr(Tp, "particle_draws", lambda *a, **k: d)
            eng.frame(ins)
            tgs, img = game_frame_step(tgw, renderer, tgs, tins)
            out.append((jnp_tree(eng.session), np.asarray(eng.last_frame),
                        tgs, img.numpy()))
    no_parts = renderer(tgs.engine, None, None, tgs.joint_mats).numpy()
    grain = renderer.grain_noise
    renderer.grain_noise = None
    no_grain = renderer(tgs.engine, tgs.particles, None,
                        tgs.joint_mats).numpy()
    renderer.grain_noise = grain
    return out, no_parts, no_grain


@pytest.mark.parametrize("frame", range(2))
def test_game_frame_state(game_frames, frame):
    jss, _, tss, _ = game_frames[0][frame]
    jss = jax.tree.map(lambda x: np.asarray(x)[None], jss)   # the env axis
    for part in ("engine", "game", "anim", "joint_mats"):
        assert_tree_close(getattr(jss, part), getattr(tss, part),
                          path=f"frame{frame}.{part}")
    assert_tree_close((jss.particles.pos, jss.particles.vel),
                      (tss.particles.pos, tss.particles.vel),
                      path=f"frame{frame}.particles")


@pytest.mark.parametrize("frame", range(2))
def test_game_frame_image(game_frames, frame):
    _, jimg, _, timg = game_frames[0][frame]
    assert timg.shape == (1, H, W, 3) and np.isfinite(timg).all()
    assert float(timg.std()) > 0.01
    assert psnr(jimg, timg[0]) >= 35.0


def test_particles_and_grain_change_pixels(game_frames):
    frames, no_parts, no_grain = game_frames
    img = frames[-1][3]
    assert (np.abs(img - no_parts).max(-1) > 0.02).sum() > 20
    assert (np.abs(img - no_grain).max(-1) > 1e-3).mean() > 0.3
