"""The port's sound Engine against the JAX package's: ``attach_sound``'s
voice log and audio buffer over tests/test_anim_sfx.py's 150 walking
frames (tests/test_game_step.py's world with the footstep table: the
footsteps of the character's motion clip). Bars: the voice log exact (the
same frames, feet and characters) and the audio bit for bit (both
packages mix with the same numpy code)."""
import numpy as np
import torch

from clap_tpu_torch.engine import core as T
from clap_tpu_torch.engine.step import inputs_zero
from test_torch_common import to_port


def _sfx_worlds():
    """tests/test_anim_sfx.py's world: the JAX package's (GameWorld,
    session) with the footstep table, and the port's copies."""
    import jax.numpy as jnp

    from clap_tpu.anim.system import anim_instances_init, anim_sfx_from_names
    from clap_tpu_torch.engine.game import GameSessionState
    from clap_tpu_torch.ops.particles import ParticleState
    from test_game_step import build_gameworld

    gw, gs = build_gameworld()
    n_chars = gw.scene.char_params.body.shape[0]
    sfx = anim_sfx_from_names(["idle", "motion", "jump", "fall"],
                              motion_segments=4)
    gw = gw._replace(sfx=sfx)
    gs = gs._replace(anim=anim_instances_init(n_chars, with_sfx=True),
                     sfx_events=jnp.zeros((n_chars, 2), bool))
    def t(x):
        return torch.as_tensor(np.array(x))

    tgs = GameSessionState(
        engine=to_port(gs.engine), game=to_port(gs.game),
        anim=to_port(gs.anim),
        particles=ParticleState(pos=t(gs.particles.pos),
                                vel=t(gs.particles.vel)),
        joint_mats=t(gs.joint_mats), sfx_events=t(gs.sfx_events))
    return (gw, gs), (to_port(gw), tgs)


def test_sound_voices_and_audio_match_jax():
    import jax.numpy as jnp

    from clap_tpu.engine.core import ClapConfig, Engine
    from clap_tpu.engine.step import inputs_zero as jinputs_zero

    (jgw, jgs), (tgw, tgs) = _sfx_worlds()
    n_chars = jgw.scene.char_params.body.shape[0]
    jeng = Engine(ClapConfig(title="t", settings=False), jgw.scene,
                  jgs.engine, game_world=jgw, session0=jgs)
    teng = T.Engine(T.ClapConfig(title="t", settings=False), tgw.scene,
                    tgs.engine, game_world=tgw, session0=tgs, device="cpu")
    jeng.attach_sound()
    teng.attach_sound()
    jwalk = jinputs_zero(n_chars)._replace(
        motion=jnp.zeros((n_chars, 2), jnp.float32).at[0, 0].set(1.0))
    twalk = inputs_zero(n_chars, device="cpu")
    twalk.motion[0, 0] = 1.0
    for _ in range(150):
        jeng.frame(jwalk)
        teng.frame(twalk)
    assert len(teng.voice_log) >= 2
    assert teng.voice_log == jeng.voice_log
    frames = [f for f, _foot, _c in teng.voice_log]
    assert (np.diff(frames) > 2).all(), frames
    ref, got = np.concatenate(jeng.audio_buffer), \
        np.concatenate(teng.audio_buffer)
    assert got.shape[0] == 150 * (teng.sound.rate // 60)
    assert np.array_equal(got, ref) and float(np.abs(got).max()) > 0.01

