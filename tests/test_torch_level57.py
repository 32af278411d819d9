"""The authored level on the port against the JAX package: demo/level57.json
through both loaders with the level's asset pack, wired as
demo/platformer.py:46-66 wires it (the demo rig, footstep SFX, the
switch/platform rules of the level's gameplay blocks, the two-camera bank,
the camera occlusion on), then game_step on the scripted walk (character 0
walks +x) until switch A latches and platform group 0 turns visible and
solid. The JAX test this mirrors (tests/test_level57.py) is slow: the frame
count is cut to just past the latch, not the scene.

The latch frame and every int/bool field are exact, float fields within
atol 1e-4 + rtol 1e-4. The JAX package steps with its unbatched jitted
game_step (about a minute of XLA compile for the level's contact solve)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))

import assets57
from clap_tpu.anim.system import anim_instances_init as janim_init
from clap_tpu.anim.system import anim_sfx_from_names as jsfx
from clap_tpu.engine.game import GameSessionState as JSession
from clap_tpu.engine.game import GameWorld as JWorld
from clap_tpu.engine.game import game_step as jgame_step
from clap_tpu.engine.gamelogic import game_state_init as jgame_init
from clap_tpu.engine.step import inputs_zero as jinputs_zero
from clap_tpu.physics.narrowphase import raycast_down as jraycast_down
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu.scene.testbed import build_demo_rig as jrig
from clap_tpu_torch.anim.system import anim_instances_init, anim_sfx_from_names
from clap_tpu_torch.engine.game import GameSessionState, GameWorld, game_step
from clap_tpu_torch.engine.gamelogic import game_state_init
from clap_tpu_torch.engine.step import inputs_zero
from clap_tpu_torch.physics.narrowphase import raycast_down
from clap_tpu_torch.scene import assets57 as tassets
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import build_demo_rig, replicate_state
from test_torch_common import assert_tree_close, jnp_tree

LEVEL = Path(__file__).resolve().parents[1] / "demo" / "level57.json"
FRAMES = 56
CLIPS = ["idle", "motion", "jump", "fall"]


@pytest.fixture(scope="module")
def level():
    """Both packages' level, wired as the demo wires it, and the JAX
    package's jitted step, which takes ``next_character`` as an argument
    as demo/platformer.py:84 does: one XLA compile serves the walk and the
    demo's run."""
    doc = LEVEL.read_text()
    J = jload(doc, asset_loader=assets57.asset_loader, max_entities=16,
              max_bodies=4)
    T = load_scene(doc, asset_loader=tassets.asset_loader, max_entities=16,
                   max_bodies=4, device="cpu")
    sk, lib, acfg = jrig()
    jgw = JWorld(scene=J.cfg, game=J.game, anim=acfg, anim_sk=sk,
                 anim_lib=lib, sfx=jsfx(CLIPS, motion_segments=4))
    jgs = JSession(engine=J.state0, game=jgame_init(2, 2),
                   anim=janim_init(2, with_sfx=True),
                   joint_mats=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                                       (2, 3, 1, 1)),
                   sfx_events=jnp.zeros((2, 2), bool))
    jstep = jax.jit(lambda s, i, nxt: jgame_step(jgw, s, i,
                                                 next_character=nxt))
    return J, T, jgs, jstep


@pytest.fixture(scope="module")
def walk(level):
    J, T, jgs, jstep = level
    sk, lib, acfg = build_demo_rig(device="cpu")
    tgw = GameWorld(scene=T.cfg, game=T.game, anim=acfg, anim_sk=sk,
                    anim_lib=lib,
                    sfx=anim_sfx_from_names(CLIPS, motion_segments=4,
                                            device="cpu"))
    tgs = replicate_state(GameSessionState(
        engine=T.state0, game=game_state_init(2, 2, device="cpu"),
        anim=anim_instances_init(2, with_sfx=True, device="cpu"),
        joint_mats=torch.eye(4).repeat(2, 3, 1, 1),
        sfx_events=torch.zeros(2, 2, dtype=torch.bool)), 1)
    jins = jinputs_zero(2)._replace(
        motion=jnp.zeros((2, 2), jnp.float32).at[0, 0].set(1.0))
    tins = inputs_zero(2, device="cpu")
    tins.motion[0, 0] = 1.0
    tins = type(tins)(*(x[None] for x in tins))
    nxt = torch.zeros(1, dtype=torch.bool)
    out = []
    for _ in range(FRAMES):
        jgs = jstep(jgs, jins, jnp.array(False))
        tgs = game_step(tgw, tgs, tins, next_character=nxt)
        out.append((jnp_tree(jgs), tgs))
    return J, T, out


def _latch_frame(states, env=False):
    for f, s in enumerate(states):
        on = s.game.switch_on[0, 0] if env else s.game.switch_on[0]
        if bool(on):
            return f
    return None


def test_switch_a_latches_on_the_same_frame(walk):
    _, _, out = walk
    fj = _latch_frame([r for r, _ in out])
    ft = _latch_frame([g for _, g in out], env=True)
    assert fj is not None and fj == ft, (fj, ft)
    assert fj < FRAMES - 2
    # standing on the raised switch box (entity 0), not the terrain
    assert int(out[ft][1].engine.chars.collision[0, 0]) == 0


@pytest.mark.parametrize("part", ["engine", "game", "anim", "joint_mats",
                                  "sfx_events"])
@pytest.mark.parametrize("frame", [0, 20, "latch", FRAMES - 1])
def test_walk_trajectory(walk, frame, part):
    _, _, out = walk
    if frame == "latch":
        frame = _latch_frame([r for r, _ in out])
    ref, got = out[frame]
    r = getattr(ref, part)
    g = jnp_tree_first_env(getattr(got, part))
    assert_tree_close(r, g, path=part)


def jnp_tree_first_env(tree):
    """Env 0 of a port tree (the JAX package ran one env, unbatched)."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(jnp_tree_first_env(x) for x in tree))
    return tree[0]


def test_group_0_turns_visible_and_solid(walk):
    """At the latch the three platforms of group 0 turn visible (group 1
    stays hidden), and their triangles become solid: a ray cast down over
    plat.0 with the engine's visibility-coupled validity hits entity 2
    after the latch and the terrain (-1) before it, in both packages."""
    J, T, out = walk
    f = _latch_frame([r for r, _ in out])
    pg = T.game.platform_group
    for k, (ref, got) in enumerate(out[f - 1:f + 1]):
        vis = got.engine.visible[0]
        np.testing.assert_array_equal(vis.numpy(), ref.engine.visible)
        assert bool(vis[pg == 0].all()) == (k == 1)
        assert not bool(vis[pg == 1].any())
        te = T.cfg.world.tri_entity
        world = T.cfg.world._replace(tri_valid=T.cfg.world.tri_valid & (
            (te < 0) | vis[torch.clamp(te, min=0).long()]))
        origin = torch.tensor([[6.0, 3.0, 0.0]])
        _, _, hit, ent = raycast_down(world, origin, 10.0)
        jte = J.cfg.world.tri_entity
        jworld = J.cfg.world._replace(
            tri_valid=J.cfg.world.tri_valid
            & ((jte < 0) | jnp.asarray(ref.engine.visible)[
                jnp.maximum(jte, 0)]))
        jent = jraycast_down(jworld, jnp.array([6.0, 3.0, 0.0]), 10.0)[3]
        assert int(ent[0]) == int(jent) == (2 if k == 1 else -1)
        assert bool(hit[0])


def jax_demo_run(J, jgs, jstep, frames, switch_frame):
    """demo/platformer.py:72-110's loop on the JAX package's step (the
    walk of the controlled character, Tab on ``switch_frame``, footsteps
    through the JAX package's sound engine): events, control per frame,
    the characters' positions per frame, the footstep log and the WAV."""
    from clap_tpu.utils.sound import SoundEngine, synth_tone

    n_chars = J.cfg.char_params.body.shape[0]
    K = J.game.switch_entity.shape[0]
    body = np.asarray(J.cfg.char_params.body)
    walk = {c: jinputs_zero(n_chars)._replace(
        motion=jnp.zeros((n_chars, 2), jnp.float32).at[c, 0].set(1.0))
        for c in range(n_chars)}
    snd = SoundEngine()
    foot_ids = (snd.add_sound(synth_tone(95.0, 0.09) * 0.8),
                snd.add_sound(synth_tone(110.0, 0.09) * 0.8))
    audio, footsteps, events, control, traj = [], [], [], [], []
    seen = set()
    gs = jgs
    for f in range(frames):
        ctrl = int(gs.game.control)
        control.append(ctrl)
        gs = jstep(gs, walk[ctrl], jnp.array(f == switch_frame))
        traj.append(np.asarray(gs.engine.phys.pos)[body])
        ev = np.asarray(gs.sfx_events)
        for c in range(n_chars):
            for foot in range(2):
                if ev[c, foot]:
                    snd.play(foot_ids[foot])
                    footsteps.append((f, foot, c))
        audio.append(snd.mix(snd.rate // 60))
        if f == switch_frame:
            events.append((f, f"control -> char {int(gs.game.control)} "
                           f"(connected "
                           f"{np.asarray(gs.game.connected).tolist()})"))
        for k in range(K):
            if bool(gs.game.switch_on[k]) and k not in seen:
                seen.add(k)
                events.append((f, f"switch {k} ON -> platforms visible: "
                               f"{int(np.asarray(gs.engine.visible).sum())}"))
    return dict(events=events, control=control, traj=np.stack(traj),
                footsteps=footsteps, audio=np.concatenate(audio))


def test_platformer_demo_run(level):
    """``python -m clap_tpu_torch.demo.platformer``'s run (build_world,
    run) over 30 frames with Tab at 20, against the JAX demo's loop on the
    same jitted step: the same events, control frames and footstep log,
    positions within 1e-3, the WAV within 1e-6."""
    from clap_tpu_torch.demo import platformer as P

    J, _, jgs, jstep = level
    ref = jax_demo_run(J, jgs, jstep, 30, 20)
    got = P.run(P.build_world("cpu"), 30, 20)
    assert got["events"] == ref["events"]
    assert got["control"] == ref["control"] and ref["control"][-1] == 1
    assert got["footsteps"] == ref["footsteps"] and ref["footsteps"]
    np.testing.assert_allclose(got["traj"].numpy(), ref["traj"], atol=1e-3,
                               rtol=0)
    assert got["audio"].shape == ref["audio"].shape
    np.testing.assert_allclose(got["audio"], ref["audio"], atol=1e-6,
                               rtol=0)
