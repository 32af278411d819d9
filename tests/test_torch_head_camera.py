"""The camera's head-joint target from a loaded armature on the port
against the JAX package (tests/test_camera_wiring.py:106-170): the
armature scene's skinned arm (its "armature" block maps head → the
"elbow" joint, its "wave" clip renamed to "motion"), GameWorld wired from
the loaded rig and ``char_armature()``, 4 frames of game_step with the
character walking (the camera occlusion on). The head rides one frame
behind, from the previous frame's joint matrices.

Int and bool fields exact, floats within atol 1e-4 + rtol 1e-4; the
head target moves the port's camera away from the body-centre orbit."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_camera_wiring
from clap_tpu.anim.system import anim_instances_init as janim_init
from clap_tpu.anim.system import default_state_map as jstate_map
from clap_tpu.engine.game import GameSessionState as JSession
from clap_tpu.engine.game import GameWorld as JWorld
from clap_tpu.engine.game import game_step as jgame_step
from clap_tpu.engine.step import inputs_zero as jinputs_zero
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu_torch.anim.system import anim_instances_init, default_state_map
from clap_tpu_torch.engine.game import GameSessionState, GameWorld, game_step
from clap_tpu_torch.engine.step import inputs_zero
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import replicate_state
from test_gltf import make_skinned_gltf
from test_torch_common import assert_tree_close, jnp_tree

FRAMES = 4


def _doc():
    sc = json.loads(json.dumps(test_camera_wiring.ARMATURE_SCENE))
    sc["model"][0]["animations"] = {"motion": "wave"}
    return json.dumps(sc)


def _port_world(T, head: bool):
    sk, lib, names, _ = T.models[0].rig
    arm = T.char_armature(device="cpu")
    kw = dict(head_joint=arm["head_joint"], char_entity=arm["char_entity"],
              char_height=arm["char_height"]) if head else {}
    return GameWorld(scene=T.cfg, anim=default_state_map(names, "cpu"),
                     anim_sk=sk, anim_lib=lib, **kw)


def _port_run(T, head: bool):
    gw = _port_world(T, head)
    J = gw.anim_sk.parent.shape[0]
    gs = replicate_state(GameSessionState(
        engine=T.state0, anim=anim_instances_init(1, device="cpu"),
        joint_mats=torch.eye(4).repeat(1, J, 1, 1)), 1)
    ins = inputs_zero(1, device="cpu")
    ins.motion[0, 0] = 1.0
    ins = type(ins)(*(x[None] for x in ins))
    out = []
    for _ in range(FRAMES):
        gs = game_step(gw, gs, ins)
        out.append(gs)
    return out


@pytest.fixture(scope="module")
def runs():
    loader = dict(asset_loader=lambda n: make_skinned_gltf().encode(),
                  max_entities=4, max_bodies=2)
    J = jload(_doc(), **loader)
    T = load_scene(_doc(), device="cpu", **loader)
    sk, lib, names, _ = J.models[0].rig
    arm = J.char_armature()
    gw = JWorld(scene=J.cfg, anim=jstate_map(names), anim_sk=sk,
                anim_lib=lib, head_joint=arm["head_joint"],
                char_entity=arm["char_entity"],
                char_height=arm["char_height"])
    nj = sk.parent.shape[0]
    gs = JSession(engine=J.state0, anim=janim_init(1),
                  joint_mats=jnp.tile(jnp.eye(4, dtype=jnp.float32),
                                      (1, nj, 1, 1)))
    ins = jinputs_zero(1)._replace(motion=jnp.array([[1.0, 0.0]],
                                                    jnp.float32))
    step = jax.jit(lambda s: jgame_step(gw, s, ins))
    ref = []
    for _ in range(FRAMES):
        gs = step(gs)
        ref.append(jax.tree.map(lambda x: np.asarray(x)[None],
                                jnp_tree(gs)))
    return T, ref, _port_run(T, True)


@pytest.mark.parametrize("part", ["engine", "anim", "joint_mats"])
@pytest.mark.parametrize("frame", range(FRAMES))
def test_head_target_trajectory(runs, frame, part):
    _, ref, got = runs
    assert_tree_close(getattr(ref[frame], part), getattr(got[frame], part),
                      path=part)


def test_head_target_moves_the_camera(runs):
    """From the second frame on (the joint matrices exist) the orbit
    centre is the head, not the body: the eye differs from the run
    without the armature's head joint."""
    T, _, got = runs
    plain = _port_run(T, False)
    assert not torch.allclose(got[-1].engine.camera.pos,
                              plain[-1].engine.camera.pos, atol=1e-4)
    assert torch.isfinite(got[-1].engine.camera.pos).all()
