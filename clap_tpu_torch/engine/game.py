"""Unified game step: simulation + gameplay rules + animation + particles
(counterpart of clap_tpu/engine/game.py).

``engine_step`` covers the physics/character core (clap_frame's
move/phys/update segments); this module composes the remaining per-frame
systems — the analogue of the reference's frame update (clap.c:551-628
before rendering):

  engine_step → game rules (switch/platform/roster, gamelogic.py)
  → animation (state → clips → skinning matrices, anim/system.py)
  → particles (ops/particles.py)

One call advances every env of a batched GameSessionState (leading env
axis B; the character rigs are a second axis C where the JAX package
vmaps).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..anim.system import AnimConfig, AnimInstance, AnimSfx, anim_step
from ..ops.particles import ParticleParams, ParticleState, particles_update
from .gamelogic import GameConfig, GameState, game_update
from .state import EngineState, SceneConfig
from .step import Inputs, engine_step


class GameWorld(NamedTuple):
    """Static configuration of the full game (per scene)."""

    scene: SceneConfig
    game: GameConfig | None = None
    anim: AnimConfig | None = None
    anim_sk: object = None          # Skeleton
    anim_lib: object = None         # AnimLibrary
    particles: ParticleParams | None = None
    particle_entity: torch.Tensor | None = None  # (S,) entity each system tracks
    # joint-space attachment (model.h:387-405, model.c:1594-1647: an
    # entity rides a joint of its parent's animated skeleton)
    attach_joint: torch.Tensor | None = None     # (E,) int32 joint id, -1 none
    attach_offset: torch.Tensor | None = None    # (E, 3) local offset
    entity_char: torch.Tensor | None = None      # (E,) char rig slot, -1 none
    # armature semantics (model.h:30-38 joint_type / scene.c:1474-1492
    # "armature" block): the camera aims at the rig's JOINT_HEAD
    head_joint: torch.Tensor | None = None       # (C,) int32 joint, -1 none
    char_entity: torch.Tensor | None = None      # (C,) int32 entity per char
    char_height: torch.Tensor | None = None      # (C,) f32 AABB height
    # near-plane-corner occlusion shrink every frame: the reference camera
    # occlusion-raycasts unconditionally each frame (camera.c:232-236);
    # pure headless sims may pass False
    camera_occlusion: bool = True
    # per-clip frame-SFX table (animation_sfx scene.c:1295-1303); when
    # set, game_step emits per-char footstep events in
    # GameSessionState.sfx_events (init anim with anim_instances_init(n,
    # with_sfx=True))
    sfx: AnimSfx | None = None


class GameSessionState(NamedTuple):
    """Dynamic state of the full game, (B, ...) per field."""

    engine: EngineState
    game: GameState | None = None
    anim: AnimInstance | None = None             # (B, C) over the rigs
    particles: ParticleState | None = None
    joint_mats: torch.Tensor | None = None       # (B, C, J, 4, 4) poses
    sfx_events: torch.Tensor | None = None       # (B, C, 2) bool [left,
                                                 # right] footstep fired


def _head_target(gw: GameWorld, gs: GameSessionState):
    """The rig's JOINT_HEAD world position + 0.2·height per character
    (camera_target camera.c:174-206), from the PREVIOUS frame's joint
    matrices (the head rides one frame behind, as in the JAX package)."""
    bind = torch.linalg.inv_ex(gw.anim_sk.invbind).inverse    # (J, 4, 4)
    hj = torch.clamp(gw.head_joint, min=0).long()        # (C,)
    chars = torch.arange(hj.shape[0], device=hj.device)
    # joint global = skinning · bind; head world = entity mx · global
    glob_h = gs.joint_mats[:, chars, hj] @ bind[hj]      # (B, C, 4, 4)
    emx = gs.engine.mx[:, gw.char_entity.long()]         # (B, C, 4, 4)
    hpos = (emx @ glob_h[..., :, 3:4])[..., :3, 0]       # (B, C, 3)
    if gw.char_height is not None:
        lift = torch.zeros_like(hpos)
        lift[..., 1] = 0.2 * gw.char_height
        hpos = hpos + lift
    return hpos, (gw.head_joint >= 0).expand(hpos.shape[:2])


def _ride_joints(gw: GameWorld, st: EngineState, jt):
    """Joint riding (parent_transform_apply model.c:1594-1647): child
    world = parent_mx · joint_global · offset, joint globals recovered
    from the skinning matrices through the bind pose."""
    ent = gw.scene.entities
    bind = torch.linalg.inv_ex(gw.anim_sk.invbind).inverse
    glob = jt @ bind                                     # (B, C, J, 4, 4)
    j = torch.clamp(gw.attach_joint, min=0).long()
    parent = torch.clamp(ent.parent, min=0).long()
    pchar = torch.clamp(gw.entity_char[parent], min=0).long() \
        if gw.entity_char is not None else torch.zeros_like(parent)
    ride = st.mx[:, parent] @ glob[:, pchar, j]           # (B, E, 4, 4)
    new_pos = (ride[..., :3, :3] @ gw.attach_offset[..., None])[..., 0] \
        + ride[..., :3, 3]
    cond = (gw.attach_joint >= 0) & (ent.parent >= 0)
    ride[..., :3, 3] = new_pos
    return st._replace(pos=torch.where(cond[:, None], new_pos, st.pos),
                       mx=torch.where(cond[:, None, None], ride, st.mx))


def game_step(gw: GameWorld, gs: GameSessionState, inputs: Inputs,
              dt=1.0 / 60.0, next_character=None,
              camera_occlusion: bool | None = None,
              generator: torch.Generator | None = None) -> GameSessionState:
    """One full frame of simulation + gameplay for every env.

    next_character: (B,) bool, cycle roster control (default none).
    generator: the particles' random draws (default torch's)."""
    # camera + rules follow the roster-controlled slot of the previous
    # frame (the switch lands during input handling, before move)
    ctrl = gs.game.control if gs.game is not None else None
    head_target = None
    if (gw.head_joint is not None and gw.char_entity is not None
            and gs.joint_mats is not None):
        head_target = _head_target(gw, gs)
    occl = gw.camera_occlusion if camera_occlusion is None \
        else camera_occlusion
    st = engine_step(gw.scene, gs.engine, inputs, dt, control=ctrl,
                     head_target=head_target, camera_occlusion=occl)

    game = gs.game
    if gw.game is not None and game is not None:
        # controlled character's ground entity, as the controller's ground
        # ray reports it (the character.c:490-496 hook)
        env = torch.arange(st.pos.shape[0], device=st.pos.device)
        ctl = game.control.long()
        ground_ent = st.chars.collision[env, ctl].to(torch.int32)
        char_body = gw.scene.char_params.body.long()
        char_pos = st.phys.pos[:, char_body]
        nxt = next_character if next_character is not None \
            else torch.zeros_like(env, dtype=torch.bool)
        game, vis, pos = game_update(gw.game, game, ground_ent, char_pos,
                                     st.phys.pos[env, char_body[ctl], 1],
                                     nxt)
        is_plat = gw.game.platform_group >= 0
        st = st._replace(
            visible=torch.where(is_plat, vis, st.visible),
            pos=torch.where(is_plat[:, None], pos, st.pos))

    anim = gs.anim
    jt = gs.joint_mats
    sfx_events = gs.sfx_events
    if gw.anim is not None and anim is not None:
        # every rig animates every frame (mq_update walks all entities →
        # animated_update, model.c:1953/1563)
        out = anim_step(gw.anim, gw.anim_sk, gw.anim_lib, anim,
                        st.chars.state, dt, sfx=gw.sfx)
        anim, jt = out[:2]
        if gw.sfx is not None:
            sfx_events = out[2]
        if gw.attach_joint is not None:
            st = _ride_joints(gw, st, jt)

    parts = gs.particles
    if gw.particles is not None and parts is not None:
        centers = st.pos[:, gw.particle_entity.long()]
        parts = particles_update(gw.particles, parts, centers, generator)

    return GameSessionState(engine=st, game=game, anim=anim,
                            particles=parts, joint_mats=jt,
                            sfx_events=sfx_events)
