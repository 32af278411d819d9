"""The per-frame engine step (counterpart of clap_tpu/engine/step.py;
clap_frame, clap.c:551-665, headless part).

Order mirrors the reference frame loop: input → character move → char
push → phys_step → limbo → scene update (entity transforms from physics,
TRS rebuild) → camera update. One call advances every env of a batched
EngineState; characters iterate as a Python loop over the static char
slots, everything else is masked tensor math.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import mathx as mx
from ..device import resolve_device
from ..char import controller as C
from ..physics import world as W
from .state import CameraState, EngineState, SceneConfig


class Inputs(NamedTuple):
    """Per-frame input record (the headless subset of struct
    message_input, messagebus.h:33-89); (B, ...) inside the step."""

    motion: torch.Tensor     # (C, 2) dx, dz per character
    jump: torch.Tensor       # (C,) bool
    cam_delta: torch.Tensor  # (3,) pitch, yaw, dist deltas
    dash: torch.Tensor = None  # (C,) bool


def inputs_zero(n_chars: int, device=None) -> Inputs:
    device = resolve_device(device)
    return Inputs(
        motion=torch.zeros((n_chars, 2), dtype=torch.float32, device=device),
        jump=torch.zeros((n_chars,), dtype=torch.bool, device=device),
        cam_delta=torch.zeros(3, dtype=torch.float32, device=device),
        dash=torch.zeros((n_chars,), dtype=torch.bool, device=device),
    )


def _char(tree, ci: int):
    """Slot ``ci`` of a (B, C, ...)-stacked NamedTuple."""
    return type(tree)(*(x[:, ci] for x in tree))


def _stack_chars(chars):
    return type(chars[0])(*(torch.stack(xs, dim=1) for xs in zip(*chars)))


def _char_params(cfg: SceneConfig, ci: int):
    return type(cfg.char_params)(*(x[ci] for x in cfg.char_params))


def _host(cfg: SceneConfig):
    """The scene's SceneHost, which its builder (build_testbed, the
    bridge) fills: a step reads its flags and slots from the host only."""
    if cfg.host is None:
        raise ValueError("SceneConfig.host is not set: build the config "
                         "with scene_host(bodies, char_body) from the host "
                         "arrays")
    return cfg.host


def _characters_move(cfg: SceneConfig, st: EngineState, inputs: Inputs, dt):
    """scene_characters_move (scene.c:1058): rosters of ≤2 characters
    update sequentially — later characters see earlier ones' new body
    positions, like the C entity-list walk. Larger rosters move as one
    batch, as the JAX package's vmapped move does: every character
    against the pre-move body positions, the new positions written once
    at the end (a one-frame lag of char-vs-char sweeps within a step)."""
    n_chars = cfg.char_params.body.shape[0]
    if n_chars == 0:
        return st
    body_pos = st.phys.pos
    char_body = _host(cfg).char_body
    dash = inputs.dash
    moved, new_chars = [], []
    for ci in range(n_chars):
        p_new, cs2 = C.character_move(
            cfg.world, cfg.bodies, _char_params(cfg, ci), _char(st.chars, ci),
            body_pos, inputs.motion[:, ci, 0], inputs.motion[:, ci, 1],
            inputs.jump[:, ci], dt,
            dash_input=None if dash is None else dash[:, ci],
            idx=char_body[ci])
        if n_chars <= 2:
            body_pos = C._set_body(body_pos, char_body[ci], p_new)
        else:
            moved.append(p_new)
        new_chars.append(cs2)
    for ci, p_new in enumerate(moved):
        body_pos = C._set_body(body_pos, char_body[ci], p_new)
    return st._replace(phys=st.phys._replace(pos=body_pos),
                       chars=_stack_chars(new_chars))


def _apply_char_push(cfg: SceneConfig, st: EngineState, dt):
    """phys_body_push (physics.c:677-693): the character shoves the
    dynamic body its sweep ran into (Δv = m_char·v_char·dt/m_body) and
    re-enables it."""
    vel = st.phys.vel
    disabled = st.phys.disabled
    bodies = cfg.bodies
    dyn = bodies.active & ~bodies.kinematic
    n = vel.shape[1]
    inv_m = 1.0 / torch.clamp(bodies.mass, min=1e-6)
    ar = torch.arange(n, device=vel.device)
    char_body = _host(cfg).char_body
    for ci in range(cfg.char_params.body.shape[0]):
        b = st.chars.push_body[:, ci]
        sel = (ar[None, :] == b[:, None]) & dyn
        m_char = bodies.mass[char_body[ci]]
        dv = st.chars.velocity[:, ci][:, None, :] \
            * (m_char * dt * inv_m)[None, :, None]
        vel = vel + torch.where(sel[..., None], dv, 0.0)
        disabled = disabled & ~sel
    return st._replace(phys=st.phys._replace(vel=vel, disabled=disabled))


def _limbo(cfg: SceneConfig, st: EngineState):
    """character_update's limbo teleport (character.c:546-599)."""
    body_pos = st.phys.pos
    n_chars = cfg.char_params.body.shape[0]
    if not n_chars:
        return st
    up = mx.const([0.0, 1.0, 0.0], body_pos.device)
    char_body = _host(cfg).char_body
    new_chars = []
    for ci in range(n_chars):
        b = char_body[ci]
        bp = body_pos[:, b]
        yoff = cfg.bodies.yoffset[b]
        new_pos, cs2, fell = C.limbo_rescue(_char(st.chars, ci),
                                            bp - up * yoff, cfg.limbo_height)
        geom_pos = new_pos + up * yoff
        body_pos = C._set_body(body_pos, b,
                               torch.where(fell[:, None], geom_pos, bp))
        cs2 = cs2._replace(velocity=torch.where(fell[:, None], 0.0,
                                                cs2.velocity))
        new_chars.append(cs2)
    return st._replace(phys=st.phys._replace(pos=body_pos),
                       chars=_stack_chars(new_chars))


def _scene_update(cfg: SceneConfig, st: EngineState):
    """mq_update → entity3d default_update (model.c:1649-1723): sync
    entity transforms from physics bodies, rebuild world matrices."""
    ent = cfg.entities
    has_body = ent.body >= 0
    b = torch.clamp(ent.body, min=0).long()
    geom_pos = st.phys.pos[:, b]                             # (B, E, 3)
    z = torch.zeros_like(cfg.bodies.yoffset[b])
    off = torch.stack([z, cfg.bodies.yoffset[b], z], dim=-1)
    pos = torch.where(has_body[:, None], geom_pos - off, st.pos)
    # dynamic bodies sync rotation; characters stay upright
    dyn = has_body & ~ent.body_is_char
    rot = torch.where(dyn[:, None], st.phys.quat[:, b], st.rot)
    st = st._replace(rot=rot)
    has_parent = ent.parent >= 0
    p = torch.clamp(ent.parent, min=0).long()
    pos = torch.where(has_parent[:, None], pos + st.pos[:, p], pos)
    return st._replace(pos=pos, mx=mx.mat4_compose_trs(pos, st.rot,
                                                       st.scale))


def _camera_update(cfg: SceneConfig, st: EngineState, inputs: Inputs,
                   control=None, head_target=None,
                   camera_occlusion: bool = False):
    """Orbit camera (camera.c:208-246): pitch-clamped quat orbit around
    the followed character, with the near-plane occlusion shrink when
    ``camera_occlusion``. The state keeps the DESIRED distance; only the
    eye position shrinks.

    ``control`` ((B,) int32, optional) retargets the orbit onto the
    roster-controlled character slot (scene_control_next scene.c:23-55);
    None follows slot 0. ``head_target`` ((B, C, 3) pos, (B, C) valid,
    optional): a valid head of the followed character becomes the target
    (camera_target camera.c:174-206, the rig's JOINT_HEAD).

    With a camera bank (``st.cameras`` and ``cfg.camera_char``) every slot
    tracks its target every frame (scene_cameras_calc scene.c:1050-1055):
    input steers slot 0, a slot follows its ``camera_char`` where that is
    >= 0 and the controlled character elsewhere, the head and the
    occlusion shrink apply per slot, and the active camera is slot 0."""
    from ..render.camera import camera_update, orbit_quat

    if st.cameras is not None and cfg.camera_char is not None:
        return _camera_bank_update(cfg, st, inputs, control, head_target,
                                   camera_occlusion)
    cam = st.camera
    d = inputs.cam_delta
    pitch = torch.clamp(cam.pitch + d[:, 0], -1.45, 1.45)
    yaw = torch.remainder(cam.yaw + d[:, 1] + math.pi, 2 * math.pi) \
        - math.pi
    dist = torch.clamp(cam.dist + d[:, 2], 1.0, 50.0)
    n_chars = cfg.char_params.body.shape[0]
    if control is None:
        b0 = _host(cfg).char_body[0] if n_chars else 0
        target = st.phys.pos[:, b0]
    else:
        follow = control.long()
        b0 = cfg.char_params.body[torch.clamp(follow, 0, n_chars - 1)] \
            if n_chars else torch.zeros_like(follow)
        env = torch.arange(follow.shape[0], device=follow.device)
        target = st.phys.pos[env, b0.long()]
    if head_target is not None:
        hpos, hvalid = head_target
        env = torch.arange(hpos.shape[0], device=hpos.device)
        c = torch.zeros_like(env) if control is None \
            else torch.clamp(control.long(), 0, hpos.shape[1] - 1)
        target = torch.where(hvalid[env, c][:, None], hpos[env, c], target)
    if camera_occlusion:
        eye, _q, _deff = camera_update(cfg.world, target, pitch, yaw, dist)
    else:
        eye = mx.transform_orbit(orbit_quat(pitch, yaw), target, dist)
    return st._replace(camera=CameraState(pitch=pitch, yaw=yaw, dist=dist,
                                          pos=eye))


def _camera_bank_update(cfg: SceneConfig, st: EngineState, inputs: Inputs,
                        control, head_target, camera_occlusion: bool):
    """_camera_update over the (B, NC) camera bank. Both paths stay, as
    in the JAX package (clap_tpu/engine/step.py:202-235 beside :237-260): a
    scene without a bank keeps one camera, may have no characters, and
    follows slot 0's body through the host facts with no gather. Running
    it as a one-slot bank instead is not yet measured against the
    testbed's launches per frame."""
    from ..render.camera import camera_update, orbit_quat

    cams = st.cameras
    d = inputs.cam_delta

    def steer(x, k):
        return torch.cat([x[:, :1] + d[:, k:k + 1], x[:, 1:]], dim=1)

    pitch = torch.clamp(steer(cams.pitch, 0), -1.45, 1.45)
    yaw = torch.remainder(steer(cams.yaw, 1) + math.pi, 2 * math.pi) \
        - math.pi
    dist = torch.clamp(steer(cams.dist, 2), 1.0, 50.0)
    B = pitch.shape[0]
    env = torch.arange(B, device=pitch.device)[:, None]
    ctrl = torch.zeros(B, dtype=torch.long, device=pitch.device) \
        if control is None else control.long()
    cc = cfg.camera_char.long()
    follow = torch.where(cc >= 0, cc, ctrl[:, None])           # (B, NC)
    n_chars = cfg.char_params.body.shape[0]
    body = cfg.char_params.body[torch.clamp(follow, 0, n_chars - 1)]
    targets = st.phys.pos[env, body.long()]                    # (B, NC, 3)
    if head_target is not None:
        hpos, hvalid = head_target
        c = torch.clamp(follow, 0, hpos.shape[1] - 1)
        targets = torch.where(hvalid[env, c][..., None], hpos[env, c],
                              targets)
    if camera_occlusion:
        eyes = camera_update(cfg.world, targets, pitch, yaw, dist)[0]
    else:
        eyes = mx.transform_orbit(orbit_quat(pitch, yaw), targets, dist)
    bank = CameraState(pitch=pitch, yaw=yaw, dist=dist, pos=eyes)
    return st._replace(camera=CameraState(*(x[:, 0] for x in bank)),
                       cameras=bank)


def _follow_entities(cfg: SceneConfig, st: EngineState, world):
    """Static-trimesh collision that follows its entity (ODE geoms ride
    entity transforms, physics.c:789-811): per-env triangles (B, T, 3, 3)
    of the owning entities' current pose. Translation only, tri +
    (pos − rest_pos), unless ``cfg.ent_rest_rot`` is set; then the full
    transform, R(rot)·R(rest)ᵀ·(tri − rest_pos) + pos."""
    te = world.tri_entity
    e = torch.clamp(te, min=0).long()
    owned = (te >= 0)[None, :, None, None]                     # (1,T,1,1)
    if cfg.ent_rest_rot is None:
        delta = (st.pos - cfg.ent_rest_pos)[:, e]              # (B, T, 3)
        return world.tris + torch.where(owned[..., 0], delta, 0.0
                                        )[:, :, None, :]
    r_rel = mx.mat3_from_quat(st.rot) \
        @ mx.mat3_from_quat(cfg.ent_rest_rot).transpose(-1, -2)  # (B,E,3,3)
    local = world.tris - cfg.ent_rest_pos[e][:, None, :]       # (T, 3, 3)
    moved = local @ r_rel[:, e].transpose(-1, -2) \
        + st.pos[:, e][:, :, None, :]                          # (B,T,3,3)
    return torch.where(owned, moved, world.tris)


def engine_step(cfg: SceneConfig, st: EngineState, inputs: Inputs,
                dt=1.0 / 60.0, max_substeps: int = 2, control=None,
                head_target=None,
                camera_occlusion: bool = False) -> EngineState:
    """One headless frame for every env of ``st`` (leading env axis B).

    max_substeps=2 is exact for 60 Hz frames. ``control`` ((B,) int32)
    and ``head_target`` ((B, C, 3), (B, C) bool) retarget the camera (see
    _camera_update)."""
    dev = st.pos.device
    if not isinstance(dt, torch.Tensor):
        dt = torch.full((), dt, dtype=torch.float32, device=dev)
    # static-trimesh validity follows entity visibility (per env), and
    # with ent_rest_pos the triangles follow their entity (per env)
    world = cfg.world
    if world.tri_entity is not None:
        te = world.tri_entity
        tvis = (te < 0) | st.visible[:, torch.clamp(te, min=0).long()]
        world = world._replace(tri_valid=world.tri_valid & tvis)
        if cfg.ent_rest_pos is not None:
            world = world._replace(tris=_follow_entities(cfg, st, world))
        cfg = cfg._replace(world=world)
    st = _characters_move(cfg, st, inputs, dt)
    st = _apply_char_push(cfg, st, dt)
    st = st._replace(phys=W.phys_step(world, cfg.bodies, st.phys, dt,
                                      max_substeps,
                                      flags=_host(cfg).body_flags))
    st = _limbo(cfg, st)
    st = _scene_update(cfg, st)
    st = _camera_update(cfg, st, inputs, control, head_target,
                        camera_occlusion)
    return st._replace(time=st.time + dt, frame=st.frame + 1)
