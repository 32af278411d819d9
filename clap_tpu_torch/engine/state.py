"""Engine state schema (counterpart of clap_tpu/engine/state.py).

The whole engine is one NamedTuple of SoA tensors with static capacities
and validity masks. ``EngineState`` is per env: inside the step every
field carries a leading env axis B (``replicate_state`` adds it to the
unbatched template a scene builder returns). ``SceneConfig`` is static
data shared by every env: collision world, body parameters, entity↔body
wiring, per-model AABBs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..char.controller import CharParams, CharState, char_state_init
from ..device import resolve_device
from ..physics.narrowphase import StaticWorld
from ..physics.world import (BodyFlags, BodyParams, PhysState, body_flags,
                             phys_state_init)


class EntityParams(NamedTuple):
    """Static per-entity-slot data, (E,) tensors."""

    active: torch.Tensor       # bool
    model_id: torch.Tensor     # int32 index into model tables
    body: torch.Tensor         # int32 physics body slot, -1 = none
    body_is_char: torch.Tensor  # bool: body is a kinematic character capsule
    yoffset: torch.Tensor      # f32 geom offset
    parent: torch.Tensor       # int32 parent entity, -1 = world
    skip_culling: torch.Tensor  # bool (terrain sets ENTITY3D_SKIP_CULLING)


class CameraState(NamedTuple):
    """3rd-person orbit camera (camera.{c,h}).

    The ACTIVE camera (``EngineState.camera``: (B,) fields, pos (B, 3)),
    and, with a slot axis after the env axis, the ≤4-slot camera bank
    (``EngineState.cameras``: (B, NC) fields, pos (B, NC, 3); scene.h:40,
    NR_CAMERAS_MAX)."""

    pitch: torch.Tensor        # f32 radians
    yaw: torch.Tensor          # f32 radians
    dist: torch.Tensor         # f32 orbit distance
    pos: torch.Tensor          # (3,) derived eye position


class EngineState(NamedTuple):
    """Dynamic per-env state (leading env axis B inside the step)."""

    pos: torch.Tensor          # (E, 3)
    rot: torch.Tensor          # (E, 4) quats
    scale: torch.Tensor        # (E,)
    visible: torch.Tensor      # (E,) bool
    mx: torch.Tensor           # (E, 4, 4) world matrices (refreshed per step)
    phys: PhysState
    chars: CharState           # (C, ...) stacked
    camera: CameraState
    time: torch.Tensor         # f32 seconds
    frame: torch.Tensor        # int32
    cameras: CameraState = None  # (NC,)-stacked camera bank or None;
                                 # slot 0 is the active camera


@dataclass(frozen=True)
class SceneHost:
    """The host-side facts of a scene that the step branches on, decided
    once where the scene is built, so a step reads nothing back from the
    device: the body set's solver flags and each character's body slot."""

    body_flags: BodyFlags
    char_body: tuple


def scene_host(bodies, char_body) -> SceneHost:
    """SceneHost from the host arrays that build a scene: BodyParams
    ``bodies`` and the characters' body slots ``char_body`` (C,)."""
    return SceneHost(body_flags=body_flags(bodies.half_len,
                                           bodies.kinematic),
                     char_body=tuple(int(b) for b in
                                     np.asarray(char_body).reshape(-1)))


class SceneConfig(NamedTuple):
    """Static per-scene data shared by every env. ``host`` (a port-only
    field, after the JAX package's fields) carries the SceneHost; the
    bridge fills it from the JAX package's host arrays."""

    world: StaticWorld
    bodies: BodyParams
    entities: EntityParams
    char_params: CharParams    # (C,) stacked
    model_aabb: torch.Tensor   # (M, 2, 3) min/max per model
    limbo_height: torch.Tensor  # f32
    gravity_y: torch.Tensor    # f32
    camera_char: torch.Tensor = None  # (NC,) int32 char each camera slot
                                      # follows; -1 = the controlled char
    ent_rest_pos: torch.Tensor = None  # (E, 3) load-pose positions: when
                                       # set, static-trimesh collision
                                       # follows its entity (per env)
    ent_rest_rot: torch.Tensor = None  # (E, 4) load-pose quats: with
                                       # ent_rest_pos, the full transform
                                       # follows, not only the translation
    host: SceneHost = None


def engine_state_init(n_entities: int, n_bodies: int, n_chars: int,
                      n_cameras: int = 0, device=None) -> EngineState:
    """Unbatched initial state. ``n_cameras`` > 0 allocates the ≤4-slot
    camera bank (scene.h:40); 0 keeps the single active camera."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    bl = dict(dtype=torch.bool, device=device)
    chars = CharState(*(x.expand((n_chars,) + x.shape).clone()
                        for x in char_state_init(device)))
    phys = phys_state_init(n_bodies, device)
    cameras = None
    if n_cameras:
        cameras = CameraState(
            pitch=torch.full((n_cameras,), -0.3, **f32),
            yaw=torch.zeros(n_cameras, **f32),
            dist=torch.full((n_cameras,), 8.0, **f32),
            pos=torch.zeros(n_cameras, 3, **f32))
    E = n_entities
    return EngineState(
        pos=torch.zeros(E, 3, **f32),
        rot=torch.tensor([0.0, 0.0, 0.0, 1.0], **f32).repeat(E, 1),
        scale=torch.ones(E, **f32),
        visible=torch.zeros(E, **bl),
        mx=torch.eye(4, **f32).repeat(E, 1, 1),
        phys=phys,
        chars=chars,
        camera=CameraState(
            pitch=torch.tensor(-0.3, **f32), yaw=torch.tensor(0.0, **f32),
            dist=torch.tensor(8.0, **f32), pos=torch.zeros(3, **f32)),
        time=torch.tensor(0.0, **f32),
        frame=torch.tensor(0, **i32),
        cameras=cameras,
    )
