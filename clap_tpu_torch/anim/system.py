"""Character animation system: state machine → clip queue → pose →
skinning matrices (counterpart of clap_tpu/anim/system.py; the glue the
reference spreads across character_set_state's animation_push_by_name
calls, character.c:316-426, and animated_update, model.c:1406-1592).

A static state→clip table drives the transitions as masked queue ops.
Everything is batched over the leading axes of the instance and the
character state: (env, rig) in game_step, where the JAX package vmaps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .clips import AnimLibrary, Pose, sample_pose
from .joints import Skeleton, joint_matrices
from .queue import AnimQueue, queue_advance, queue_init, queue_push

N_STATES = 7  # CS_START..CS_FALLING (character.h:11-18)


class AnimConfig(NamedTuple):
    """Static per-character-model animation wiring."""

    state_clip: torch.Tensor    # (N_STATES,) int32 clip per CS_*, -1 none
    state_repeat: torch.Tensor  # (N_STATES,) bool looped clip


class AnimInstance(NamedTuple):
    """Dynamic per-character animation state."""

    queue: AnimQueue
    prev_state: torch.Tensor    # int32 last seen CS_*
    sfx_state: torch.Tensor = None  # int32 frame-SFX counter
                                    # (queued_animation->sfx_state,
                                    # scene.c:1239-1293); None when the
                                    # scene wires no animation SFX


class AnimSfx(NamedTuple):
    """Per-clip frame-SFX wiring (the animation_sfx table,
    scene.c:1295-1303, resolved per clip at scene load like
    scene.c:1678-1684).

    segments[c] > 0: the clip fires alternating footsteps every time
    normalized progress crosses (2k+1)/segments (motion_frame_sfx) —
    right foot first.
    single[c] ≥ 0: the clip fires ONE footstep when progress crosses the
    threshold (jump_to_motion at 0.5; motion_stop/fall at 0);
    single_foot[c] picks the foot (0 = left, 1 = right)."""

    segments: torch.Tensor     # (L,) int32, 0 = none
    single: torch.Tensor       # (L,) f32 normalized threshold, -1 = none
    single_foot: torch.Tensor  # (L,) int32 0 left / 1 right


def anim_sfx_from_names(names: list[str], motion_segments: int = 4,
                        device=None) -> AnimSfx:
    """Build the per-clip AnimSfx table from clip names — the exact
    name→frame_fn wiring of animation_sfx (scene.c:1295-1303)."""
    device = resolve_device(device)
    L = max(len(names), 1)
    seg = np.zeros((L,), np.int32)
    single = np.full((L,), -1.0, np.float32)
    foot = np.zeros((L,), np.int32)
    for i, n in enumerate(names):
        if n == "motion":
            seg[i] = motion_segments
        elif n in ("motion_stop", "fall_to_idle", "jump_to_idle", "fall"):
            single[i], foot[i] = 0.0, 0          # left
        elif n == "jump_to_motion":
            single[i], foot[i] = 0.5, 1          # right
    return AnimSfx(*(torch.as_tensor(a, device=device)
                     for a in (seg, single, foot)))


def default_state_map(names: list[str], device=None) -> AnimConfig:
    """Map CS_* to clips by the reference's naming convention
    ("idle"/"motion"/"jump"/"fall", scene.c animation renames)."""
    device = resolve_device(device)
    def find(*cands):
        for c in cands:
            if c in names:
                return names.index(c)
        return -1

    idle = find("idle")
    motion = find("motion", "walk", "run")
    jump = find("jump")
    fall = find("fall", "falling")
    table = [idle, idle, idle, motion, jump, jump, fall]  # START..FALLING
    repeat = [True, True, True, True, False, True, True]
    return AnimConfig(
        state_clip=torch.tensor(table, dtype=torch.int32, device=device),
        state_repeat=torch.tensor(repeat, device=device))


def anim_instance_init(with_sfx: bool = False, device=None) -> AnimInstance:
    device = resolve_device(device)
    return AnimInstance(
        queue=queue_init(device),
        prev_state=torch.tensor(-1, dtype=torch.int32, device=device),
        sfx_state=torch.tensor(0, dtype=torch.int32, device=device)
        if with_sfx else None)


def anim_instances_init(n: int, with_sfx: bool = False,
                        device=None) -> AnimInstance:
    """Batched instances for n rigs (mq_update animates every entity's
    rig each frame, model.c:1953). with_sfx allocates the frame-SFX
    counter — pass True when the GameWorld wires an AnimSfx table."""
    device = resolve_device(device)
    def rep(x):
        return None if x is None else x.expand(n, *x.shape).clone()

    one = anim_instance_init(with_sfx, device)
    return AnimInstance(AnimQueue(*map(rep, one.queue)), rep(one.prev_state),
                        rep(one.sfx_state))


def _trail(mask, like):
    """``mask`` (...) with trailing unit axes to broadcast against
    ``like`` (..., *)."""
    return mask.reshape(*mask.shape, *(1,) * (like.dim() - mask.dim()))


def anim_step(acfg: AnimConfig, sk: Skeleton, lib: AnimLibrary,
              inst: AnimInstance, char_state, dt, sfx: AnimSfx = None):
    """Advance the animation of every character of the batch.

    On a CS_* transition the mapped clip replaces the queue (the C clears
    and pushes transition/loop clips); the queue then advances by dt, and
    the current clip's pose is sampled and turned into skinning matrices.
    Returns (new AnimInstance, joint matrices (..., J, 4, 4)) — plus a
    (..., 2) bool [left, right] footstep-event tensor when ``sfx`` wires
    the per-clip table (the frame_sfx callbacks, scene.c:1239-1303)."""
    char_state = torch.as_tensor(char_state, dtype=torch.int32,
                                 device=lib.times.device)
    changed = char_state != inst.prev_state
    cs = torch.clamp(char_state, 0, N_STATES - 1).long()
    clip = acfg.state_clip[cs]
    rep = acfg.state_repeat[cs]
    do_push = changed & (clip >= 0)

    q = queue_push(inst.queue, clip, rep, True)
    q = AnimQueue(*(torch.where(_trail(do_push, new), new, old)
                    for new, old in zip(q, inst.queue)))
    q, _ended, _active = queue_advance(q, lib.duration, dt)

    has = q.clip[..., 0] >= 0
    cur = torch.clamp(q.clip[..., 0], min=0).long()
    pose = sample_pose(lib, sk.base, cur, q.time)
    # no active clip → rest pose
    h = has[..., None, None]
    pose = Pose(trans=torch.where(h, pose.trans, sk.base.trans),
                rot=torch.where(h, pose.rot, sk.base.rot),
                scale=torch.where(h, pose.scale, sk.base.scale))
    jt = joint_matrices(sk, pose)

    sfx_state = inst.sfx_state
    events = None
    if sfx is not None:
        # frame-SFX counter: reset on clip replacement or loop wrap
        # (qa->sfx_state starts at 0 per queued clip), then fire when
        # normalized progress crosses the clip's next trigger
        state = torch.zeros_like(char_state) if sfx_state is None \
            else sfx_state
        reset = do_push | (q.time < inst.queue.time)
        state = torch.where(reset, 0, state)
        dur = torch.clamp(lib.duration[cur], min=1e-6)
        tn = q.time / dur
        nseg = sfx.segments[cur]
        thr = (state.to(torch.float32) * 2.0 + 1.0) \
            / torch.clamp(nseg.to(torch.float32), min=1.0)
        fire_seg = has & (nseg > 0) & (tn >= thr)
        # alternating feet, right first (motion_frame_sfx scene.c:1249)
        right_seg = (state % 2) == 0
        sthr = sfx.single[cur]
        fire_one = has & (sthr >= 0) & (state == 0) & (tn >= sthr)
        right_one = sfx.single_foot[cur] == 1
        fired = fire_seg | fire_one
        right = torch.where(fire_seg, right_seg, right_one)
        events = torch.stack([fired & ~right, fired & right], dim=-1)
        sfx_state = state + fired.to(torch.int32)

    inst2 = AnimInstance(queue=q, prev_state=char_state, sfx_state=sfx_state)
    if sfx is None:
        return inst2, jt
    return inst2, jt, events
