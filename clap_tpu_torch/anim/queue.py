"""Animation queue (counterpart of clap_tpu/anim/queue.py; reference:
model.c:1406-1592 animation_push/animated_update).

Per-entity queue of clips with repeat/speed and end notification. The C
queue is a linked list with end-callbacks; here it is a fixed Q-slot ring
advanced with masked shifts, batched over any leading axes, and "a clip
just ended" is returned as a flag the character state machine consumes
(the callbacks in the reference only drive state transitions and SFX,
character.c:316-426).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx
from ..device import resolve_device

QUEUE_MAX = 4


class AnimQueue(NamedTuple):
    clip: torch.Tensor      # (..., Q) int32 clip ids, -1 empty
    repeat: torch.Tensor    # (..., Q) bool: loop at end
    time: torch.Tensor      # (...) f32 current clip time
    speed: torch.Tensor     # (...) f32 (animation_set_speed, dash ×1.5)


def queue_init(device=None) -> AnimQueue:
    device = resolve_device(device)
    return AnimQueue(
        clip=torch.full((QUEUE_MAX,), -1, dtype=torch.int32, device=device),
        repeat=torch.zeros((QUEUE_MAX,), dtype=torch.bool, device=device),
        time=torch.tensor(0.0, device=device),
        speed=torch.tensor(1.0, device=device))


def queue_push(q: AnimQueue, clip_id, repeat, clear) -> AnimQueue:
    """animation_push_by_name: optionally clear the queue, then append.

    With ``clear`` the new clip becomes current (time resets). A full
    queue drops the appended clip."""
    dev = q.clip.device
    clip_id, repeat, clear = (
        x.to(dt) if isinstance(x, torch.Tensor) else mx.const(x, dev, dt)
        for x, dt in ((clip_id, torch.int32), (repeat, torch.bool),
                      (clear, torch.bool)))
    first = torch.arange(QUEUE_MAX, device=dev) == 0
    cleared_clip = torch.where(first, clip_id[..., None], -1)
    cleared_rep = first & repeat[..., None]
    # append at the first free slot
    free = q.clip < 0
    slot = torch.argmax(free.to(torch.int32), dim=-1, keepdim=True)
    at = (torch.arange(QUEUE_MAX, device=dev) == slot) \
        & free.any(-1, keepdim=True)
    app_clip = torch.where(at, clip_id[..., None], q.clip)
    app_rep = torch.where(at, repeat[..., None], q.repeat)
    return AnimQueue(
        clip=torch.where(clear[..., None], cleared_clip, app_clip),
        repeat=torch.where(clear[..., None], cleared_rep, app_rep),
        time=torch.where(clear, 0.0, q.time),
        speed=q.speed)


def queue_advance(q: AnimQueue, durations, dt):
    """animated_update: advance time; wrap on repeat, pop on end.

    durations: (L,) clip durations. Returns (new_queue, ended, active):
    ended pulses True the frame a non-repeating clip finishes."""
    cur = q.clip[..., 0]
    has = cur >= 0
    dur = torch.clamp(durations[torch.clamp(cur, min=0).long()], min=1e-6)
    t = q.time + dt * q.speed
    over = has & (t >= dur)
    rep = q.repeat[..., 0]
    t_wrapped = torch.remainder(t, dur)      # loops at frame granularity
    clip_pop = torch.cat([q.clip[..., 1:],
                          torch.full_like(q.clip[..., :1], -1)], dim=-1)
    rep_pop = torch.cat([q.repeat[..., 1:],
                         torch.zeros_like(q.repeat[..., :1])], dim=-1)
    pop = over & ~rep
    new = AnimQueue(
        clip=torch.where(pop[..., None], clip_pop, q.clip),
        repeat=torch.where(pop[..., None], rep_pop, q.repeat),
        time=torch.where(over, torch.where(rep, t_wrapped, 0.0), t),
        speed=q.speed)
    return new, pop, has
