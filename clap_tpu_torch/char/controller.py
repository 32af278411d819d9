"""Kinematic character controller (counterpart of
clap_tpu/char/controller.py; reference: core/character.c).

Batched over envs: every CharState field carries a leading env axis B, and
one call moves one character slot in every env. Divergent C control flow
is a fixed-trip masked loop: 3 slide iterations, two shared sweeps for the
grounded / rising / falling modes, ground collide with step-up/down
snapping, the int state machine, and the 8-slot grounded-position history
ring used by the limbo rescue.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx
from ..device import resolve_device
from ..mathx import cross
from ..physics.narrowphase import StaticWorld, raycast_down
from ..physics.sweep import sweep_capsule
from ..physics.world import GRAVITY, BodyParams

# character_state (character.h:11-18)
CS_START = 0
CS_WAKING = 1
CS_IDLE = 2
CS_MOVING = 3
CS_JUMP_START = 4
CS_JUMPING = 5
CS_FALLING = 6

POS_HISTORY_MAX = 8
SLIDE_ITERS = 3
MOTION_COEFF_MOVING = 1.0
MOTION_COEFF_OTHER = 0.3
GROUND_SAFETY = 0.05
GROUND_EPSILON = 1e-3
DT_CLAMP_MAX = 1.0 / 30.0
JUMP_START_FRAMES = 6
DASH_MULT = 1.5
DASH_DURATION = 1.0
DASH_COOLDOWN = 2.0


class CharParams(NamedTuple):
    """Static per-character config, (C,) tensors."""

    body: torch.Tensor          # int32 body slot index
    lin_speed: torch.Tensor     # f32 units/s
    jump_forward: torch.Tensor  # f32
    jump_upward: torch.Tensor   # f32
    can_dash: torch.Tensor      # bool


class CharState(NamedTuple):
    """Dynamic per-character state; inside EngineState every field has
    leading (B, C) axes, for one character (B,)."""

    velocity: torch.Tensor      # (3,)
    normal: torch.Tensor        # (3,) ground contact normal
    state: torch.Tensor         # int32 CS_*
    airborne: torch.Tensor      # bool
    jump: torch.Tensor          # bool: input latch
    moved: torch.Tensor         # int32 frames-moved counter
    jump_start_cnt: torch.Tensor  # int32 frames left in JUMP_START
    collision: torch.Tensor     # int32 ground entity id (-1 = none)
    push_body: torch.Tensor     # int32 body slot the move swept into
    history: torch.Tensor       # (POS_HISTORY_MAX, 3) grounded positions
    hist_head: torch.Tensor     # int32
    hist_wrapped: torch.Tensor  # bool
    dash_time: torch.Tensor     # f32 seconds since dash start (-1 = off)


def char_state_init(device=None) -> CharState:
    """One character's initial state (unbatched) on ``device`` (the card
    unless named)."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    no = torch.tensor(False, device=dev)
    return CharState(
        velocity=torch.zeros(3, **f32),
        normal=torch.tensor([0.0, 1.0, 0.0], **f32),
        state=torch.tensor(CS_START, **i32), airborne=no, jump=no.clone(),
        moved=torch.tensor(0, **i32), jump_start_cnt=torch.tensor(0, **i32),
        collision=torch.tensor(-1, **i32), push_body=torch.tensor(-1, **i32),
        history=torch.zeros(POS_HISTORY_MAX, 3, **f32),
        hist_head=torch.tensor(0, **i32), hist_wrapped=no.clone(),
        dash_time=torch.tensor(-1.0, **f32))


def _set_body(body_pos, idx: int, p):
    out = body_pos.clone()
    out[:, idx] = p
    return out


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _sweep_delta(world, params: BodyParams, body_pos, self_idx: int, delta,
                 min_normal_y, stop_on_block):
    """character_sweep_delta (character.c:193-243): 3 sweep-and-slide
    iterations. Returns (new_pos_self, first_frac, hit_body), all (B, ...)."""
    B = body_pos.shape[0]
    dev = body_pos.device
    pos = body_pos[:, self_idx]
    first_frac = torch.ones(B, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    hit_body = torch.full((B,), -1, dtype=torch.int32, device=dev)
    for it_idx in range(SLIDE_ITERS):
        live = ~done & (_norm(delta) >= 1e-6)
        res = sweep_capsule(world, params, _set_body(body_pos, self_idx, pos),
                            self_idx, delta)
        frac = res.frac
        # normal filter: ignore wall/edge contacts on vertical sweeps
        frac = torch.where((frac < 1.0) & (res.normal[:, 1] < min_normal_y),
                           1.0, frac)
        if it_idx == 0:
            first_frac = torch.where(live, frac, first_frac)
        hit_body = torch.where(live & (frac < 1.0) & (hit_body < 0),
                               res.hit_body, hit_body)
        pos = torch.where(live[:, None],
                          pos + delta * torch.clamp(frac, min=0.0)[:, None],
                          pos)
        stop = (frac >= 1.0) | ((frac <= 0.0) & stop_on_block)
        remaining = delta * (1.0 - frac)[:, None]
        d = torch.sum(remaining * res.normal, dim=-1)
        new_delta = remaining - d[:, None] * res.normal
        delta = torch.where((live & ~stop)[:, None], new_delta, delta)
        done = done | (live & stop)
    return pos, first_frac, hit_body


def ground_collide(world: StaticWorld, params: BodyParams, pos, idx: int,
                   grounded):
    """phys_body_ground_collide (physics.c:695-744). Returns
    (new_pos_self, grounded, ground_normal, hit, ground_entity)."""
    ray_off = params.ray_off[idx] - GROUND_SAFETY
    ray_len = params.yoffset[idx] - ray_off + GROUND_EPSILON
    p = pos[:, idx]
    up = mx.const([0.0, 1.0, 0.0], pos.device)
    origin = p - up * ray_off

    dist, normal, hit, ent = raycast_down(world, origin, 2.0 * ray_len)

    above = dist > ray_len
    below = dist < ray_len
    snap_down = grounded & above & hit
    snap_up = below & hit
    dy = torch.where(snap_down, -(dist - ray_len),
                     torch.where(snap_up, ray_len - dist, 0.0))
    new_p = p + up * dy[:, None]
    is_grounded = hit & ~(above & ~grounded)
    return new_p, is_grounded, normal, hit, ent


def character_move(world: StaticWorld, params: BodyParams,
                   cp: CharParams, cs: CharState,
                   body_pos, motion_dx, motion_dz, jump_input, dt,
                   dash_input=None, *, idx: int):
    """character_move (character.c:450-537) for one character slot in
    every env. ``cp`` holds 0-dim tensors of that slot; body_pos (B, N, 3);
    motion/jump/dash (B,); ``idx``: the slot's body index, a host int
    (SceneConfig.host). Returns (new_body_pos_self (B, 3), CharState)."""
    dev = body_pos.device
    dt = torch.clamp(dt, 0.0, DT_CLAMP_MAX)
    zeros3 = torch.zeros_like(cs.velocity)

    # --- ground collide + snap
    p_snap, grounded, gnormal, ghit, gent = ground_collide(
        world, params, body_pos, idx, ~cs.airborne)
    body_pos = _set_body(body_pos, idx, p_snap)
    airborne = ~grounded
    collision = torch.where(grounded, gent, -1)

    # jump-rise protection (character.c:455-463)
    airborne = airborne | ((cs.state == CS_JUMPING) & (cs.velocity[:, 1] > 0))

    velocity = cs.velocity
    state = cs.state
    jump_latch = cs.jump | jump_input

    # --- JUMP_START countdown
    in_jump_start = state == CS_JUMP_START
    jcnt = torch.where(in_jump_start,
                       torch.clamp(cs.jump_start_cnt - 1, min=0),
                       cs.jump_start_cnt)
    to_jumping = in_jump_start & (jcnt == 0)
    state = torch.where(to_jumping, CS_JUMPING, state)
    airborne = airborne | (to_jumping & (velocity[:, 1] > 0))

    # --- airborne branch (character.c:465-484)
    vel_air = velocity.clone()
    vel_air[:, 1] = velocity[:, 1] + GRAVITY[1] * dt
    rising = vel_air[:, 1] > 0
    falling = airborne & ~rising

    # --- grounded motion setup
    z = torch.zeros_like(motion_dx)
    motion = torch.stack([motion_dx, z, motion_dz], dim=-1)
    has_motion = _norm(motion) > 0

    do_jump = grounded & jump_latch & (state >= CS_IDLE) \
        & (state != CS_JUMP_START) & (state != CS_JUMPING)
    v_jump = torch.stack([motion_dx * cp.jump_forward,
                          z + cp.jump_upward,
                          motion_dz * cp.jump_forward], dim=-1)

    # slope-aligned ground basis (character.c:500-527)
    newy = gnormal
    oldx = mx.const([1.0, 0.0, 0.0], dev)
    newz = cross(oldx, newy)
    newx = cross(newy, newz)
    newx = newx / torch.clamp(_norm(newx), min=1e-9)[:, None]
    newz = newz / torch.clamp(_norm(newz), min=1e-9)[:, None]
    mc = torch.where(state == CS_MOVING, MOTION_COEFF_MOVING,
                     MOTION_COEFF_OTHER)
    # dash (character.c:12-67)
    dash_in = torch.zeros_like(grounded) if dash_input is None \
        else dash_input
    dashing = cs.dash_time >= 0.0
    start = dash_in & cp.can_dash & ~dashing & grounded
    dash_t = torch.where(start, 0.0,
                         torch.where(dashing, cs.dash_time + dt, -1.0))
    dash_t = torch.where(dash_t >= DASH_COOLDOWN, -1.0, dash_t)
    dash_t = torch.where((state == CS_IDLE) & ~start, -1.0, dash_t)
    speed_mult = torch.where((dash_t >= 0.0) & (dash_t < DASH_DURATION),
                             DASH_MULT, 1.0)
    v_move = (newx * (motion[:, 0] * mc)[:, None]
              + newz * (motion[:, 2] * mc)[:, None]) \
        * cp.lin_speed * speed_mult[:, None]

    v_ground = torch.where(do_jump[:, None], v_jump,
                           torch.where(has_motion[:, None], v_move, velocity))
    delta_g = torch.where((has_motion & ~do_jump)[:, None], v_move * dt,
                          zeros3)

    # --- two shared sweeps cover grounded / rising / falling
    v_delta = torch.stack([z, vel_air[:, 1] * dt, z], dim=-1)
    h_delta = torch.stack([vel_air[:, 0] * dt, z, vel_air[:, 2] * dt], dim=-1)
    delta_a = torch.where(airborne[:, None],
                          torch.where(rising[:, None], vel_air * dt, v_delta),
                          delta_g)
    min_ny_a = torch.where(falling, 0.5, -1.0)
    stop_a = ~falling
    p_a, frac_a, hit_a = _sweep_delta(world, params, body_pos, idx, delta_a,
                                      min_ny_a, stop_a)
    bp2 = _set_body(body_pos, idx, p_a)
    delta_b = torch.where(falling[:, None], h_delta, zeros3)
    p_b, _, hit_b = _sweep_delta(world, params, bp2, idx, delta_b,
                                 torch.full_like(min_ny_a, -1.0),
                                 torch.ones_like(stop_a))
    push_body = torch.where(hit_a >= 0, hit_a, hit_b)

    new_pos = torch.where(falling[:, None], p_b, p_a)
    v_air_out = vel_air.clone()
    v_air_out[:, 1] = torch.where(frac_a < 1.0, 0.0, vel_air[:, 1])
    new_vel = torch.where(airborne[:, None], v_air_out, v_ground)

    # --- state machine
    new_state = state
    new_state = torch.where(airborne & (state != CS_JUMP_START)
                            & (state != CS_JUMPING), CS_FALLING, new_state)
    new_state = torch.where(~airborne & has_motion & (state != CS_JUMP_START),
                            CS_MOVING, new_state)
    new_state = torch.where(~airborne & ~has_motion & ~do_jump
                            & (state != CS_JUMP_START)
                            & (state != CS_JUMPING), CS_IDLE, new_state)
    landed = ~airborne & ((state == CS_FALLING) | (state == CS_JUMPING))
    new_state = torch.where(landed & has_motion, CS_MOVING,
                            torch.where(landed, CS_IDLE, new_state))
    new_state = torch.where(do_jump, CS_JUMP_START, new_state)
    jcnt = torch.where(do_jump, JUMP_START_FRAMES,
                       torch.where(in_jump_start, jcnt, 0))
    new_state = torch.where((state == CS_START) & (has_motion | jump_input),
                            CS_IDLE, new_state)

    # --- history push (grounded only, character.c:546-557)
    push = ~airborne
    slot = torch.arange(POS_HISTORY_MAX, device=dev)[None, :] \
        == cs.hist_head[:, None]
    hist = torch.where((slot & push[:, None])[..., None], new_pos[:, None],
                       cs.history)
    head = torch.where(push, torch.remainder(cs.hist_head + 1,
                                             POS_HISTORY_MAX), cs.hist_head)
    wrapped = cs.hist_wrapped | (push & (head == 0))

    new_cs = CharState(
        velocity=new_vel.float(),
        normal=gnormal.float(),
        state=new_state.to(torch.int32),
        airborne=airborne,
        jump=torch.zeros_like(cs.jump),
        moved=(cs.moved + 1).to(torch.int32),
        jump_start_cnt=jcnt.to(torch.int32),
        collision=collision.to(torch.int32),
        push_body=push_body.to(torch.int32),
        history=hist,
        hist_head=head.to(torch.int32),
        hist_wrapped=wrapped,
        dash_time=dash_t.float(),
    )
    return new_pos, new_cs


def limbo_rescue(cs: CharState, pos, limbo_height):
    """character_update's limbo teleport (character.c:546-599): when the
    character has fallen ``limbo_height`` below its newest grounded
    position, teleport to the oldest recorded grounded position.
    cs fields and pos (B, 3) are batched over envs."""
    hist = cs.history
    head = cs.hist_head.long()
    prev = torch.gather(hist, 1, torch.clamp(head - 1, min=0)[:, None, None]
                        .expand(-1, 1, 3))[:, 0]
    newest = torch.where((head > 0)[:, None], prev,
                         torch.where(cs.hist_wrapped[:, None],
                                     hist[:, POS_HISTORY_MAX - 1], 0.0))
    have = torch.sum(newest * newest, dim=-1) > 0
    fell = have & (torch.abs(pos[:, 1] - newest[:, 1]) >= limbo_height)
    at_head = torch.gather(hist, 1, head[:, None, None].expand(-1, 1, 3))[:, 0]
    oldest = torch.where(cs.hist_wrapped[:, None], at_head, hist[:, 0])
    new_pos = torch.where(fell[:, None], oldest, pos)
    new_cs = cs._replace(
        hist_head=torch.where(fell, 0, cs.hist_head).to(torch.int32),
        hist_wrapped=cs.hist_wrapped & ~fell,
    )
    return new_pos, new_cs, fell
