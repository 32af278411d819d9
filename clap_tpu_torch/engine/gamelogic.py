"""Gameplay rules engine (counterpart of clap_tpu/engine/gamelogic.py;
reference: demo/ldjam57/main.c + the connect/disconnect hook mechanism,
character.c:490-496).

The reference wires C callbacks: stepping on a switch entity "connects"
it (toggling its platform group visible + repositioned), leaving a
non-permanent switch parks its platforms 100 units up and strips VISIBLE
(switch_connect/disconnect, platform_entity_update main.c:82-138).
Character roster switching connects characters by proximity and cycles
through connected ones (main.c:140-245, scene_control_next scene.c:23-55).

Here the callbacks become data: a GameConfig of switch/platform tables
and ``game_update`` applying the same rules as masked tensor ops over a
leading env axis B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx
from ..device import resolve_device

PLATFORM_PARK_Y = 100.0     # main.c:96-138: hidden platforms park +100 up
GAME_OVER_Y = -130.0        # main.c:182-243
CAMERA_SPIN_Y = -450.0


class GameConfig(NamedTuple):
    """Static gameplay wiring, shared by every env."""

    # switches (K slots)
    switch_entity: torch.Tensor     # (K,) int32 entity id of each switch
    switch_permanent: torch.Tensor  # (K,) bool: stays on once triggered
    switch_group: torch.Tensor      # (K,) int32 platform group it controls
    switch_valid: torch.Tensor      # (K,) bool
    # platforms (E entities)
    platform_group: torch.Tensor    # (E,) int32 group id, -1 = not a platform
    platform_on_pos: torch.Tensor   # (E, 3) position when active
    # roster
    connect_radius: torch.Tensor    # () f32 proximity to connect characters


class GameState(NamedTuple):
    """Per env (leading axis B inside game_update)."""

    switch_on: torch.Tensor         # (K,) bool
    prev_ground: torch.Tensor       # () int32 last ground entity id
    control: torch.Tensor           # () int32 controlled character slot
    connected: torch.Tensor         # (C,) bool roster connectivity
    game_over: torch.Tensor         # () bool


def game_config_empty(n_switches: int, n_entities: int,
                      device=None) -> GameConfig:
    device = resolve_device(device)
    i32 = dict(dtype=torch.int32, device=device)
    bl = dict(dtype=torch.bool, device=device)
    return GameConfig(
        switch_entity=torch.zeros((n_switches,), **i32),
        switch_permanent=torch.zeros((n_switches,), **bl),
        switch_group=torch.zeros((n_switches,), **i32),
        switch_valid=torch.zeros((n_switches,), **bl),
        platform_group=torch.full((n_entities,), -1, **i32),
        platform_on_pos=torch.zeros((n_entities, 3), dtype=torch.float32,
                                    device=device),
        connect_radius=torch.tensor(3.0, device=device))


def game_state_init(n_switches: int, n_chars: int, device=None) -> GameState:
    """Unbatched initial state (replicate it over envs)."""
    device = resolve_device(device)
    connected = torch.zeros((n_chars,), dtype=torch.bool, device=device)
    connected[0] = True
    return GameState(
        switch_on=torch.zeros((n_switches,), dtype=torch.bool, device=device),
        prev_ground=torch.tensor(-1, dtype=torch.int32, device=device),
        control=torch.tensor(0, dtype=torch.int32, device=device),
        connected=connected,
        game_over=torch.tensor(False, device=device))


def game_update(gcfg: GameConfig, gs: GameState, ground_entity,
                char_positions, char_y, next_input):
    """One gameplay tick for every env.

    ground_entity: (B,) int32 entity the controlled character stands on
    (-1 airborne) — the connect/disconnect source (character.c:490-496).
    char_positions: (B, C, 3) character entity positions (roster
    proximity). char_y: (B,) controlled character height (game-over
    check). next_input: (B,) bool — cycle to the next connected character
    (Tab, character_obj_next main.c:140-151).

    Returns (new GameState, entity_visible_override (B, E) bool,
    entity_pos_override (B, E, 3)) for the platform entities.
    """
    changed = ground_entity != gs.prev_ground                      # (B,)

    # connect: new ground is a switch → on (permanent ones latch);
    # disconnect: old ground was a non-permanent switch → off
    is_new = gcfg.switch_valid \
        & (gcfg.switch_entity == ground_entity[:, None]) & changed[:, None]
    is_old = gcfg.switch_valid \
        & (gcfg.switch_entity == gs.prev_ground[:, None]) \
        & changed[:, None] & ~gcfg.switch_permanent
    switch_on = (gs.switch_on | is_new) & ~is_old                  # (B, K)

    # platform group states: group g active iff any controlling switch on
    n_groups = gcfg.platform_group.shape[0]  # group ids < E by construction
    groups = torch.arange(n_groups, device=switch_on.device)
    ctl = gcfg.switch_group[None, :] == groups[:, None]            # (G, K)
    group_on = ((switch_on & gcfg.switch_valid)[:, None, :]
                & ctl[None]).any(-1)                               # (B, G)

    is_platform = gcfg.platform_group >= 0                         # (E,)
    plat_on = is_platform \
        & group_on[:, torch.clamp(gcfg.platform_group, min=0).long()]
    vis_override = torch.where(is_platform, plat_on, True)
    park = mx.const([0.0, PLATFORM_PARK_Y, 0.0], gcfg.platform_on_pos.device)
    pos_override = torch.where((is_platform & ~plat_on)[..., None],
                               gcfg.platform_on_pos + park,
                               gcfg.platform_on_pos)

    # roster connectivity: proximity to the controlled character
    # (character_obj_update main.c:185-245)
    B, n_chars = char_positions.shape[:2]
    env = torch.arange(B, device=char_positions.device)
    ctrl = gs.control.long()
    ctrl_pos = char_positions[env, ctrl]                           # (B, 3)
    d = torch.linalg.vector_norm(char_positions - ctrl_pos[:, None], dim=-1)
    slots = torch.arange(n_chars, device=char_positions.device)
    connected = gs.connected | (d < gcfg.connect_radius) \
        | (slots[None, :] == ctrl[:, None])

    # cycle control to the next connected character
    order = (ctrl[:, None] + 1 + slots[None, :]) % n_chars         # (B, C)
    conn_in_order = torch.gather(connected, 1, order)
    first = torch.argmax(conn_in_order.to(torch.int32), dim=1,
                         keepdim=True)
    nxt = torch.gather(order, 1, first)[:, 0]
    control = torch.where(next_input & conn_in_order.any(-1), nxt, ctrl)

    game_over = gs.game_over | (char_y < GAME_OVER_Y)

    return GameState(
        switch_on=switch_on,
        prev_ground=torch.where(changed, ground_entity,
                                gs.prev_ground).to(torch.int32),
        control=control.to(torch.int32),
        connected=connected,
        game_over=game_over,
    ), vis_override, pos_override
