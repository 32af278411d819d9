"""Input layer (counterpart of clap_tpu/engine/input.py; reference:
core/input*.{c,h,m} — GLFW keyboard, joystick with per-pad bindings,
browser, fuzzer; unified into struct message_input, messagebus.h:33-89).

Host-side: raw key/axis events → an InputRecord (the message_input
analogue) → engine Inputs via binding tables. Replay files and fuzzers
produce the same records, so every input source is interchangeable, like
the reference's MT_INPUT bus.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..char.motion import camera_yaw_quat, motion_compute_ls, motion_get
from ..device import resolve_device
from .step import Inputs


@dataclass
class InputRecord:
    """The relevant subset of struct message_input (messagebus.h:33-89)."""

    left: bool = False
    right: bool = False
    up: bool = False
    down: bool = False
    delta_lx: float = 0.0
    delta_ly: float = 0.0
    pitch_up: bool = False
    pitch_down: bool = False
    yaw_left: bool = False
    yaw_right: bool = False
    delta_rx: float = 0.0
    delta_ry: float = 0.0
    space: bool = False      # jump
    shift: bool = False      # dash (character.c:12-67)
    tab: bool = False        # character switch
    zoom: float = 0.0
    pause: bool = False
    menu_toggle: bool = False
    edit_toggle: bool = False  # scene editor (scene.c:174-304)
    enter: bool = False      # menu activate
    mouse_x: float | None = None   # pointer position (UI hover/click)
    mouse_y: float | None = None
    mouse_click: bool = False


# default keyboard bindings (input-keyboard.c key → record field)
KEY_BINDINGS = {
    "w": "up", "s": "down", "a": "left", "d": "right",
    "up": "pitch_up", "down": "pitch_down",
    "left": "yaw_left", "right": "yaw_right",
    "space": "space", "shift": "shift", "tab": "tab",
    "escape": "menu_toggle", "enter": "enter", "f1": "edit_toggle",
}

# joystick axis/button bindings (input-joystick.c per-pad tables)
PAD_BINDINGS = {
    "axis0": "delta_lx", "axis1": "delta_ly",
    "axis2": "delta_rx", "axis3": "delta_ry",
    "button0": "space", "button4": "tab",
}


def apply_key(rec: InputRecord, key: str, pressed: bool) -> InputRecord:
    f = KEY_BINDINGS.get(key)
    if f:
        setattr(rec, f, pressed)
    return rec


def apply_axis(rec: InputRecord, axis: str, value: float) -> InputRecord:
    f = PAD_BINDINGS.get(axis)
    if f:
        setattr(rec, f, value)
    return rec


def record_to_inputs(rec: InputRecord, cam_yaw, lin_speed=1.0,
                     n_chars: int = 1, device=None) -> Inputs:
    """InputRecord → Inputs on ``device`` (the card unless named): stick
    merge + camera-relative motion (motion_compute, motion.c:115-120) +
    camera deltas. The record drives character slot 0; the Inputs carry
    no env axis (stack or expand them for a batch)."""
    dev = resolve_device(device)
    ls_dx, ls_dy = motion_compute_ls(rec.left, rec.right, rec.up, rec.down,
                                     rec.delta_lx, rec.delta_ly, device=dev)
    q = camera_yaw_quat(cam_yaw, device=dev)
    dx, dz = motion_get(ls_dx, ls_dy, q, lin_speed)
    motion = torch.zeros((n_chars, 2), dtype=torch.float32, device=dev)
    motion[0] = torch.stack([dx, dz])
    jump = torch.zeros((n_chars,), dtype=torch.bool, device=dev)
    jump[0] = bool(rec.space)
    dash = torch.zeros((n_chars,), dtype=torch.bool, device=dev)
    dash[0] = bool(rec.shift)
    pitch_d = (float(rec.pitch_down) - float(rec.pitch_up)) * 0.03 \
        + rec.delta_ry * 0.01
    yaw_d = (float(rec.yaw_right) - float(rec.yaw_left)) * 0.05 \
        + rec.delta_rx * 0.01
    cam = torch.tensor([pitch_d, yaw_d, rec.zoom], dtype=torch.float32,
                       device=dev)
    # dash always populated, as in the JAX package (inputs_zero's layout)
    return Inputs(motion=motion, jump=jump, cam_delta=cam, dash=dash)
