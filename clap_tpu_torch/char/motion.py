"""Motion controller (counterpart of clap_tpu/char/motion.py; reference:
core/motion.{c,h}).

Input sticks → camera-relative normalized XZ motion vector
(motion_compute, motion.c:115-120). Plain torch; broadcasts over any
leading env axes. Numbers and bools become float32 tensors on ``device``
(default the device of the first tensor argument, else
``resolve_device(None)``: the card).
"""
from __future__ import annotations

import math

import torch

from .. import mathx as mx
from ..device import resolve_device


def _device(args, device):
    if device is not None:
        return torch.device(device)
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _f32(x, device):
    return torch.as_tensor(x, device=device).to(torch.float32)


def motion_compute_ls(left, right, up, down, delta_lx=0.0, delta_ly=0.0,
                      device=None):
    """Digital + analog left-stick merge (motion.c:64-80): diagonal
    movement normalized by cos/sin(π/4)."""
    dev = _device((left, right, up, down, delta_lx, delta_ly), device)
    dx = _f32(right, dev) - _f32(left, dev)
    dy = _f32(down, dev) - _f32(up, dev)
    both = (torch.abs(dx) > 0) & (torch.abs(dy) > 0)
    inv = _f32(math.cos(math.pi / 4), dev)
    dx = torch.where(both, dx * inv, dx)
    dy = torch.where(both, dy * inv, dy)
    lx, ly = _f32(delta_lx, dev), _f32(delta_ly, dev)
    analog = (torch.abs(lx) > 0) | (torch.abs(ly) > 0)
    ang = torch.atan2(ly, lx)
    dx = torch.where(analog & (dx == 0), torch.cos(ang), dx)
    dy = torch.where(analog & (dy == 0), torch.sin(ang), dy)
    return dx, dy


def motion_get(ls_dx, ls_dy, cam_rot_q, lin_speed):
    """motion_get (motion.c:91-113): rotate the stick vector by the
    camera orientation, project to XZ, renormalize, scale."""
    lin_speed = _f32(lin_speed, ls_dx.device)
    d = torch.stack([ls_dx * lin_speed, torch.zeros_like(ls_dx),
                     ls_dy * lin_speed], dim=-1)
    small = torch.sum(d * d, -1) < 1e-5
    r = mx.qrot(cam_rot_q, d)
    d2 = torch.stack([r[..., 0], r[..., 2]], -1)
    n2 = torch.sum(d2 * d2, -1, keepdim=True)
    d2 = torch.where(n2 > 0, d2 / torch.sqrt(torch.clamp(n2, min=1e-12))
                     * lin_speed[..., None], 0.0)
    dx = torch.where(small, 0.0, d2[..., 0])
    dz = torch.where(small, 0.0, d2[..., 1])
    return dx, dz


def camera_yaw_quat(yaw, device=None):
    """The camera's yaw rotation about +y, (...) → (..., 4)."""
    yaw = _f32(yaw, _device((yaw,), device))
    return mx.quat_from_axis_angle(mx.const([0.0, 1.0, 0.0], yaw.device),
                                   yaw)
