"""3rd-person orbit camera with occlusion shrink (counterpart of
clap_tpu/render/camera.py; reference: core/camera.{c,h}).

Batched over envs: target (B, 3), pitch/yaw/dist (B,), or with more
leading axes after the env axis (the camera bank's (B, NC)). Occlusion casts
rays from the target to the 4 near-plane corners of the candidate camera
and shrinks the orbit distance by the smallest hit fraction, a fixed
OCCLUSION_ITERS times (camera.c:93-117, 232-236).
"""
from __future__ import annotations

import math

import torch

from .. import mathx as mx
from ..physics.narrowphase import StaticWorld, raycast

PITCH_CLAMP = 1.45
OCCLUSION_ITERS = 3


def _f32(x, device):
    return mx.const(x, device)


def camera_target(char_pos, char_height, head_pos=None, has_head=False):
    """camera_target (camera.c:174-206): the head joint where the rig has
    one, else ¾ of the character's height above its origin."""
    default = char_pos + _f32([0.0, 1.0, 0.0], char_pos.device) \
        * (char_height * 0.75)
    if head_pos is None:
        return default
    if not isinstance(has_head, torch.Tensor):
        return head_pos if has_head else default
    return torch.where(has_head, head_pos, default)


def orbit_quat(pitch, yaw):
    """Orbit rotation q = R_y(yaw) · R_x(pitch), (B,) → (B, 4)."""
    dev = pitch.device
    return mx.qmul(
        mx.quat_from_axis_angle(_f32([0.0, 1.0, 0.0], dev), yaw),
        mx.quat_from_axis_angle(_f32([1.0, 0.0, 0.0], dev), pitch))


def _near_corners(eye, target, dist, fovy, aspect, near=0.3):
    """4 near-plane corner points (..., 4, 3) of a camera at ``eye`` looking
    at ``target`` (camera_calc_rays camera.c:60-92)."""
    dev = eye.device
    fwd = mx.normalize(target - eye)
    right = mx.normalize(mx.cross(fwd, _f32([0.0, 1.0, 0.0], dev)))
    up = mx.cross(right, fwd)
    h = torch.tan(_f32(fovy, dev) / 2) * near
    w = h * _f32(aspect, dev)
    base = eye + fwd * near
    cs = []
    for sx in (1.0, -1.0):
        for sy in (1.0, -1.0):
            cs.append(base + right * (sx * w) + up * (sy * h))
    return torch.stack(cs, dim=-2)


def camera_update(world: StaticWorld, target, pitch, yaw, want_dist,
                  fovy=math.pi / 3, aspect=16 / 9):
    """Orbit + occlusion shrink. Returns (eye (..., 3), rot_q (..., 4),
    dist (...)) for target (..., 3) and pitch / yaw / want_dist (...)."""
    pitch = torch.clamp(pitch, -PITCH_CLAMP, PITCH_CLAMP)
    q = orbit_quat(pitch, yaw)
    dist = want_dist
    for _ in range(OCCLUSION_ITERS):
        eye = mx.transform_orbit(q, target, dist)
        corners = _near_corners(eye, target, dist, fovy, aspect)  # (.,4,3)
        d = corners - target[..., None, :]
        ln = torch.sqrt(torch.sum(d * d, dim=-1))
        lc = torch.clamp(ln, min=1e-6)
        hit_dist, hit = raycast(world, target[..., None, :].expand_as(d),
                                d / lc[..., None], ln, n_march=8)
        fracs = torch.where(hit, hit_dist / lc, 1.0)
        scale = torch.amin(fracs, dim=-1)
        dist = torch.where(scale < 0.99, dist * scale, dist)
    dist = torch.clamp(dist, min=0.5)
    eye = mx.transform_orbit(q, target, dist)
    return eye, q, dist


def camera_view_proj(eye, rot_q, fovy, aspect, near=0.1, far=200.0):
    """View matrix per transform_view_mat4x4 + GL projection
    (scene_cameras_calc, scene.c:1004-1048)."""
    view = mx.transform_view_mat4(eye, rot_q)
    proj = mx.mat4_perspective(fovy, aspect, near, far, device=eye.device)
    return view, proj
