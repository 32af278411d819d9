"""Animation clip sampling (counterpart of clap_tpu/anim/clips.py;
reference: model.c:1266-1342).

The reference walks channel keyframes with a cached start index
(channel_time_to_idx model.c:1266-1288), lerps translation/scale and
slerps rotation (channel_transform model.c:1290-1342); playback is always
lerp/slerp (SURVEY §2.11).

Clips live in one padded AnimLibrary. Sampling is batched over any
leading axes of ``clip_id`` / ``t``: a clip-row gather, a vectorized
searchsorted over the (C, T) keyframe tables, keyframe fetches by plain
indexing, and a scatter-add of the channels into per-joint TRS arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device

PATH_TRANSLATION = 0
PATH_ROTATION = 1
PATH_SCALE = 2


class AnimLibrary(NamedTuple):
    """All clips of a model, padded to (L clips, C channels, T keyframes)."""

    times: torch.Tensor      # (L, C, T) f32, +inf padding past each end
    values: torch.Tensor     # (L, C, T, 4) f32 (w unused for trans/scale)
    ch_joint: torch.Tensor   # (L, C) int32
    ch_path: torch.Tensor    # (L, C) int32 PATH_*
    ch_valid: torch.Tensor   # (L, C) bool
    duration: torch.Tensor   # (L,) f32


class Pose(NamedTuple):
    trans: torch.Tensor      # (..., J, 3)
    rot: torch.Tensor        # (..., J, 4)
    scale: torch.Tensor      # (..., J, 3)


def build_library(clips, n_joints: int, device=None) -> AnimLibrary:
    """Host-side packing. ``clips`` is a list of channel lists; each
    channel is (joint:int, path:int, times:(T_i,), values:(T_i, D))."""
    device = resolve_device(device)
    L = len(clips)
    C = max((len(ch) for ch in clips), default=1) or 1
    T = max((len(c[2]) for ch in clips for c in ch), default=2)
    T = max(T, 2)
    times = np.full((L, C, T), np.inf, np.float32)
    values = np.zeros((L, C, T, 4), np.float32)
    ch_joint = np.zeros((L, C), np.int32)
    ch_path = np.zeros((L, C), np.int32)
    ch_valid = np.zeros((L, C), bool)
    duration = np.zeros((L,), np.float32)
    for li, ch_list in enumerate(clips):
        for ci, (joint, path, ts, vs) in enumerate(ch_list):
            t = np.asarray(ts, np.float32)
            v = np.asarray(vs, np.float32)
            n = len(t)
            times[li, ci, :n] = t
            # pad by repeating the last keyframe (clamped sampling)
            values[li, ci, :n, : v.shape[1]] = v
            values[li, ci, n:, : v.shape[1]] = v[-1]
            ch_joint[li, ci] = joint
            ch_path[li, ci] = path
            ch_valid[li, ci] = True
            duration[li] = max(duration[li], float(t[-1]))
    return AnimLibrary(*(torch.as_tensor(a, device=device) for a in (
        times, values, ch_joint, ch_path, ch_valid, duration)))


def sample_channels(times, values, t):
    """Keyframe sampling of (..., C, T) channel tables at times t (...).
    Returns the (..., C, 4) keyframes around t and the (..., C)
    interpolation factor; rotation slerp is the caller's.

    Matches channel_time_to_idx (model.c:1266-1288): k = last index with
    times[k] <= t, clamped to [0, T-2]; the factor is clamped to [0, 1]
    (model.c:1303-1307)."""
    t = torch.as_tensor(t, dtype=times.dtype, device=times.device)
    k = (times <= t[..., None, None]).sum(-1) - 1
    k = torch.clamp(k, 0, times.shape[-1] - 2)[..., None]     # (..., C, 1)
    fin = torch.isfinite(times)
    t0 = torch.gather(torch.where(fin, times, 0.0), -1, k)[..., 0]
    t1 = torch.gather(torch.where(fin, times, 0.0), -1, k + 1)[..., 0]
    t1_inf = ~torch.gather(fin, -1, k + 1)[..., 0]
    t1 = torch.where(t1_inf, t0 + 1.0, t1)
    u = torch.clamp((t[..., None] - t0) / torch.clamp(t1 - t0, min=1e-9),
                    0.0, 1.0)
    kv = k[..., None].expand(*k.shape[:-1], 1, values.shape[-1])
    v0 = torch.gather(values, -2, kv)[..., 0, :]
    v1 = torch.gather(values, -2, kv + 1)[..., 0, :]
    return v0, v1, u


def sample_pose(lib: AnimLibrary, base: Pose, clip_id, t) -> Pose:
    """Sample clip ``clip_id`` at time ``t`` (both (...,)) into full joint
    poses (..., J, ·); channels override the base (rest) pose."""
    clip_id = torch.as_tensor(clip_id, device=lib.times.device).long()
    times = lib.times[clip_id]       # (..., C, T)
    values = lib.values[clip_id]     # (..., C, T, 4)
    joint = lib.ch_joint[clip_id].long()
    path = lib.ch_path[clip_id]
    valid = lib.ch_valid[clip_id]

    v0, v1, u = sample_channels(times, values, t)
    lerped = v0 + (v1 - v0) * u[..., None]            # (..., C, 4)
    slerped = mx.qslerp(v0, v1, u[..., None])

    def scatter(base_arr, vals, path_id, d):
        m = (valid & (path == path_id))[..., None]          # (..., C, 1)
        # a masked channel adds nothing: padding channels slerp zero
        # quaternions into NaN, which must not reach any joint
        src = torch.where(m, vals[..., :d], 0.0)
        lead = m.shape[:-2]
        J = base_arr.shape[-2]
        out = torch.zeros((*lead, J, d), dtype=vals.dtype,
                          device=vals.device).scatter_add(
            -2, joint[..., None].expand(*joint.shape, d), src)
        covered = torch.zeros((*lead, J, 1), dtype=vals.dtype,
                              device=vals.device).scatter_add(
            -2, joint[..., None], m.to(vals.dtype))
        covered = torch.clamp(covered, 0.0, 1.0)
        return base_arr * (1 - covered) + out

    trans = scatter(base.trans, lerped, PATH_TRANSLATION, 3)
    scale = scatter(base.scale, lerped, PATH_SCALE, 3)
    rot = scatter(base.rot, slerped, PATH_ROTATION, 4)
    # renormalize (base/override mixing may leave eps drift)
    rot = rot / torch.clamp(torch.linalg.vector_norm(rot, dim=-1,
                                                     keepdim=True), min=1e-9)
    return Pose(trans=trans, rot=rot, scale=scale)
