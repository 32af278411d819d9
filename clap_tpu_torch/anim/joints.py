"""Joint hierarchy propagation + skinning matrices (counterpart of
clap_tpu/anim/joints.py; reference: model.c:1352-1404).

The reference recursively walks the joint tree computing
``global = parent_global · T·R·S`` and ``joint_transform = global ·
inverse_bind`` (one_joint_transform). The host precomputes topological
LEVELS; each level is one batched gather + matmul, so a pose costs
depth-many steps of wide work. The parent and node selects are plain
indexing (the JAX package writes them as one-hot HIGHEST matmuls for the
TPU).

JOINTS_MAX mirrors shader_constants.h:6 (200).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device
from .clips import Pose

JOINTS_MAX = 200


class Skeleton(NamedTuple):
    parent: torch.Tensor     # (J,) int32, -1 for roots
    invbind: torch.Tensor    # (J, 4, 4) inverse bind matrices
    base: Pose               # rest pose (node TRS from glTF)
    levels: torch.Tensor     # (D, W) int32 node ids per level, -1 padding


def build_skeleton(parent, invbind, base_trans, base_rot, base_scale,
                   device=None) -> Skeleton:
    """Host-side: compute levels from the parent array."""
    device = resolve_device(device)
    parent = np.asarray(parent, np.int32)
    J = len(parent)
    depth = np.zeros(J, np.int32)
    for i in range(J):
        depth[i] = 0 if parent[i] < 0 else depth[parent[i]] + 1
    D = int(depth.max()) + 1 if J else 1
    W = max(int(np.max(np.bincount(depth))), 1) if J else 1
    levels = np.full((D, W), -1, np.int32)
    for d in range(D):
        nodes = np.nonzero(depth == d)[0]
        levels[d, : len(nodes)] = nodes

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Skeleton(
        parent=torch.as_tensor(parent, device=device), invbind=f32(invbind),
        base=Pose(trans=f32(base_trans), rot=f32(base_rot),
                  scale=f32(base_scale)),
        levels=torch.as_tensor(levels, device=device))


def local_matrices(pose: Pose) -> torch.Tensor:
    """(..., J, 4, 4) local T·R·S per joint (model.c:1369-1383)."""
    return mx.mat4_compose_trs(pose.trans, pose.rot, pose.scale)


def global_matrices(sk: Skeleton, local: torch.Tensor) -> torch.Tensor:
    """Propagate the hierarchy level by level over (..., J, 4, 4).

    Each level's nodes take ``glob[parent] @ local[node]``. Padding slots
    (-1) point at node 0, a root, and write back its own matrix."""
    glob = local                      # roots are already correct
    for d in range(1, sk.levels.shape[0]):
        nodes = sk.levels[d]
        ok = (nodes >= 0)[:, None, None]
        n = torch.clamp(nodes, min=0).long()
        p = torch.clamp(sk.parent[n], min=0).long()
        upd = glob[..., p, :, :] @ local[..., n, :, :]
        glob = glob.index_copy(-3, n, torch.where(ok, upd, glob[..., n, :, :]))
    return glob


def joint_matrices(sk: Skeleton, pose: Pose) -> torch.Tensor:
    """(..., J, 4, 4) skinning matrices: global · inverse_bind
    (model.c:1397-1403)."""
    return global_matrices(sk, local_matrices(pose)) @ sk.invbind
