"""Linear-blend skinning (counterpart of clap_tpu/anim/skin.py; reference:
model.vert:34-48, 4-bone LBS).

``skinned = Σᵢ wᵢ · JT[jᵢ] · v`` for position, rotation part only for
normals. The 4 bone weights scatter into a dense (V, J) blend matrix once
(it depends only on the static rig), and the per-vertex matrices come from
one matrix product ``W @ packed`` (the JAX package leaves that product to
XLA too; here it is ``torch.matmul``).
"""
from __future__ import annotations

import torch


def pack_joint_mats(jt: torch.Tensor) -> torch.Tensor:
    """(..., J, 4, 4) → (..., J, 12): rows of the top 3×4 block."""
    return jt[..., :3, :].reshape(*jt.shape[:-2], 12)


def blend_matrix(weights, jidx, n_joints: int, dtype=torch.float32):
    """(V, 4) weights + (V, 4) joint ids → dense (V, J) LBS blend matrix
    (shared across all instances of a rig)."""
    out = torch.zeros((weights.shape[0], n_joints), dtype=dtype,
                      device=weights.device)
    return out.scatter_add(1, jidx.long(), weights.to(dtype))


def skin_verts(jt: torch.Tensor, verts, normals, weights, jidx):
    """Apply LBS.

    jt: (J, 4, 4) skinning matrices; verts/normals: (V, 3);
    weights: (V, 4); jidx: (V, 4) int32.
    Returns (skinned_verts (V,3), skinned_normals (V,3))."""
    sv, sn = skin_verts_batch(jt[None], verts, normals, weights, jidx)
    return sv[0], sn[0]


def skin_verts_batch(jts: torch.Tensor, verts, normals, weights, jidx,
                     blend=None):
    """LBS for B instances of ONE rig/mesh: one (V, J) @ (B, J, 12)
    product.

    jts: (B, J, 4, 4); verts/normals: (V, 3); weights/jidx: (V, 4) (or a
    precomputed dense ``blend`` (V, J) matrix instead).
    Returns (sv (B, V, 3), sn (B, V, 3))."""
    W = blend_matrix(weights, jidx, jts.shape[1], verts.dtype) \
        if blend is None else blend
    m = (W @ pack_joint_mats(jts)).reshape(jts.shape[0], -1, 3, 4)

    def rotate(v):
        # per-vertex 3×3 rows as elementwise products: a batched matmul
        # of B·V tiny matrices is far slower on the card
        return m[..., 0] * v[:, None, 0] + m[..., 1] * v[:, None, 1] \
            + m[..., 2] * v[:, None, 2]

    return rotate(verts) + m[..., 3], rotate(normals)
