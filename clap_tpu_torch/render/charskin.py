"""Skinned characters in the frame's record streams (counterpart of
clap_tpu/render/charskin.py; reference: model.vert:34-48, the 4-bone LBS
vertex shader; model.c:1020-1025 uploads the joint transforms).

Skinned vertices differ per env (each env's rig is at its own clip time),
so they enter the frame as a per-env range. The char mesh is corner-expanded
once, on the host, into the row layouts the record builders consume:

  - main range: corner-major rows over the cluster-padded LOD 0 faces (the
    layout of SceneGeometry.comp, clip_near_records' components mode);
  - shadow range: record-order rows (v0, v2, v1) over the char's coarsest
    LOD faces (the layout of the dynamic shadow corner stream).

Per frame one (R, J) @ (J, 12·B·C) matrix product blends every corner row
for every (env, char) instance, and the clip and world transforms apply
column by column. The skinned clip components are concatenated onto the
cluster-record stream (the chars' rigid clusters masked off by a mask built
here, once), and the skinned world shadow corners overwrite the chars' rows
of the shadow corner stream.

Normals: LBS rotates rest normals into char-local space; the kernel-attrs
shade stage rotates per-pixel model-local normals by the char entity's
world rotation, so they pass through unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .raster import CLUSTER


class CharSkin(NamedTuple):
    """Static skinning tables of one skinned model shared by every
    character rig (build_char_skin)."""

    # corner rows: main corner-major (3·Tp), then shadow record-order
    # (3·Ts); one LBS product covers both
    pos: torch.Tensor        # (R, 3) rest positions
    nrm: torch.Tensor        # (R, 3) rest normals
    blend: torch.Tensor      # (R, J) dense LBS blend matrix
    n_main: int              # Tp: cluster-padded main faces
    n_shadow: int            # Ts: coarsest-LOD shadow faces
    pad_mask: torch.Tensor   # (Tp,) bool, the degenerate pad faces
    char_ents: torch.Tensor  # (C,) int32 entity slot per char rig
    # host bookkeeping against the rigid tables being replaced
    sh_face_row0: tuple      # (C,) first row of each char in rt.shadow_faces
    vert_row0: tuple         # (C,) first row of each char in rt.verts
    n_verts: int             # V: model verts per char instance
    # vertex-level tables (the member-granularity path)
    vpos: torch.Tensor       # (V, 3)
    vnrm: torch.Tensor       # (V, 3)
    vblend: torch.Tensor     # (V, J)
    cl_skinned: torch.Tensor  # (Tc,) bool: rt's clusters of char entities


def linear_joint_weights(verts: np.ndarray, joint_y: np.ndarray,
                         k: int = 4):
    """Smooth 1-D weight painting for column-like rigs: hat functions at
    each joint's rest height, normalised (the asset-less stand-in for glTF
    JOINTS_0/WEIGHTS_0). Returns (weights (V, k), jidx (V, k) int32)."""
    y = np.asarray(verts, np.float32)[:, 1]
    jy = np.asarray(joint_y, np.float32)
    J = len(jy)
    span = np.diff(jy).mean() if J > 1 else 1.0
    d = np.abs(y[:, None] - jy[None, :]) / max(span, 1e-6)
    w = np.clip(1.0 - d, 0.0, None) ** 1.5
    # ends extend: below joint 0 / above the last joint bind rigidly
    w[:, 0] = np.where(y <= jy[0], 1.0, w[:, 0])
    w[:, -1] = np.where(y >= jy[-1], 1.0, w[:, -1])
    order = np.argsort(-w, axis=1)[:, :k]
    wk = np.take_along_axis(w, order, axis=1)
    wk = wk / np.maximum(wk.sum(1, keepdims=True), 1e-8)
    pad = k - order.shape[1]
    if pad > 0:
        order = np.pad(order, ((0, 0), (0, pad)))
        wk = np.pad(wk, ((0, 0), (0, pad)))
    return wk.astype(np.float32), order.astype(np.int32)


def build_char_skin(rt, model, weights, jidx, n_joints: int,
                    char_entities, device=None) -> CharSkin:
    """Host build on ``device``. ``model`` is the ModelData instance the
    char entities carry in ``build_render_tables`` (same vertex order);
    ``weights``/``jidx`` its per-vertex 4-bone LBS data; ``char_entities``
    the entity slot of each rig, in the joint_mats C order."""
    from ..anim.skin import blend_matrix

    device = resolve_device(device)
    ce = np.asarray(char_entities, np.int64)
    v = np.asarray(model.verts, np.float32)
    n = np.asarray(model.normals, np.float32)
    V = v.shape[0]
    f = np.asarray(model.lod_faces[0], np.int64).reshape(-1, 3)
    # cluster-pad with degenerate (v0, v0, v0) faces (zero area; valid
    # masks them too)
    padn = (-len(f)) % CLUSTER
    fp = np.concatenate([f, np.zeros((padn, 3), np.int64)])
    Tp = len(fp)
    pad_mask = np.arange(Tp) >= len(f)
    main_idx = fp.T.reshape(-1)                  # [all v0 | all v1 | all v2]
    # shadow rows: record order (v0, v2, v1) over the coarsest LOD, the
    # rows build_render_tables emitted for the chars
    fs = np.asarray(model.lod_faces[-1], np.int64).reshape(-1, 3)
    sh_idx = fs[:, [0, 2, 1]].reshape(-1)
    rows = np.concatenate([main_idx, sh_idx])
    W = blend_matrix(torch.as_tensor(np.asarray(weights, np.float32)),
                     torch.as_tensor(np.asarray(jidx, np.int64)),
                     n_joints).numpy()

    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    # rows of each char in the rigid tables (contiguous per entity by
    # build_render_tables' append order)
    ve, sfe = host(rt.vert_entity), host(rt.shadow_face_entity)
    vert_row0, sh_row0 = [], []
    for e in ce:
        vr = np.nonzero(ve == e)[0]
        if len(vr) != V:
            raise ValueError(
                f"entity {e}: {len(vr)} instance verts != model V={V}; pass "
                "the ModelData used in build_render_tables")
        vert_row0.append(int(vr[0]))
        sr = np.nonzero(sfe == e)[0]
        if len(sr) != len(fs):
            raise ValueError(
                f"entity {e}: {len(sr)} shadow stream rows != coarsest LOD "
                f"{len(fs)}; is the char a static shadow caster?")
        sh_row0.append(int(sr[0]))
    cl_skinned = np.isin(host(rt.cl_entity), ce) if rt.cl_entity is not None \
        else np.zeros(0, bool)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return CharSkin(
        pos=t(v[rows]), nrm=t(n[rows]), blend=t(W[rows]),
        n_main=Tp, n_shadow=len(fs), pad_mask=t(pad_mask),
        char_ents=t(ce.astype(np.int32)),
        sh_face_row0=tuple(sh_row0), vert_row0=tuple(vert_row0), n_verts=V,
        vpos=t(v), vnrm=t(n), vblend=t(W), cl_skinned=t(cl_skinned))


def _lbs_columns(cs: CharSkin, joint_mats):
    """One blend for every corner row × (env, char) instance.

    joint_mats: (B, C, J, 4, 4) char-local skinning matrices. Returns (s,
    sn): lists of three (R, B, C) component tensors, the LBS positions and
    normals. The product is a plain matrix product; run it with TF32 off
    (the JAX package runs it at Precision.HIGHEST)."""
    B, C, J = joint_mats.shape[:3]
    BC = B * C
    # (B, C, J, 12) → (J, 12, B·C): component-major columns
    pT = joint_mats[:, :, :, :3, :].reshape(B, C, J, 12) \
        .permute(2, 3, 0, 1).reshape(J, 12 * BC)
    bl = cs.blend @ pT                                       # (R, 12·BC)
    R = bl.shape[0]

    def comp(k):
        return bl[:, k * BC:(k + 1) * BC].reshape(R, B, C)

    px, py, pz = (cs.pos[:, i, None, None] for i in range(3))
    nx, ny, nz = (cs.nrm[:, i, None, None] for i in range(3))
    s = [comp(4 * i) * px + comp(4 * i + 1) * py + comp(4 * i + 2) * pz
         + comp(4 * i + 3) for i in range(3)]
    sn = [comp(4 * i) * nx + comp(4 * i + 1) * ny + comp(4 * i + 2) * nz
          for i in range(3)]
    return s, sn


def skin_records(cs: CharSkin, joint_mats, entity_mx, views, proj,
                 entity_visible):
    """The per-frame skinned ranges of the cluster-record path.

    Returns (comp (B, 21, C·Tp), valid (B, C·Tp), ent (B, C·Tp) int32,
    sh_world (B, C, 3·Ts, 3))."""
    B, C = joint_mats.shape[:2]
    Tp = cs.n_main
    s, sn = _lbs_columns(cs, joint_mats)
    ents = cs.char_ents.long()
    emx = entity_mx[:, ents]                                  # (B, C, 4, 4)
    G = (proj @ views)[:, None] @ emx                         # (B, C, 4, 4)

    sm = [c[:3 * Tp] for c in s]
    snm = [c[:3 * Tp] for c in sn]
    # clip rows j over the main corner rows: (3Tp, B, C)
    clip = [G[None, :, :, j, 0] * sm[0] + G[None, :, :, j, 1] * sm[1]
            + G[None, :, :, j, 2] * sm[2] + G[None, :, :, j, 3]
            for j in range(4)]

    def col(a, corner):
        # (3Tp, B, C) corner-major → one corner → (B, C·Tp)
        return a[corner * Tp:(corner + 1) * Tp].permute(1, 2, 0) \
            .reshape(B, C * Tp)

    comp = torch.stack(
        [col(src, c) for c in range(3)
         for src in (clip[0], clip[1], clip[2], clip[3],
                     snm[0], snm[1], snm[2])], dim=1)         # (B, 21, C·Tp)
    vis = entity_visible[:, ents]                             # (B, C)
    valid = (vis[:, :, None] & ~cs.pad_mask[None, None, :]).reshape(B, C * Tp)
    ent = cs.char_ents.repeat_interleave(Tp)[None].expand(B, C * Tp)

    # shadow rows: the char's world transform only, (3Ts, B, C) each
    ss = [c[3 * Tp:] for c in s]
    M = emx[:, :, :3, :]
    wsh = [M[None, :, :, i, 0] * ss[0] + M[None, :, :, i, 1] * ss[1]
           + M[None, :, :, i, 2] * ss[2] + M[None, :, :, i, 3]
           for i in range(3)]
    sh_world = torch.stack([w.permute(1, 2, 0) for w in wsh], dim=-1)
    return comp, valid, ent, sh_world


def apply_shadow_skin(shadow_corner_verts, cs: CharSkin, sh_world):
    """A copy of the per-env world shadow corner stream (B, 3·Ts', 3) with
    each char's rows replaced by its skinned corners (the rigid transform
    put rest-pose rows there)."""
    out = shadow_corner_verts.clone()
    n = 3 * cs.n_shadow
    for c, f0 in enumerate(cs.sh_face_row0):
        out[:, 3 * f0:3 * f0 + n] = sh_world[:, c]
    return out


def skin_vertex_rows(cs: CharSkin, joint_mats, entity_mx):
    """Skinned world vertex rows for the member-granularity path (each
    char's instance-vertex block is replaced). joint_mats (C, J, 4, 4) for
    one env or (B, C, J, 4, 4). Returns world positions ((B,) C, V, 3) and
    char-local normals ((B,) C, V, 3)."""
    from ..anim.skin import skin_verts_batch

    single = joint_mats.dim() == 4
    jm = joint_mats[None] if single else joint_mats
    B, C = jm.shape[:2]
    sv, snl = skin_verts_batch(jm.reshape(B * C, *jm.shape[2:]), cs.vpos,
                               cs.vnrm, None, None, blend=cs.vblend)
    sv = sv.reshape(B, C, cs.n_verts, 3)
    snl = snl.reshape(B, C, cs.n_verts, 3)
    emx = (entity_mx[None] if single else entity_mx)[:, cs.char_ents.long()]
    w = sv @ emx[:, :, :3, :3].transpose(-1, -2) + emx[:, :, None, :3, 3]
    if single:
        return w[0], snl[0]
    return w, snl
