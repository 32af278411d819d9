"""Tile rasterizer (counterpart of clap_tpu/render/raster.py).

1. **Records**: screen-space triangles travel as a columnar (B, C, T)
   record stream — per corner [x, y, z, 1/w] in record-corner order
   (v0, v2, v1), then a float triangle id, then optional extras.
2. **Binning**: triangles bin at CLUSTER (8-triangle) granularity into
   128-px-wide sub-tiles; (tile << 12 | quantized cluster near-z) keys are
   sorted stably per env, so each tile's list is front to back and the
   capacity cap drops the farthest clusters. Clusters whose bbox spans
   more tiles than the span cap go to a shared "big" list.
3. **Kernels**: K1 (``raster_tile``) walks each (env, tile, sub-column)
   list in chunks of coefficient records and keeps the nearest covering
   record per pixel with its float id and three attribute planes; K2
   (``raster_depth``) keeps the minimum depth only. Both read the
   coefficient cluster rows through the binning's id lists (no per-tile
   copy). Both are hand-written CUDA (csrc/raster.cu) on CUDA tensors; on
   CPU tensors the same functions run their plain PyTorch versions
   (``raster_tile_ref`` / ``raster_depth_ref``), which gather each tile's
   records and walk them.

Depth convention: NDC z in [-1, 1], smaller = closer. Background depth =
+inf, tri id = -1. Every batched function takes a leading env axis B.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device

MAX_PER_TILE = 1024
MAX_SPAN_X = 8
MAX_SPAN_Y = 8
MAX_BIG_TRIS = 512

_XC = (0, 4, 8)
_YC = (1, 5, 9)
_ZC = (2, 6, 10)
_WC = (3, 7, 11)

INF = float("inf")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_dims(width: int, height: int) -> tuple:
    """Coarse tile (h, w): 16×256 up to 512 rows, 32×256 above, 8×128 for
    small targets (the JAX package's measured policy)."""
    if width >= 256 and height >= 128:
        return (16, 256) if height <= 512 else (32, 256)
    return 8, 128


def tile_subcols(tile_w: int) -> int:
    """128-px sub-columns walked independently inside one coarse tile."""
    return tile_w // 128 if tile_w >= 256 else 1


def tile_capacity(width: int, height: int) -> int:
    """Default per-tile triangle capacity (3× when the target has few
    tiles)."""
    th, tw = tile_dims(width, height)
    n_tiles = cdiv(width, tw) * cdiv(height, th)
    return MAX_PER_TILE * 3 if n_tiles < 24 else MAX_PER_TILE


class GBuffer(NamedTuple):
    depth: torch.Tensor    # (..., H, W) f32, +inf background
    tri_id: torch.Tensor   # (..., H, W) i32, -1 background
    bary: torch.Tensor     # (..., H, W, 2) perspective-correct b0, b1


def project_to_screen(clip, width: int, height: int):
    """Clip-space (..., V, 4) → screen x/y, ndc z, 1/w (..., V); y flipped
    so pixel (0, 0) is top-left."""
    w = clip[..., 3]
    # sign-preserving clamp keeps w ≈ ±0 vertices on their side
    w_safe = torch.where(torch.abs(w) < 1e-9,
                         torch.where(w < 0, -1e-9, 1e-9), w)
    iw = 1.0 / w_safe
    ndc = clip[..., :3] * iw[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[..., 1] * 0.5) * height
    return sx, sy, ndc[..., 2], iw


ENT_PACK = 128   # default tid packing stride: packed = tid·stride + entity


def ent_pack_stride(n_ent: int) -> int:
    """Smallest power-of-two packing stride covering n_ent entity ids."""
    return max(2, 1 << (int(n_ent) - 1).bit_length())


def _finish_records(cols, valid_mask, two_sided):
    """Stack record columns into (..., C, T), apply the validity tests
    (front-facing area, w > 0 at all corners, z overlapping [-1, 1],
    caller mask) and zero dead records so they are inert on their own."""
    cols = torch.broadcast_tensors(*cols)
    rec = torch.stack(cols, dim=-2)                         # (..., C, T)
    C = len(cols)
    x0, y0 = rec[..., _XC[0], :], rec[..., _YC[0], :]
    x1, y1 = rec[..., _XC[1], :], rec[..., _YC[1], :]
    x2, y2 = rec[..., _XC[2], :], rec[..., _YC[2], :]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    if two_sided:
        # back faces swap corner groups 1↔2 (and their cb pairs)
        perm = np.arange(C)
        perm[4:8], perm[8:12] = np.arange(8, 12), np.arange(4, 8)
        if C > 13:
            perm[15:17], perm[17:19] = np.arange(17, 19), np.arange(15, 17)
        perm = mx.const(perm.tolist(), rec.device, torch.long)
        rec = torch.where((area < 0)[..., None, :], rec[..., perm, :], rec)
        ok = torch.abs(area) > 1e-8
    else:
        ok = area > 1e-8
    w0, w1, w2 = (rec[..., c, :] for c in _WC)
    ok = ok & (w0 > 0) & (w1 > 0) & (w2 > 0) \
        & (torch.maximum(torch.maximum(w0, w1), w2) < 1e8)
    z0, z1, z2 = (rec[..., c, :] for c in _ZC)
    ok = ok & (torch.minimum(torch.minimum(z0, z1), z2) <= 1.0) \
        & (torch.maximum(torch.maximum(z0, z1), z2) >= -1.0)
    if valid_mask is not None:
        ok = ok & valid_mask
    rec = torch.where(ok[..., None, :], rec, 0.0)
    return rec, ok


def corner_records(c0, c1, c2, valid_mask=None, two_sided: bool = False,
                   cb=None):
    """Records from per-corner [x, y, z, 1/w] rows (..., T, 4), corner order
    = face order; cb (..., T, 3, 2) optional original-triangle
    barycentrics per corner."""
    T = c0.shape[-2]
    tri_f = torch.arange(T, dtype=torch.float32, device=c0.device)
    cols = [c0[..., i] for i in range(4)] + [c2[..., i] for i in range(4)] \
        + [c1[..., i] for i in range(4)] + [tri_f]
    if cb is not None:
        cols += [cb[..., 0, 0], cb[..., 0, 1], cb[..., 2, 0], cb[..., 2, 1],
                 cb[..., 1, 0], cb[..., 1, 1]]
    return _finish_records(cols, valid_mask, two_sided)


def expand_corners_record(table, faces, device=None):
    """Static corner expansion of a host vertex table (V, C) in RECORD
    order — rows [3t, 3t+1, 3t+2] = (v0, v2, v1) of face t, the order
    assemble_tri_records gathers — as a tensor on ``device`` (the card
    unless named). Expanding static geometry once turns the per-frame
    3T-row corner gather into a reshape."""
    f = np.asarray(faces)
    return torch.as_tensor(np.asarray(table)[f[:, [0, 2, 1]].reshape(-1)],
                           device=resolve_device(device))


def expand_corners_major(table, faces, device=None):
    """Corner-MAJOR expansion — [all v0 | all v1 | all v2] — the order
    clip_near_records gathers (its per-corner columns are contiguous
    slices of this layout), as a tensor on ``device``."""
    f = np.asarray(faces)
    return torch.as_tensor(np.asarray(table)[f.T.reshape(-1)],
                           device=resolve_device(device))


def assemble_tri_records(sx, sy, z, iw, faces, valid_mask=None,
                         two_sided: bool = False, vextra=None,
                         tid_pack=None, pack_stride: int = ENT_PACK,
                         pre_expanded: bool = False):
    """Record stream (..., 13[+9], T) from projected vertices (..., V)
    and faces (T, 3); ``pre_expanded``: the vertex streams are already
    corner streams of length 3T in record order (v0, v2, v1)."""
    n_tris = sx.shape[-1] // 3 if pre_expanded else faces.shape[0]
    tri_f = torch.arange(n_tris, dtype=torch.float32, device=sx.device)
    if tid_pack is not None:
        tri_f = tri_f * pack_stride + tid_pack.float()
    vrec = torch.stack([sx, sy, z, iw], dim=-1)              # (..., V, 4)
    if vextra is not None:
        if two_sided:
            raise ValueError("extras mode is front-face only")
        vrec = torch.cat([vrec, vextra], dim=-1)
    nc = vrec.shape[-1]
    if pre_expanded:
        corners = vrec.reshape(*vrec.shape[:-2], n_tris, 3 * nc)
    else:
        f = faces.long()
        idx = torch.stack([f[:, 0], f[:, 2], f[:, 1]], -1).reshape(-1)
        corners = vrec[..., idx, :].reshape(*vrec.shape[:-2], n_tris, 3 * nc)
    cols = [corners[..., c * nc + i] for c in range(3) for i in range(4)] \
        + [tri_f]
    if vextra is not None:
        cols += [corners[..., c * nc + 4 + i] for c in range(3)
                 for i in range(3)]
    return _finish_records(cols, valid_mask, two_sided)


def clip_near_records(clip_verts, faces, width: int, height: int,
                      valid_mask=None, two_sided: bool = False,
                      w_eps: float = 1e-4, vextra=None, tid_pack=None,
                      pack_stride: int = ENT_PACK,
                      pre_expanded: bool = False, components=None):
    """Near-plane clipping in CLIP space against w = w_eps: each triangle
    becomes ≤2 sub-triangles in a static 2T record stream (slot B is
    degenerate unless the quad case hits).

    ``vextra`` (..., V, 3) the per-vertex (or per-corner) extras, shared
    or per env. ``components``: per-corner clip-space columns
    ``[[x, y, z, w(, nx, ny, nz)] for each face corner]`` of (..., T)
    tensors (the cluster-record path); otherwise corners are gathered from
    ``clip_verts`` (..., V, 4) by ``faces``, (T, 3) shared or (B, T, 3) per
    env with clip_verts (B, V, 4). With extras (normals) the
    record has 22 columns (extras layout); without, 19 (cb pairs).

    Returns (rec (..., C, 2T), ok (..., 2T), csrc (2T,), cbary or None)."""
    if two_sided and vextra is not None:
        raise ValueError("extras mode is front-face only")
    if components is not None:
        v = components
        T = v[0][0].shape[-1]
        NC = len(v[0])
        dev = v[0][0].device
    else:
        T = clip_verts.shape[-2] // 3 if pre_expanded else faces.shape[-2]
        src = clip_verts if vextra is None else torch.cat(
            [clip_verts, vextra.expand(*clip_verts.shape[:-1],
                                       vextra.shape[-1])], dim=-1)
        NC = src.shape[-1]
        if pre_expanded:
            g = src
        elif faces.dim() == 3:
            # per-env faces (B, T, 3), e.g. after compact_faces
            idx = faces.transpose(-1, -2).reshape(faces.shape[0], 3 * T)
            g = torch.gather(src, -2, idx.long()[..., None].expand(
                *idx.shape, NC))
        else:
            g = src[..., faces.T.reshape(-1).long(), :]
        gt = g.transpose(-1, -2)                               # (..., NC, 3T)
        v = [[gt[..., i, c * T:(c + 1) * T] for i in range(NC)]
             for c in range(3)]
        dev = gt.device
    w = [v[c][3] for c in range(3)]
    inside = [wc > w_eps for wc in w]
    n_in = inside[0].int() + inside[1].int() + inside[2].int()

    one_in = n_in == 1
    k_in = torch.where(inside[0], 0, torch.where(inside[1], 1, 2))
    k_out = torch.where(~inside[0], 0, torch.where(~inside[1], 1, 2))
    k_rot = torch.where(one_in, k_in, k_out)
    s0, s1, s2 = k_rot == 0, k_rot == 1, k_rot == 2

    def pick(c0, c1, c2):
        return torch.where(s0, c0, torch.where(s1, c1, c2))

    def ind(m):
        return torch.where(m, 1.0, 0.0)

    A = [pick(v[0][i], v[1][i], v[2][i]) for i in range(NC)]
    Bv = [pick(v[1][i], v[2][i], v[0][i]) for i in range(NC)]
    Cv = [pick(v[2][i], v[0][i], v[1][i]) for i in range(NC)]
    bA = [ind(s0), ind(s1)]
    bB = [ind(s2), ind(s0)]
    bC = [ind(s1), ind(s2)]
    wA, wB, wC = A[3], Bv[3], Cv[3]

    def isect(p, q, wp, wq, bp, bq):
        den = wq - wp
        t = (w_eps - wp) / torch.where(den == 0, 1.0, den)
        t = torch.clamp(t, 0.0, 1.0)
        return ([p[i] + t * (q[i] - p[i]) for i in range(NC)],
                [bp[i] + t * (bq[i] - bp[i]) for i in range(2)])

    iAB, bAB = isect(A, Bv, wA, wB, bA, bB)
    iCA, bCA = isect(Cv, A, wC, wA, bC, bA)

    two = n_in == 2
    tA0 = [torch.where(two, iAB[i], A[i]) for i in range(NC)]
    tA1 = [torch.where(one_in, iAB[i], Bv[i]) for i in range(NC)]
    tA2 = [torch.where(one_in, iCA[i], Cv[i]) for i in range(NC)]
    bA0 = [torch.where(two, bAB[i], bA[i]) for i in range(2)]
    bA1 = [torch.where(one_in, bAB[i], bB[i]) for i in range(2)]
    bA2 = [torch.where(one_in, bCA[i], bC[i]) for i in range(2)]
    okA = n_in > 0
    tB0, tB1, tB2 = iAB, Cv, iCA
    bB0, bB1, bB2 = bAB, bC, bCA
    okB = two

    csrc = torch.cat([torch.arange(T, dtype=torch.int32, device=dev)] * 2)
    ok = torch.cat([okA, okB], dim=-1)
    if valid_mask is not None:
        ok = ok & torch.cat([valid_mask] * 2, dim=-1)

    def cat2(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.cat([a, b], dim=-1)

    def proj_corner(slotA, slotB):
        x, y, z, wc = (cat2(slotA[i], slotB[i]) for i in range(4))
        w_safe = torch.where(torch.abs(wc) < 1e-9,
                             torch.where(wc < 0, -1e-9, 1e-9), wc)
        iw = 1.0 / w_safe
        return [(x * iw * 0.5 + 0.5) * width,
                (0.5 - y * iw * 0.5) * height, z * iw, iw]

    p0 = proj_corner(tA0, tB0)
    p1 = proj_corner(tA1, tB1)
    p2 = proj_corner(tA2, tB2)
    tid = torch.arange(2 * T, dtype=torch.float32, device=dev)
    if tid_pack is not None:
        tid = tid * pack_stride + torch.cat([tid_pack] * 2, dim=-1).float()
    if NC > 4:
        excols = [cat2(sa[4 + i], sb[4 + i])
                  for sa, sb in ((tA0, tB0), (tA2, tB2), (tA1, tB1))
                  for i in range(3)]
        rec, ok2 = _finish_records(p0 + p2 + p1 + [tid] + excols, ok,
                                   two_sided)
        return rec, ok2, csrc, None
    cbcols = [cat2(a, b) for a, b in zip(bA0 + bA1 + bA2, bB0 + bB1 + bB2)]
    cols = p0 + p2 + p1 + [tid] + cbcols[0:2] + cbcols[4:6] + cbcols[2:4]
    rec, ok2 = _finish_records(cols, ok, two_sided)
    cbary = torch.stack(
        [torch.stack([cbcols[0], cbcols[1]], -1),
         torch.stack([cbcols[2], cbcols[3]], -1),
         torch.stack([cbcols[4], cbcols[5]], -1)], dim=-2)
    return rec, ok2, csrc, cbary


NCOEF = 24        # coefficient-record width (main raster)
NCOEF_DEPTH = 16  # depth-only coefficient-record width (shadow passes)


def _edges(rec):
    x0, y0 = rec[..., 0, :], rec[..., 1, :]
    x1, y1 = rec[..., 4, :], rec[..., 5, :]
    x2, y2 = rec[..., 8, :], rec[..., 9, :]
    a0 = y1 - y2
    b0 = x2 - x1
    c0 = (y2 - y1) * x1 - (x2 - x1) * y1
    a1 = y2 - y0
    b1 = x0 - x2
    c1 = (y0 - y2) * x2 - (x0 - x2) * y2
    a2 = y0 - y1
    b2 = x1 - x0
    c2 = (y1 - y0) * x0 - (x1 - x0) * y0
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    return (a0, b0, c0, a1, b1, c1, a2, b2, c2), area


def _cluster_zmin(zmin, valid, cluster):
    zmin = torch.where(valid, zmin, INF)
    if cluster:
        T = zmin.shape[-1]
        czmin = zmin.reshape(*zmin.shape[:-1], T // cluster, cluster) \
            .amin(dim=-1)
        zmin = czmin.repeat_interleave(cluster, dim=-1)
        return zmin, zmin
    return zmin, torch.full_like(zmin, INF)


def _pack_coeffs(cols, cluster):
    """Column list → tri-major (..., T, NC) records; with ``cluster`` the
    same memory viewed as (..., T/cluster, cluster·NC) cluster rows."""
    arr = torch.stack(cols, dim=-1)
    if cluster:
        T, nc = arr.shape[-2:]
        arr = arr.reshape(*arr.shape[:-2], T // cluster, cluster * nc)
    return arr


def records_to_coeffs(rec, cluster: int = None):
    """(..., 13|19|22, T) vertex records → (..., T, 24) screen-plane
    coefficient records: three edge planes, the z plane, three pixel-basis
    attribute planes d0/d1/s, the float tid, the (cluster) zmin and a pad.
    With 22 columns (extras layout) d0/d1/s interpolate iw·normal; with 19
    they fold the near-clip original-triangle barycentrics; with 13 they
    give face barycentric producers. Invalid records get c_k = -1."""
    z0, iw0 = rec[..., 2, :], rec[..., 3, :]
    z1, iw1 = rec[..., 6, :], rec[..., 7, :]
    z2, iw2 = rec[..., 10, :], rec[..., 11, :]
    tid = rec[..., 12, :]
    C = rec.shape[-2]
    extras = C == 22
    if extras:
        ex = [[rec[..., 13 + 3 * k + i, :] for i in range(3)]
              for k in range(3)]
    elif C > 13:
        cb = [(rec[..., 13 + 2 * k, :], rec[..., 14 + 2 * k, :])
              for k in range(3)]
    else:
        one = torch.ones_like(tid)
        zero2 = torch.zeros_like(tid)
        cb = [(one, zero2), (zero2, zero2), (zero2, one)]
    (a0, b0, c0, a1, b1, c1, a2, b2, c2), area = _edges(rec)
    valid = area > 1e-8
    inv_area = 1.0 / torch.where(valid, area, 1.0)
    za = (a0 * z0 + a1 * z1 + a2 * z2) * inv_area
    zb = (b0 * z0 + b1 * z1 + b2 * z2) * inv_area
    zc = (c0 * z0 + c1 * z1 + c2 * z2) * inv_area
    p = [iw0 * inv_area, iw1 * inv_area, iw2 * inv_area]
    if extras:
        q0 = [p[k] * ex[k][0] for k in range(3)]
        q1 = [p[k] * ex[k][1] for k in range(3)]
        s_ = [p[k] * ex[k][2] for k in range(3)]
    else:
        q0 = [p[k] * cb[k][0] for k in range(3)]
        q1 = [p[k] * cb[k][1] for k in range(3)]
        s_ = p

    def pix(q):
        return (a0 * q[0] + a1 * q[1] + a2 * q[2],
                b0 * q[0] + b1 * q[1] + b2 * q[2],
                c0 * q[0] + c1 * q[1] + c2 * q[2])

    q0 = pix(q0)
    q1 = pix(q1)
    s_ = pix(s_)
    zero = torch.zeros_like(a0)
    mone = torch.full_like(a0, -1.0)
    zmin = torch.minimum(torch.minimum(z0, z1), z2)
    zmin, dead_zmin = _cluster_zmin(zmin, valid, cluster)
    cols = [torch.where(valid, v, d) for v, d in (
        (a0, zero), (b0, zero), (c0, mone),
        (a1, zero), (b1, zero), (c1, mone),
        (a2, zero), (b2, zero), (c2, mone),
        (za, zero), (zb, zero), (zc, zero),
        (q0[0], zero), (q0[1], zero), (q0[2], zero),
        (q1[0], zero), (q1[1], zero), (q1[2], zero),
        (s_[0], zero), (s_[1], zero), (s_[2], zero),
        (tid, tid), (zmin, dead_zmin), (zero, zero))]
    return _pack_coeffs(cols, cluster)


def records_to_coeffs_depth(rec, cluster: int = None):
    """Depth-only coefficient records (..., T, 16): the 3 edge planes,
    the z plane, the (cluster) zmin in col 12, pad."""
    z0, z1, z2 = rec[..., 2, :], rec[..., 6, :], rec[..., 10, :]
    (a0, b0, c0, a1, b1, c1, a2, b2, c2), area = _edges(rec)
    valid = area > 1e-8
    inv_area = 1.0 / torch.where(valid, area, 1.0)
    za = (a0 * z0 + a1 * z1 + a2 * z2) * inv_area
    zb = (b0 * z0 + b1 * z1 + b2 * z2) * inv_area
    zc = (c0 * z0 + c1 * z1 + c2 * z2) * inv_area
    zero = torch.zeros_like(a0)
    mone = torch.full_like(a0, -1.0)
    zmin = torch.minimum(torch.minimum(z0, z1), z2)
    zmin, dead_zmin = _cluster_zmin(zmin, valid, cluster)
    cols = [torch.where(valid, v, d) for v, d in (
        (a0, zero), (b0, zero), (c0, mone),
        (a1, zero), (b1, zero), (c1, mone),
        (a2, zero), (b2, zero), (c2, mone),
        (za, zero), (zb, zero), (zc, zero),
        (zmin, dead_zmin), (zero, zero), (zero, zero), (zero, zero))]
    return _pack_coeffs(cols, cluster)


CLUSTER = 8        # triangles per binning cluster
KERNEL_CHUNK = 32  # records staged per kernel walk step


def _pad_cluster(rec, ok, band_id=None, cluster: int = CLUSTER):
    """Pad the (..., C, T) record stream to a cluster multiple of T with
    inert all-zero records."""
    T = rec.shape[-1]
    pad = (-T) % cluster
    if pad:
        rec = torch.cat([rec, rec.new_zeros(rec.shape[:-1] + (pad,))],
                        dim=-1)
        ok = torch.cat([ok, ok.new_zeros(ok.shape[:-1] + (pad,))], dim=-1)
        if band_id is not None:
            band_id = torch.cat([band_id, band_id.new_zeros(pad)])
    return rec, ok, band_id


def bin_triangles(rec, ok, width: int, height: int,
                  band_id=None, band_tiles: int = 0,
                  tile_h: int = None, tile_w: int = None,
                  cluster: int = CLUSTER, cap: int = None,
                  refine: bool = None):
    """Sort-based CLUSTER binning of a (B, C, T) record stream per env.

    Returns (tile_list (B, n_sub_tiles, cap_c) i32 cluster ids,
    counts (B, n_sub_tiles) i32 clusters, big_idx (B, n_big_c) i32,
    big_count (B,) i32). Sub-tiles are 128 px wide, y-major; the sub-tile
    grid is derived from the padded coarse grid, so one coarse tile's
    ``sub`` lists are always consecutive rows.

    band_id (T,)/band_tiles: per-triangle vertical band clamp (cascade
    atlas); refine: edge-function tile rejection (default: on when the
    grid is more than one sub-tile wide)."""
    th, tw = (tile_h, tile_w) if tile_h else tile_dims(width, height)
    sub = tile_subcols(tw)
    ntx = cdiv(width, tw) * sub
    tw = tw // sub
    nty = cdiv(height, th)
    n_tiles = ntx * nty
    rec, ok, band_id = _pad_cluster(rec, ok, band_id, cluster)
    dev = rec.device
    B, T = rec.shape[0], rec.shape[-1]
    mok = ok

    xs = rec[:, _XC[0]:_XC[-1] + 1:4]            # the corners' x rows
    ys = rec[:, _YC[0]:_YC[-1] + 1:4]
    Tc = T // cluster

    def cl_red(v, fill, fn):
        return fn(torch.where(mok, v, fill).reshape(B, Tc, cluster), dim=-1)

    txmin = cl_red(xs.amin(1), INF, torch.amin)
    txmax = cl_red(xs.amax(1), -INF, torch.amax)
    tymin = cl_red(ys.amin(1), INF, torch.amin)
    tymax = cl_red(ys.amax(1), -INF, torch.amax)
    cok = mok.reshape(B, Tc, cluster).any(-1)
    txmin = torch.where(cok, txmin, 0.0)
    txmax = torch.where(cok, txmax, -1.0)
    tymin = torch.where(cok, tymin, 0.0)
    tymax = torch.where(cok, tymax, -1.0)

    if band_id is not None:
        band_c = band_id.reshape(Tc, cluster)[:, 0].int()
        ylo = band_c * band_tiles
        yhi = ylo + band_tiles - 1
    else:
        ylo = mx.const(0, dev, torch.int32)
        yhi = mx.const(nty - 1, dev, torch.int32)
    x0 = torch.clamp(torch.floor(txmin / tw).int(), 0, ntx - 1)
    x1 = torch.clamp(torch.floor(txmax / tw).int(), 0, ntx - 1)
    y0 = torch.minimum(torch.maximum(torch.floor(tymin / th).int(), ylo), yhi)
    y1 = torch.minimum(torch.maximum(torch.floor(tymax / th).int(), ylo), yhi)
    off = (txmax < 0) | (txmin >= width) | (tymax < 0) | (tymin >= height)
    if band_id is not None:
        off = off | (tymax < ylo * th) | (tymin >= (yhi + 1) * th)
    okc = cok & ~off

    spanx = x1 - x0 + 1
    spany = y1 - y0 + 1
    if band_id is not None:
        sx_span = min(MAX_SPAN_X, ntx)
        sy_span = band_tiles
        big = torch.zeros_like(okc)
        small = okc
    else:
        sx_span = min(MAX_SPAN_X, ntx)
        sy_span = min(MAX_SPAN_Y, nty)
        if sx_span == ntx and sy_span == nty:
            big = None
            small = okc
        else:
            big = okc & ((spanx > sx_span) | (spany > sy_span))
            small = okc & ~big

    dy = torch.arange(sy_span, dtype=torch.int32, device=dev)
    dx = torch.arange(sx_span, dtype=torch.int32, device=dev)
    ty = y0[..., None, None] + dy[:, None]                   # (B,Tc,sy,1)
    tx = x0[..., None, None] + dx[None, :]                   # (B,Tc,1,sx)
    pair_ok = small[..., None, None] & (ty <= y1[..., None, None]) \
        & (tx <= x1[..., None, None])

    if refine is None:
        refine = ntx > 1
    if refine and sx_span * sy_span > 1:
        # a cluster covers a tile only if some member's most-inside tile
        # corner is inside all three edges (conservative)
        px0 = (tx * tw).float()
        px1 = px0 + tw
        py0 = (ty * th).float()
        py1 = py0 + th
        edges = [e.reshape(B, Tc, cluster) for e in _edges(rec)[0]]
        inside = mok.reshape(B, Tc, cluster)[..., None, None]
        for k in range(3):
            aa = edges[3 * k][..., None, None]
            bb = edges[3 * k + 1][..., None, None]
            cc = edges[3 * k + 2][..., None, None]
            best = aa * torch.where(aa > 0, px1[:, :, None], px0[:, :, None]) \
                + bb * torch.where(bb > 0, py1[:, :, None], py0[:, :, None]) \
                + cc
            inside = inside & (best >= 0.0)
        pair_ok = pair_ok & torch.any(inside, dim=2)

    tile_id = torch.where(pair_ok, ty * ntx + tx, n_tiles).long()
    cl_id = torch.arange(Tc, device=dev)[:, None, None].expand(tile_id.shape[1:])

    # depth-ordered keys: tile in the high bits, quantized cluster near-z
    zbits = 12
    tzmin = torch.minimum(torch.minimum(rec[:, _ZC[0]], rec[:, _ZC[1]]),
                          rec[:, _ZC[2]])
    czmin = torch.where(mok, tzmin, INF).reshape(B, Tc, cluster).amin(-1)
    zq = torch.clamp((czmin * 0.5 + 0.5) * ((1 << zbits) - 1), 0,
                     (1 << zbits) - 1).long()
    key = (tile_id << zbits) | zq[..., None, None]
    skey, perm = torch.sort(key.reshape(B, -1), dim=-1, stable=True)
    scl = cl_id.reshape(-1)[perm]
    st = (skey >> zbits).contiguous()

    cap_c = min(cap if cap else tile_capacity(width, height), T) // cluster
    if sub > 1:
        cap_c = max(1, (cap_c * 5) // (4 * sub))
    cap_c = cdiv(cap_c, 4) * 4
    L = st.shape[-1]
    q = torch.arange(n_tiles, device=dev).expand(B, n_tiles).contiguous()
    starts = torch.searchsorted(st, q)
    ends = torch.searchsorted(st, q + 1)
    counts = torch.clamp(ends - starts, max=cap_c).int()
    ar = torch.arange(cap_c, device=dev)
    gather_idx = torch.clamp(starts[..., None] + ar, max=L - 1)
    tile_list = torch.where(
        ar < counts[..., None],
        torch.gather(scl, 1, gather_idx.reshape(B, -1)).reshape(
            B, n_tiles, cap_c), 0).int()

    if big is None:
        big_idx = torch.zeros((B, max(KERNEL_CHUNK // cluster, 1)),
                              dtype=torch.int32, device=dev)
        big_count = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        # stable valid-first compaction with a static size (no host sync)
        order = torch.sort((~big).to(torch.int8), dim=-1, stable=True)[1]
        nb = big.sum(-1)
        keep = min(MAX_BIG_TRIS, Tc)
        sel = torch.arange(keep, device=dev) < nb[:, None]
        big_idx = torch.where(sel, order[:, :keep], 0).int()
        if keep < MAX_BIG_TRIS:
            big_idx = torch.cat([big_idx, big_idx.new_zeros(
                B, MAX_BIG_TRIS - keep)], dim=-1)
        big_count = torch.clamp(nb, max=MAX_BIG_TRIS).int()
    return tile_list, counts, big_idx, big_count


def compact_faces(faces, face_valid, cap: int, extra=None,
                  cluster: int = CLUSTER):
    """Fixed-capacity valid-first compaction of a shared face stream
    (T, 3) with per-env validity (B, T), at cluster granularity (stable:
    kept clusters stay in stream order). Returns (faces (B, cap, 3),
    valid (B, cap), extra (B, cap) | None)."""
    T = faces.shape[0]
    B = face_valid.shape[0]
    if cap >= T:
        return (faces.expand(B, *faces.shape), face_valid,
                None if extra is None else extra.expand(B, T))
    pad = (-T) % cluster
    if pad:
        faces = torch.cat([faces, faces.new_zeros(pad, 3)])
        face_valid = torch.cat([face_valid, face_valid.new_zeros(B, pad)],
                               dim=-1)
        if extra is not None:
            extra = torch.cat([extra, extra.new_zeros(pad)])
        T += pad
    Tc = T // cluster
    ckey = (~face_valid.reshape(B, Tc, cluster).any(-1)).to(torch.int8)
    sidx = torch.sort(ckey, dim=-1, stable=True)[1]
    keep = sidx[:, :cap // cluster]
    midx = (keep[..., None] * cluster
            + torch.arange(cluster, device=faces.device)).reshape(B, -1)
    faces_c = faces[midx]
    valid_c = torch.gather(face_valid, 1, midx)
    extra_c = None if extra is None else extra[midx]
    return faces_c, valid_c, extra_c


# ---------------------------------------------------------------------------
# K1 / K2: the tile walks. Plain versions first, then the CUDA wrappers.
# ---------------------------------------------------------------------------

def _list_lattice(B, n_tiles, ntx, tile_h, tile_w, sub, device):
    """Pixel-center lattices (L, tile_h, tws) of every (env, tile, sub)
    list, L = B·n_tiles·sub in that order."""
    tws = tile_w // sub
    ti = torch.arange(n_tiles, device=device)
    sc = torch.arange(sub, device=device)
    x0 = ((ti % ntx) * tile_w)[:, None] + sc[None, :] * tws   # (nt, sub)
    y0 = ((ti // ntx) * tile_h)[:, None].expand(n_tiles, sub)
    col = torch.arange(tws, device=device)
    row = torch.arange(tile_h, device=device)
    px = (x0[..., None, None] + col).float() + 0.5           # (nt,sub,1,tws)
    py = (y0[..., None, None] + row[:, None]).float() + 0.5  # (nt,sub,th,1)
    px = px.expand(B, n_tiles, sub, tile_h, tws).reshape(-1, tile_h, tws)
    py = py.expand(B, n_tiles, sub, tile_h, tws).reshape(-1, tile_h, tws)
    return px, py


def _plane(slab, i, px, py):
    """(a·px + b·py) + c for record columns i..i+2, every chunk row:
    slab (A, chunk, NC), px/py (A, th, tws) → (A, chunk, th, tws)."""
    a = slab[:, :, i, None, None]
    b = slab[:, :, i + 1, None, None]
    c = slab[:, :, i + 2, None, None]
    return a * px[:, None] + b * py[:, None] + c


def _covered_z(slab, n_valid, px, py):
    """Per record and pixel: z where covered (edges ≥ 0, z in [-1, 1],
    row < n_valid), else +inf."""
    e0 = _plane(slab, 0, px, py)
    e1 = _plane(slab, 3, px, py)
    e2 = _plane(slab, 6, px, py)
    z = _plane(slab, 9, px, py)
    rows = torch.arange(slab.shape[1], device=slab.device)
    valid = (rows[None, :] < n_valid[:, None])[..., None, None]
    ok = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & valid & (z >= -1.0) & (z <= 1.0)
    return torch.where(ok, z, INF)


def _walk_ref(counts, trec, brec, width, tile_h, tile_w, sub, chunk,
              zcol, init, step):
    """Shared driver of the plain tile walks: every (env, tile, sub) list
    walks its small list chunk by chunk with the depth-sorted early-out,
    then the shared big list. ``step(slab, n_valid, px, py, carry)``
    returns the new carry (carry[0] is the depth plane)."""
    B, n_tiles = counts.shape[:2]
    ntx = cdiv(width, tile_w)
    tws = tile_w // sub
    cap = trec.shape[2] // sub
    NC = trec.shape[-1]
    dev = trec.device
    L = B * n_tiles * sub
    lists = trec.reshape(B, n_tiles, sub, cap, NC).reshape(L, cap, NC)
    cnt = counts[..., :sub].reshape(L).long()
    big_cnt = counts[..., sub:].expand(B, n_tiles, sub).reshape(L).long()
    env = torch.arange(B, device=dev).repeat_interleave(n_tiles * sub)
    px, py = _list_lattice(B, n_tiles, ntx, tile_h, tile_w, sub, dev)
    carry = [x.expand(L, tile_h, tws).clone() for x in init(dev)]

    def run(src_rows, n_rows, early):
        n_chunks = (n_rows + chunk - 1) // chunk
        active = n_chunks > 0
        k = 0
        while bool(active.any()):
            idx = active.nonzero()[:, 0]
            slab = src_rows(idx, k)
            nv = n_rows[idx] - k * chunk
            new = step(slab, nv, px[idx], py[idx], [c[idx] for c in carry])
            for c, n in zip(carry, new):
                c[idx] = n
            more = k + 1 < n_chunks[idx]
            if early:
                # depth-sorted early-out: every pixel is nearer than the
                # chunk's cluster zmin, so later records cannot win
                done = new[0].amax(dim=(1, 2)) < slab[:, :, zcol].amin(1) \
                    - 1e-3
                more = more & ~done
            active[idx] = more
            k += 1

    def small_rows(idx, k):
        return lists[idx, k * chunk:(k + 1) * chunk]

    def big_rows(idx, k):
        return brec[env[idx], k * chunk:(k + 1) * chunk]

    run(small_rows, cnt, True)
    run(big_rows, big_cnt, False)
    nty = n_tiles // ntx

    def planes(c):
        return c.reshape(B, nty, ntx, sub, tile_h, tws).permute(
            0, 1, 4, 2, 3, 5).reshape(B, nty * tile_h, ntx * tile_w)

    return [planes(c) for c in carry]


def _gather_lists(crec, tile_list, big_idx, counts, ncoef):
    """The per-tile record copies the TPU kernel walked, gathered through
    the id lists: trec (B, n_tiles, sub·cap, NC), brec (B, n_big, NC)."""
    B, n_tiles = counts.shape[:2]
    envs = torch.arange(B, device=crec.device)
    trec = crec[envs[:, None, None], tile_list.long()].reshape(
        B, n_tiles, -1, ncoef)
    brec = crec[envs[:, None], big_idx.long()].reshape(B, -1, ncoef)
    return trec, brec


def raster_tile_ref(crec, tile_list, big_idx, counts, width: int,
                    height: int, tile_h: int, tile_w: int, sub: int,
                    chunk: int, cluster: int):
    """Plain PyTorch version of K1 (same signature as ``raster_tile``).

    crec (B, Tc, cluster·24) f32 coefficient cluster rows
    (``records_to_coeffs``); tile_list (B, n_tiles·sub, cap_c) i32 cluster
    ids of each sub-list and big_idx (B, n_big_c) i32 of the big list
    (``bin_triangles``); counts (B, n_tiles, sub+1) i32 — per sub-list
    record counts, then the big-list record count. Gathers each tile's
    records through its list, then walks them. Returns (depth, tid, d0, d1,
    s), each (B, Hp, Wp) f32: nearest covering record per pixel (a later
    record must be strictly nearer, so the first record wins ties), +inf /
    -1 / 0 / 0 / 1 where nothing covers."""
    trec, brec = _gather_lists(crec, tile_list, big_idx, counts, NCOEF)

    def init(dev):
        return [torch.tensor(v, dtype=torch.float32, device=dev)
                for v in (INF, -1.0, 0.0, 0.0, 1.0)]

    def step(slab, nv, px, py, carry):
        depth, tidf, d0o, d1o, so = carry
        zm = _covered_z(slab, nv, px, py)                  # (A, ch, th, tw)
        rd = zm.amin(dim=1)
        first = torch.argmax((zm == rd[:, None]).int(), dim=1, keepdim=True)

        def winner(i):
            return torch.gather(_plane(slab, i, px, py), 1, first)[:, 0]

        rtid = torch.gather(slab[:, :, 21], 1, first.flatten(1)).reshape(
            rd.shape)
        win = rd < depth
        return (torch.where(win, rd, depth), torch.where(win, rtid, tidf),
                torch.where(win, winner(12), d0o),
                torch.where(win, winner(15), d1o),
                torch.where(win, winner(18), so))

    return tuple(_walk_ref(counts, trec, brec, width, tile_h, tile_w, sub,
                           chunk, 22, init, step))


def raster_depth_ref(crec, tile_list, big_idx, counts, width: int,
                     height: int, tile_h: int, tile_w: int, sub: int,
                     chunk: int, cluster: int):
    """Plain PyTorch version of K2 (same signature as ``raster_depth``):
    16-float depth cluster rows (``records_to_coeffs_depth``, cluster zmin
    in col 12) read through the lists; returns the minimum covered z per
    pixel, (B, Hp, Wp), +inf where nothing covers."""
    trec, brec = _gather_lists(crec, tile_list, big_idx, counts,
                               NCOEF_DEPTH)

    def init(dev):
        return [torch.tensor(INF, device=dev)]

    def step(slab, nv, px, py, carry):
        zm = _covered_z(slab, nv, px, py)
        return [torch.minimum(zm.amin(dim=1), carry[0])]

    return _walk_ref(counts, trec, brec, width, tile_h, tile_w, sub, chunk,
                     12, init, step)[0]


def _warp_reject_ref(slab, rect, depth_max):
    """Torch copy of the kernels' per-warp reject (csrc/raster.cu
    ``rejected``), in float64 as there: True where a coefficient record
    can win no pixel of a rectangle. slab (..., NC) f32 records; rect
    (..., 4) its pixel-centre bounds (x0, x1, y0, y1), 0 < x0 ≤ x1,
    0 < y0 ≤ y1; depth_max (...) the rectangle's largest depth; all
    broadcast. A record is rejected when some edge's largest value over
    the corners is below -m, or its z plane's smallest value there minus m
    is ≥ depth_max, with m = 2^-22·(|a|·x1 + |b|·y1 + |c|) + 2^-120 —
    more than the rounding of the per-pixel (a·px + b·py) + c."""
    r = slab.double()
    x0, x1, y0, y1 = rect.double().unbind(-1)

    def margin(a, b, c):
        return 2.0 ** -22 * (a.abs() * x1 + b.abs() * y1 + c.abs()) \
            + 2.0 ** -120

    out = None
    for k in range(3):
        a, b, c = r[..., 3 * k], r[..., 3 * k + 1], r[..., 3 * k + 2]
        hi = a * torch.where(a > 0, x1, x0) + b * torch.where(b > 0, y1, y0) \
            + c
        rej = hi < -margin(a, b, c)
        out = rej if out is None else out | rej
    a, b, c = r[..., 9], r[..., 10], r[..., 11]
    lo = a * torch.where(a > 0, x0, x1) + b * torch.where(b > 0, y0, y1) + c
    return out | (lo - margin(a, b, c) >= depth_max.double())


def _warp_keep_ref(slab, n_valid, px, py, depth):
    """The records of a staged chunk that each warp of the kernels shades:
    (A, chunk, 8) bool for slab (A, chunk, NC), n_valid (A,) and the
    lists' (A, th, 128) lattices px / py and depth planes before the
    chunk. Warp w owns rows (w // 4)·th/2 … and columns (w % 4)·32 … of
    the sub-tile, as in csrc/raster.cu."""
    A, th, tw = px.shape
    ppt = th // 2

    def blocks(t):                                   # (A, 8, ppt·32)
        return t.reshape(A, 2, ppt, 4, 32).permute(0, 1, 3, 2, 4) \
            .reshape(A, 8, ppt * 32)

    bx, by = blocks(px), blocks(py)
    rect = torch.stack([bx.amin(-1), bx.amax(-1), by.amin(-1),
                        by.amax(-1)], dim=-1)          # (A, 8, 4)
    rej = _warp_reject_ref(slab[:, :, None], rect[:, None],
                           blocks(depth).amax(-1)[:, None])
    rows = torch.arange(slab.shape[1], device=slab.device)
    return ~rej & (rows[None, :] < n_valid[:, None])[..., None]


KERNEL_MAX_CHUNK = 32    # the kernels test one record per lane of a warp


def _kernel_args(crec, tile_list, big_idx, counts, width, height, tile_h,
                 tile_w, sub, chunk, cluster, ncoef):
    """Validate a kernel launch; returns (B, Tc, cap_c, n_big_c, n_tiles,
    ntx, Hp, Wp). Raises on anything the kernels do not take."""
    B, n_tiles = counts.shape[:2]
    ntx = cdiv(width, tile_w)
    nty = cdiv(height, tile_h)
    if counts.dim() != 3 or n_tiles != ntx * nty \
            or counts.shape[2] != sub + 1:
        raise ValueError(f"counts {tuple(counts.shape)} do not match a "
                         f"{ntx}x{nty} tile grid with sub={sub}")
    if crec.dtype != torch.float32 or any(
            t.dtype != torch.int32 for t in (tile_list, big_idx, counts)):
        raise TypeError("crec must be float32; tile_list, big_idx and "
                        "counts int32")
    if crec.dim() != 3 or crec.shape[0] != B or crec.shape[1] == 0 \
            or crec.shape[2] != cluster * ncoef or tile_list.dim() != 3 \
            or tile_list.shape[:2] != (B, n_tiles * sub) \
            or big_idx.dim() != 2 or big_idx.shape[0] != B:
        raise ValueError(
            f"crec {tuple(crec.shape)}, tile_list {tuple(tile_list.shape)}, "
            f"big_idx {tuple(big_idx.shape)} do not match B={B}, "
            f"{n_tiles}x{sub} lists, cluster rows of {cluster}x{ncoef}")
    if cluster <= 0 or chunk <= 0 or chunk % cluster \
            or chunk > KERNEL_MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be whole cluster rows "
                         f"(cluster {cluster}) and at most "
                         f"{KERNEL_MAX_CHUNK} records")
    cap = tile_list.shape[2] * cluster
    n_big = big_idx.shape[1] * cluster
    if cap % chunk or n_big % chunk:
        raise ValueError(f"chunk {chunk} must divide the list capacity "
                         f"{cap} and the big-list size {n_big}")
    if tile_w != sub * 128 or tile_h not in (8, 16, 32):
        raise ValueError(f"unsupported tile {tile_h}x{tile_w} with sub="
                         f"{sub}: sub-columns are 128 px, 8-32 rows")
    tensors = (crec, tile_list, big_idx, counts)
    if not all(t.is_cuda and t.device == crec.device for t in tensors):
        raise ValueError("kernel inputs must all be CUDA tensors on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors) \
            or crec.data_ptr() % 16:
        raise ValueError("kernel inputs must be contiguous, crec 16-byte "
                         "aligned")
    return (B, crec.shape[1], tile_list.shape[2], big_idx.shape[1], n_tiles,
            ntx, nty * tile_h, ntx * tile_w)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _on_cpu(*tensors) -> bool:
    return not any(t.is_cuda for t in tensors)


def raster_tile(crec, tile_list, big_idx, counts, width: int, height: int,
                tile_h: int, tile_w: int, sub: int, chunk: int,
                cluster: int):
    """K1, the main G-buffer tile walk (replaces
    clap_tpu/render/raster.py ``_raster_tile_kernel``). Signature and
    result as ``raster_tile_ref``; CUDA tensors launch the hand-written
    kernel (one CTA per env, tile and sub-column, reading its records
    through the lists), CPU tensors run the plain version."""
    if _on_cpu(crec, tile_list, big_idx, counts):
        return raster_tile_ref(crec, tile_list, big_idx, counts, width,
                               height, tile_h, tile_w, sub, chunk, cluster)
    from ..cuda_build import load_lib

    B, Tc, cap_c, n_big_c, n_tiles, ntx, Hp, Wp = _kernel_args(
        crec, tile_list, big_idx, counts, width, height, tile_h, tile_w, sub,
        chunk, cluster, NCOEF)
    outs = [torch.empty((B, Hp, Wp), dtype=torch.float32,
                        device=crec.device) for _ in range(5)]
    stream = torch.cuda.current_stream(crec.device).cuda_stream
    rc = load_lib("raster").raster_tile_launch(
        _ptr(crec), _ptr(tile_list), _ptr(big_idx), _ptr(counts),
        *(_ptr(o) for o in outs), B, Tc, cluster, cap_c, n_big_c, n_tiles,
        ntx, tile_h, tile_w, sub, chunk, Hp, Wp, ctypes.c_void_p(stream))
    _check(rc, "raster_tile")
    raster_tile.launches += 1
    return tuple(outs)


raster_tile.launches = 0


def raster_depth(crec, tile_list, big_idx, counts, width: int, height: int,
                 tile_h: int, tile_w: int, sub: int, chunk: int,
                 cluster: int):
    """K2, the depth-only tile walk of the shadow passes (replaces
    clap_tpu/render/raster.py ``_raster_depth_kernel``). Signature and
    result as ``raster_depth_ref``."""
    if _on_cpu(crec, tile_list, big_idx, counts):
        return raster_depth_ref(crec, tile_list, big_idx, counts, width,
                                height, tile_h, tile_w, sub, chunk, cluster)
    from ..cuda_build import load_lib

    B, Tc, cap_c, n_big_c, n_tiles, ntx, Hp, Wp = _kernel_args(
        crec, tile_list, big_idx, counts, width, height, tile_h, tile_w, sub,
        chunk, cluster, NCOEF_DEPTH)
    depth = torch.empty((B, Hp, Wp), dtype=torch.float32, device=crec.device)
    stream = torch.cuda.current_stream(crec.device).cuda_stream
    rc = load_lib("raster").raster_depth_launch(
        _ptr(crec), _ptr(tile_list), _ptr(big_idx), _ptr(counts),
        _ptr(depth), B, Tc, cluster, cap_c, n_big_c, n_tiles, ntx, tile_h,
        tile_w, sub, chunk, Hp, Wp, ctypes.c_void_p(stream))
    _check(rc, "raster_depth")
    raster_depth.launches += 1
    return depth


raster_depth.launches = 0


def kernel_inputs(rec, binned, width: int, height: int, tile_h: int = None,
                  tile_w: int = None, cluster: int = CLUSTER,
                  chunk: int = None, depth_only: bool = False):
    """The arguments of one K1 (or, with ``depth_only``, K2) launch for a
    binned (B, C, T) record stream: pad, convert to coefficient cluster
    rows, and count each list in records. The kernels read the rows
    through the binning's id lists; nothing is gathered per tile. Returns
    (crec, tile_list, big_idx, counts, width, height, tile_h, tile_w, sub,
    chunk, cluster) — ``raster_tile(*args)``."""
    to_coeffs = records_to_coeffs_depth if depth_only else records_to_coeffs
    th, tw = (tile_h, tile_w) if tile_h else tile_dims(width, height)
    tile_list, counts, big_idx, big_count = binned
    sub = tile_subcols(tw)
    n_tiles = cdiv(width, tw) * cdiv(height, th)
    B = rec.shape[0]
    # pad RAW records: all-zero raw records become inert coefficients
    all_ok = torch.ones((B, rec.shape[-1]), dtype=torch.bool,
                        device=rec.device)
    rec, _, _ = _pad_cluster(rec, all_ok, None, cluster)
    crec = to_coeffs(rec, cluster)                     # (B, Tc, cluster·NC)
    counts2 = torch.cat(
        [counts.reshape(B, n_tiles, sub) * cluster,
         (big_count * cluster)[:, None, None].expand(B, n_tiles, 1)],
        dim=-1).int().contiguous()
    return (crec.contiguous(), tile_list.contiguous(), big_idx.contiguous(),
            counts2, width, height, th, tw, sub, chunk or KERNEL_CHUNK,
            cluster)


def _raster_main(rec, binned, width: int, height: int,
                 tile_h: int = None, tile_w: int = None,
                 cluster: int = CLUSTER, chunk: int = None):
    """Main raster of a (B, C, T) record stream: coefficients, then K1
    through the tile lists. Returns cropped (depth, tidf, d0, d1, s), each
    (B, H, W)."""
    planes = raster_tile(*kernel_inputs(rec, binned, width, height, tile_h,
                                        tile_w, cluster, chunk))
    return tuple(p[:, :height, :width] for p in planes)


def rasterize(rec, binned, width: int, height: int,
              tile_h: int = None, tile_w: int = None,
              cluster: int = CLUSTER, chunk: int = None) -> GBuffer:
    """Raster binned clusters into a (B, H, W) G-buffer with face-order
    barycentrics (b0, b1)."""
    depth, tidf, d0, d1, s = _raster_main(rec, binned, width, height,
                                          tile_h, tile_w, cluster, chunk)
    tri = tidf.to(torch.int32)
    inv_s = torch.where(s == 0.0, 0.0, 1.0 / torch.where(s == 0.0, 1.0, s))
    hit = tri >= 0
    b0 = torch.where(hit, d0 * inv_s, 0.0)
    b1 = torch.where(hit, d1 * inv_s, 0.0)
    return GBuffer(depth=depth, tri_id=tri, bary=torch.stack([b0, b1], -1))


def rasterize_attrs(rec, binned, width: int, height: int,
                    tile_h: int = None, tile_w: int = None,
                    cluster: int = CLUSTER, chunk: int = None):
    """Kernel-side attribute interpolation raster (22-column extras
    records): returns (depth (B, H, W), pid (B, H, W) i32 — the packed tid
    column, -1 background — and attr (B, H, W, 3), the raw
    iw·normal numerators)."""
    depth, tidf, d0, d1, s = _raster_main(rec, binned, width, height,
                                          tile_h, tile_w, cluster, chunk)
    return depth, tidf.to(torch.int32), torch.stack([d0, d1, s], dim=-1)


def rasterize_depth(rec, binned, width: int, height: int,
                    tile_h: int = None, tile_w: int = None,
                    cluster: int = None, chunk: int = None):
    """Depth-only raster (shadow maps) through K2: (B, H, W) min depth,
    +inf where empty."""
    cluster = cluster or CLUSTER
    depth = raster_depth(*kernel_inputs(rec, binned, width, height, tile_h,
                                        tile_w, cluster, chunk,
                                        depth_only=True))
    return depth[:, :height, :width]


def raster_scene(clip_verts, faces, width: int, height: int,
                 face_valid=None) -> GBuffer:
    """Convenience: clip-space verts (B, V, 4) + faces (T, 3) → (B, H, W)
    G-buffer (K1 through the tile lists); verts (V, 4) give (H, W), as in
    the JAX package. ``face_valid``: (T,) or (B, T) bool."""
    single = clip_verts.dim() == 2
    if single:
        clip_verts = clip_verts[None]
    if face_valid is not None and face_valid.dim() == 1:
        face_valid = face_valid.expand(clip_verts.shape[0], -1)
    sx, sy, z, iw = project_to_screen(clip_verts, width, height)
    rec, ok = assemble_tri_records(sx, sy, z, iw, faces, face_valid)
    gb = rasterize(rec, bin_triangles(rec, ok, width, height), width,
                   height)
    return GBuffer(*(x[0] for x in gb)) if single else gb


def raster_brute(rec, ok, width: int, height: int) -> GBuffer:
    """O(T·H·W) reference rasterizer (test oracle) for one (C, T) record
    stream, evaluated per triangle like the JAX package's oracle."""
    dev = rec.device
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    r = rec[..., None, None]
    x0, x1, x2 = (r[c] for c in _XC)
    y0, y1, y2 = (r[c] for c in _YC)
    z0, z1, z2 = (r[c] for c in _ZC)
    iw0, iw1, iw2 = (r[c] for c in _WC)
    e0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    e2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (area > 1e-8)
    inv_area = 1.0 / torch.where(area == 0, 1.0, area)
    b0 = e0 * inv_area
    b1 = e1 * inv_area
    b2 = 1.0 - b0 - b1
    z = b0 * z0 + b1 * z1 + b2 * z2
    d0, d1, d2 = b0 * iw0, b1 * iw1, b2 * iw2
    inv_s = 1.0 / torch.clamp(d0 + d1 + d2, min=1e-20)
    z = torch.where(inside & (z >= -1) & (z <= 1) & ok[:, None, None], z, INF)
    depth, best = torch.min(z, dim=0)
    first = torch.argmax((z == depth[None]).int(), dim=0, keepdim=True)
    hit = torch.isfinite(depth)
    tid = torch.where(hit, first[0], -1).to(torch.int32)
    b0s = torch.gather((d0 * inv_s).expand(z.shape), 0, first)[0]
    b1s = torch.gather((d1 * inv_s).expand(z.shape), 0, first)[0]
    return GBuffer(depth=depth, tri_id=tid,
                   bary=torch.stack([torch.where(hit, b0s, 0.0),
                                     torch.where(hit, 1.0 - b0s - b1s, 0.0)],
                                    dim=-1))


def bin_stats(binned, cluster: int = CLUSTER) -> dict:
    """Overflow diagnostics (host): how close a frame is to the binning
    capacity caps, summed over envs."""
    tile_list, counts, big_idx, big_count = binned
    c = counts.detach().cpu().numpy() * cluster
    cap = tile_list.shape[-1] * cluster
    bc = big_count.detach().cpu().numpy()
    return {
        "n_tiles": int(c.size),
        "cap": int(cap),
        "mean_per_tile": float(c.mean()) if c.size else 0.0,
        "max_per_tile": int(c.max()) if c.size else 0,
        "tiles_at_cap": int((c >= cap).sum()),
        "big_count": int(bc.max()) if bc.size else 0,
        "big_cap": MAX_BIG_TRIS,
        "big_saturated": bool((bc >= MAX_BIG_TRIS).any()),
    }


def cluster_faces(verts, faces):
    """Host-side face reorder for cluster binning: sort faces by the
    Morton code of their centroid so each CLUSTER-sized group is a compact
    spatial patch. Returns the permuted faces and the permutation."""
    v = np.asarray(verts)
    f = np.asarray(faces)
    c = v[f].mean(axis=1)
    mn = c.min(0)
    ext = np.maximum(c.max(0) - mn, 1e-9)
    q = ((c - mn) / ext * 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = np.argsort(code, kind="stable")
    return f[order], order
