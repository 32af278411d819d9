"""The per-warp conservative reject of the K1 / K2 kernels (csrc/raster.cu
``rejected``), through its torch copy ``_warp_reject_ref``: a rejected
record never wins a pixel of the warp's rectangle, under the per-pixel
arithmetic of the walk (``_covered_z`` and the strict-< depth test).
Inputs are seeded numpy: random triangles near the rectangle, coordinates
up to 4,096 px, edges through pixel centres, slivers, dead records and
depths equal to the record's own z (ties). Then the walk itself: the plain
K1 / K2 walks with each warp shading only the records it keeps give the
same planes, bit for bit, as the full walks."""
import math
import zlib

import numpy as np
import pytest
import torch

from clap_tpu_torch import mathx as mx
from clap_tpu_torch.render import raster as R
from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

N = 3000
INF = math.inf


def _rects(rng, n, ppt, far):
    """n warp rectangles (x0, x1, y0, y1) of 32 × ppt pixel centres."""
    hi = 4096 - 32 if far else 512
    lo = 3584 if far == 1 else 0
    x0 = rng.integers(lo // 32, hi // 32 + 1, n) * 32 + 0.5
    y0 = rng.integers(lo // ppt, (hi - ppt) // ppt + 1, n) * ppt + 0.5
    return np.stack([x0, x0 + 31, y0, y0 + ppt - 1], -1)


def _corners(rng, rect, case):
    """Three (n, 4) corner arrays [x, y, z, 1/w] around each rectangle."""
    n = rect.shape[0]
    cx = (rect[:, 0] + rect[:, 1]) / 2
    cy = (rect[:, 2] + rect[:, 3]) / 2
    if case == "pixel_centres":
        # vertices on the pixel-centre lattice: edges run through centres,
        # many along the rectangle's own rows and columns
        xs = [np.floor(cx + rng.integers(-40, 41, n)) + 0.5 for _ in range(3)]
        ys = [np.floor(cy + rng.integers(-12, 13, n)) + 0.5 for _ in range(3)]
    elif case == "touch":
        # outside the rectangle, touching it: a vertex on a corner pixel
        # centre, and an edge along the boundary row or column of centres
        # (covered there exactly when the rounding gives e >= 0)
        right = rng.uniform(size=n) < 0.5
        down = rng.uniform(size=n) < 0.5
        X = np.where(right, rect[:, 1], rect[:, 0])
        Y = np.where(down, rect[:, 3], rect[:, 2])
        sx = np.where(right, 1.0, -1.0)
        sy = np.where(down, 1.0, -1.0)
        u = rng.uniform(0.3, 60, (2, n))
        w = rng.uniform(0.3, 60, (2, n))
        kind = rng.integers(0, 3, n)
        xs = [X, np.where(kind == 1, X - sx * u[0], X + sx * u[0]),
              np.where(kind == 2, X, X + sx * u[1])]
        ys = [Y, np.where(kind == 1, Y, Y + sy * w[0]),
              np.where(kind == 2, Y - sy * w[1], Y + sy * w[1])]
    elif case == "slivers":
        x0 = cx + rng.uniform(-48, 48, n)
        y0 = cy + rng.uniform(-16, 16, n)
        x1 = cx + rng.uniform(-48, 48, n)
        y1 = cy + rng.uniform(-16, 16, n)
        ln = np.maximum(np.hypot(x1 - x0, y1 - y0), 1e-3)
        eps = 10.0 ** rng.uniform(-5, -1, n)
        mx_, my_ = (x0 + x1) / 2, (y0 + y1) / 2
        xs = [x0, x1, mx_ - (y1 - y0) / ln * eps]
        ys = [y0, y1, my_ + (x1 - x0) / ln * eps]
    else:
        xs = [cx + rng.uniform(-60, 60, n) for _ in range(3)]
        ys = [cy + rng.uniform(-24, 24, n) for _ in range(3)]
    zs = [rng.uniform(-1.2, 1.2, n) for _ in range(3)]
    if case == "flat_z":
        zs = [zs[0]] * 3
    return [np.stack([x, y, z, np.ones(n)], -1).astype(np.float32)
            for x, y, z in zip(xs, ys, zs)]


def _lattice(rect, ppt):
    x = torch.as_tensor(rect[:, 0, None, None] + np.arange(32)[None, None],
                        dtype=torch.float32)
    y = torch.as_tensor(rect[:, 2, None, None] + np.arange(ppt)[None, :, None],
                        dtype=torch.float32)
    return x.expand(-1, ppt, 32), y.expand(-1, ppt, 32)


@pytest.mark.parametrize("ppt", [4, 8, 16])
@pytest.mark.parametrize("case", ["random", "far", "pixel_centres", "touch",
                                  "slivers", "dead", "ties", "flat_z"])
def test_warp_reject_never_drops_a_winner(case, ppt):
    rng = np.random.default_rng(zlib.crc32(f"{case} {ppt}".encode()))
    rect = _rects(rng, N, ppt, far={"far": 1, "touch": 2}.get(case, 0))
    c0, c1, c2 = _corners(rng, rect, case)
    valid = rng.uniform(size=N) < 0.5 if case == "dead" else None
    rec, _ = R.corner_records(
        *(torch.as_tensor(c) for c in (c0, c2, c1)),
        valid_mask=None if valid is None else torch.as_tensor(valid),
        two_sided=True)
    for to_coeffs in (R.records_to_coeffs, R.records_to_coeffs_depth):
        slab = to_coeffs(rec)[:, None]                     # (N, 1, NC)
        px, py = _lattice(rect, ppt)
        zc = R._covered_z(slab, torch.ones(N, dtype=torch.long), px, py)[:, 0]
        if case == "ties":
            # the record's own z: equal (no win) or one ulp above (a win)
            up = rng.uniform(size=zc.shape) < 0.5
            depth = torch.where(torch.isfinite(zc), torch.where(
                torch.as_tensor(up), torch.nextafter(zc, torch.tensor(INF)),
                zc), torch.tensor(-0.5))
        else:
            depth = torch.as_tensor(rng.uniform(-1, 1, zc.shape),
                                    dtype=torch.float32)
            depth = torch.where(torch.as_tensor(
                rng.uniform(size=zc.shape) < 0.3), INF, depth)
        wins = (zc < depth).flatten(1).any(1)
        rej = R._warp_reject_ref(
            slab[:, 0], torch.as_tensor(rect),
            depth.flatten(1).amax(1))
        assert not bool((rej & wins).any()), \
            f"{int((rej & wins).sum())} winners rejected"
        if case == "dead":
            assert bool(rej[torch.as_tensor(~valid)].all())
        if case in ("random", "far"):
            # the rule is not vacuous: near misses and occluded records go
            assert float(rej.float().mean()) > 0.2


def _scene(W, H):
    t = terrain_init_square_landscape(5, -8.0, 0.0, -8.0, 16.0, 24)
    verts = torch.as_tensor(t.vx)
    faces = torch.as_tensor(t.idx.reshape(-1, 3).astype(np.int32))
    view = mx.mat4_look_at(torch.tensor([6.0, 6.0, 6.0]), torch.zeros(3),
                           torch.tensor([0.0, 1.0, 0.0]))
    proj = mx.mat4_perspective(math.pi / 3, W / H, 0.1, 50.0, device="cpu")
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], -1) \
        @ (proj @ view).T
    rec, ok = R.assemble_tri_records(
        *R.project_to_screen(clip[None], W, H), faces,
        torch.ones((1, faces.shape[0]), dtype=torch.bool))
    return rec, ok


def _walk_warp_reject(monkeypatch, fn, args):
    """Run a plain walk in which each warp's rectangle sees only the
    records it keeps; returns (planes, kept warp-records, all)."""
    walk, covered = R._walk_ref, R._covered_z
    state = {"kept": 0, "all": 0}

    def walk_kept(*a):
        step = a[-1]

        def step_kept(slab, nv, px, py, carry):
            keep = R._warp_keep_ref(slab, nv, px, py, carry[0])
            state["keep"] = keep
            state["kept"] += int(keep.sum())
            state["all"] += int(torch.clamp(nv, max=slab.shape[1]).sum()) * 8
            return step(slab, nv, px, py, carry)
        return walk(*a[:-1], step_kept)

    def covered_kept(slab, nv, px, py):
        zm = covered(slab, nv, px, py)
        A, ch, th, tw = zm.shape
        k = state["keep"].reshape(A, ch, 2, 1, 4, 1).expand(
            A, ch, 2, th // 2, 4, 32).reshape(A, ch, th, tw)
        return torch.where(k, zm, INF)

    with monkeypatch.context() as m:
        m.setattr(R, "_walk_ref", walk_kept)
        m.setattr(R, "_covered_z", covered_kept)
        out = fn(*args)
    return out, state["kept"], state["all"]


@pytest.mark.parametrize("depth_only", [False, True])
@pytest.mark.parametrize("W,H", [(128, 128), (256, 128), (256, 1024)])
def test_walk_with_warp_reject_is_exact(monkeypatch, W, H, depth_only):
    """PPT 4 (8×128 tiles), 8 (16×256) and 16 (32×256)."""
    rec, ok = _scene(W, H)
    args = R.kernel_inputs(rec, R.bin_triangles(rec, ok, W, H), W, H,
                           depth_only=depth_only)
    fn = R.raster_depth_ref if depth_only else R.raster_tile_ref
    full = fn(*args)
    got, kept, total = _walk_warp_reject(monkeypatch, fn, args)
    assert total > 0 and kept < total / 2
    if depth_only:
        assert torch.equal(got, full)
    else:
        assert all(torch.equal(a, b) for a, b in zip(got, full))
