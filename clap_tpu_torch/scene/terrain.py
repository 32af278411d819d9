"""Procedural terrain generation (reference: core/terrain.c).

Host-side content pipeline (numpy): runs once at scene build, uploads the
resulting heightfield + mesh as device constants. Replicates the C
pipeline bit-for-bit where it feeds gameplay:

1. ca2d maze at ``nr_v/8`` resolution, 4 steps of the ``ca_test`` rule
   (terrain.c:391-398, 434) — sequential in-place semantics.
2. Value-noise lattice ``map0[x][z]`` from per-point reseeded drand48
   (get_rand_height terrain.c:15-19).
3. 3x3 smoothing kernel (corners/16 + sides/8 + self/4, get_avg_height
   terrain.c:35-53) with the C's edge mapping: x<0 → nr_v-1, x>=nr_v → 0
   (get_mapped_rand_height terrain.c:21-33) — NOT a true torus for
   indices ≥ nr_v+1; replicated exactly.
4. 4-octave cosine-interpolated fBm, ROUGHNESS=0.5, freq 2^i/2^(oct-1)
   (get_interp_height/get_height terrain.c:56-92).
5. Maze-modulated amplitude: per-vertex ``amp = 1.5^avg`` where avg is a
   cosine blend of the 8x8 maze cell values (terrain.c:448-467). The BSP
   partition is computed by the reference but its per-region amp/oct are
   dead (xfrac/yfrac are overwritten, terrain.c:452-455); we skip the BSP
   entirely — it consumes no rand state that feeds the map (bsp uses its
   own re-seeded stream).
6. Grid mesh + border-zeroed central-difference normals + 32x tiled UVs
   (terrain.c:491-519), two triangles per cell (terrain.c:521-534).
7. Instantiator placement: two more sequential CA steps on the maze
   ("cool tree"/"ash pinus" terrain.c:400-415, 538-543); cells matching
   each rule's nr_states spawn entities at cell centers (terrain.c:555-570).

The heightfield layout is ``H[x, z]`` (matching map[x*nr_v+z]).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.ca2d import CA_TEST, CA_COOL_TREE, CA_ASH_PINUS, ca2d_generate_np, ca2d_step_seq_np
from ..utils.frand import Rand48, hash_height

OCTAVES = 4
ROUGHNESS = 0.5
MAZE_FAC = 8


@dataclass
class Terrain:
    seed: int
    x: float
    y: float
    z: float
    side: float
    nr_vert: int
    heights: np.ndarray            # (nr_v, nr_v) float32, [x][z], includes +y
    normals_grid: np.ndarray       # (nr_v, nr_v, 3) float32, [x][z]
    maze: np.ndarray               # post-instantiator maze state [y][x]
    # mesh (row i = z axis, col j = x axis, terrain.c:491-519)
    vx: np.ndarray = field(default=None)       # (nr_v*nr_v, 3)
    norm: np.ndarray = field(default=None)     # (nr_v*nr_v, 3)
    uv: np.ndarray = field(default=None)       # (nr_v*nr_v, 2)
    idx: np.ndarray = field(default=None)      # (ntri*3,) int32
    instantiators: list = field(default_factory=list)  # (name, dx, dy, dz)


def _cmap(idx: np.ndarray, n: int) -> np.ndarray:
    """get_mapped_rand_height's index mapping (terrain.c:21-33)."""
    out = np.where(idx < 0, n - 1, idx)
    return np.where(out >= n, 0, out)


def _cos_interp(a, b, t):
    f = (1.0 - np.cos(t * np.pi)) / 2.0
    return a * (1.0 - f) + b * f


def _avg_lattice(map0: np.ndarray, n: int) -> np.ndarray:
    """A[e_x, e_z] for e in [0, n]: the smoothed lattice (terrain.c:35-53),
    evaluated on the extended grid covering every floor()+1 the fBm can
    reach."""
    e = np.arange(n + 1)
    A = np.zeros((n + 1, n + 1))
    for dx, dz, w in (
        (-1, -1, 1 / 16), (1, -1, 1 / 16), (-1, 1, 1 / 16), (1, 1, 1 / 16),
        (-1, 0, 1 / 8), (1, 0, 1 / 8), (0, -1, 1 / 8), (0, 1, 1 / 8),
        (0, 0, 1 / 4),
    ):
        xi = _cmap(e + dx, n)
        zi = _cmap(e + dz, n)
        A += w * map0[np.ix_(xi, zi)]
    return A


def _interp_height(A: np.ndarray, xs: np.ndarray, zs: np.ndarray, n: int) -> np.ndarray:
    """get_interp_height (terrain.c:56-71) vectorized over coord grids."""
    ix = np.floor(xs).astype(np.int64)
    iz = np.floor(zs).astype(np.int64)
    fx = xs - ix
    fz = zs - iz
    v1 = A[ix, iz]
    v2 = A[ix + 1, iz]
    v3 = A[ix, iz + 1]
    v4 = A[ix + 1, iz + 1]
    i1 = _cos_interp(v1, v2, fx)
    i2 = _cos_interp(v3, v4, fx)
    return _cos_interp(i1, i2, fz)


def _maze_get(maze: np.ndarray, x, z):
    """xyarray_get with 0 OOB; maze stored [y][x]."""
    side = maze.shape[0]
    x = np.asarray(x)
    z = np.asarray(z)
    valid = (x >= 0) & (x < side) & (z >= 0) & (z < side)
    xc = np.clip(x, 0, side - 1)
    zc = np.clip(z, 0, side - 1)
    return np.where(valid, maze[zc, xc], 0).astype(np.float64)


def _maze_amp(maze: np.ndarray, nr_v: int):
    """avg grid (terrain.c:448-466): cosine blend of maze cell values."""
    i = np.arange(nr_v)[:, None]  # x index
    j = np.arange(nr_v)[None, :]  # z index
    xfrac = (i % MAZE_FAC) / MAZE_FAC
    yfrac = (j % MAZE_FAC) / MAZE_FAC
    xpos = i // MAZE_FAC
    ypos = j // MAZE_FAC
    xfrac_b = np.broadcast_to(xfrac, (nr_v, nr_v))
    yfrac_b = np.broadcast_to(yfrac, (nr_v, nr_v))
    xpos_b = np.broadcast_to(xpos, (nr_v, nr_v))
    ypos_b = np.broadcast_to(ypos, (nr_v, nr_v))
    cn = _maze_get(maze, xpos_b, ypos_b)
    xn = _maze_get(maze, np.where(xfrac_b >= 0.5, xpos_b + 1, xpos_b - 1), ypos_b)
    yn = _maze_get(maze, xpos_b, np.where(yfrac_b >= 0.5, ypos_b + 1, ypos_b - 1))
    xavg = np.where(cn > xn, cn, _cos_interp(cn, xn, 2 * xfrac_b - 1))
    yavg = np.where(cn > yn, cn, _cos_interp(cn, yn, 2 * yfrac_b - 1))
    return _cos_interp(xavg, yavg, np.abs(xfrac_b - yfrac_b))


def terrain_heights(seed: int, y: float, nr_v: int, maze: np.ndarray) -> np.ndarray:
    """The map[] computation (terrain.c:445-467): H[x, z] float64."""
    xs = np.arange(nr_v, dtype=np.int64)
    map0 = hash_height(seed, xs[:, None], xs[None, :])  # map0[x][z]
    A = _avg_lattice(map0, nr_v)

    i = np.arange(nr_v, dtype=np.float64)[:, None]
    j = np.arange(nr_v, dtype=np.float64)[None, :]
    d = 2.0 ** (OCTAVES - 1)
    S = np.zeros((nr_v, nr_v))
    for o in range(OCTAVES):
        freq = (2.0 ** o) / d
        amp = ROUGHNESS ** o
        S += amp * _interp_height(A, np.broadcast_to(i * freq, (nr_v, nr_v)),
                                  np.broadcast_to(j * freq, (nr_v, nr_v)), nr_v)
    avg = _maze_amp(maze, nr_v)
    return y + (1.5 ** avg) * S + avg


def _calc_normals(H: np.ndarray) -> np.ndarray:
    """calc_normal (terrain.c:94-110): border-zeroed central differences,
    N = normalize(hl-hr, 2, hd-hu). H is [x][z]; returns (n, n, 3)."""
    n = H.shape[0]
    hl = np.zeros_like(H)
    hr = np.zeros_like(H)
    hd = np.zeros_like(H)
    hu = np.zeros_like(H)
    hl[1:, :] = H[:-1, :]
    hr[:-1, :] = H[1:, :]
    hd[:, 1:] = H[:, :-1]
    hu[:, :-1] = H[:, 1:]
    nx = hl - hr
    ny = np.full_like(H, 2.0)
    nz = hd - hu
    v = np.stack([nx, ny, nz], axis=-1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def terrain_height_np(t: Terrain, x, z):
    """terrain_height (terrain.c:336-379): barycentric interp, 0 OOB."""
    x = np.asarray(x, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    n = t.nr_vert
    square = float(t.side) / (n - 1)
    tx = x - t.x
    tz = z - t.z
    gx = np.floor(tx / square).astype(np.int64)
    gz = np.floor(tz / square).astype(np.int64)
    xoff = (tx - square * gx) / square
    zoff = (tz - square * gz) / square
    oob = (x < t.x) | (x > t.x + t.side) | (z < t.z) | (z > t.z + t.side)
    gxc = np.clip(gx, 0, n - 2)
    gzc = np.clip(gz, 0, n - 2)
    h00 = t.heights[gxc, gzc]
    h10 = t.heights[gxc + 1, gzc]
    h01 = t.heights[gxc, gzc + 1]
    h11 = t.heights[gxc + 1, gzc + 1]
    lower = xoff <= 1 - zoff
    # lower tri: (0,h00,0) (1,h10,0) (0,h01,1); upper: (1,h10,0) (1,h11,1) (0,h01,1)
    h_lower = h00 + (h10 - h00) * xoff + (h01 - h00) * zoff
    # upper triangle barycentric over x/z
    h_upper = h10 + (h11 - h10) * zoff + (h01 - h11) * (1 - xoff)
    h = np.where(lower, h_lower, h_upper)
    return np.where(oob, 0.0, h)


def terrain_init_square_landscape(
    seed: int,
    x: float,
    y: float,
    z: float,
    side: float,
    nr_v: int,
    rng: Rand48 | None = None,
) -> Terrain:
    """terrain_init_square_landscape (terrain.c:418-574), host-side."""
    rng = rng or Rand48(seed)
    mside = nr_v // MAZE_FAC
    maze = ca2d_generate_np(CA_TEST, mside, 4, rng)

    H = terrain_heights(seed, y, nr_v, maze)
    N = _calc_normals(H)

    t = Terrain(seed=seed, x=x, y=y, z=z, side=side, nr_vert=nr_v,
                heights=H.astype(np.float32), normals_grid=N.astype(np.float32),
                maze=maze)

    # mesh (terrain.c:491-534): row i = z axis, col j = x axis
    jj, ii = np.meshgrid(np.arange(nr_v), np.arange(nr_v))  # ii rows, jj cols
    px = x + jj / (nr_v - 1.0) * side
    py = y + H[jj, ii]  # t->map[j*nr_v + i]
    pz = z + ii / (nr_v - 1.0) * side
    t.vx = np.stack([px, py, pz], axis=-1).reshape(-1, 3).astype(np.float32)
    t.norm = N[jj, ii].reshape(-1, 3).astype(np.float32)
    t.uv = np.stack([jj * 32.0 / (nr_v - 1), ii * 32.0 / (nr_v - 1)],
                    axis=-1).reshape(-1, 2).astype(np.float32)

    c = np.arange(nr_v - 1)
    tl = (c[:, None] * nr_v + c[None, :]).reshape(-1)  # i*nr_v + j
    tr = tl + 1
    bl = tl + nr_v
    br = bl + 1
    t.idx = np.stack([tl, bl, tr, tr, bl, br], axis=-1).reshape(-1).astype(np.int32)

    # instantiators (terrain.c:538-570)
    for rule in (CA_COOL_TREE, CA_ASH_PINUS):
        maze = ca2d_step_seq_np(rule, maze)
    t.maze = maze
    for rule in (CA_COOL_TREE, CA_ASH_PINUS):
        iy, ix_ = np.nonzero(maze.T == rule.nr_states)  # maze.T[x][y] -> get(maze,i,j)
        for i_, j_ in zip(iy, ix_):
            dx = x + (i_ + 0.5) * MAZE_FAC * side / (nr_v - 1)
            dz = z + (j_ + 0.5) * MAZE_FAC * side / (nr_v - 1)
            dy = float(terrain_height_np(t, dx, dz))
            t.instantiators.append((rule.name, dx, dy, dz))
    return t
