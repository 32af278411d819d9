"""2D cellular automata (counterpart of clap_tpu/ops/ca2d.py).

The reference steps the grid **in place** in scan order (ca2d.c:61-77), so a
cell's neighbor count mixes already-updated and not-yet-updated cells.
``ca2d_step_seq_np`` is the bit-exact numpy port of that sweep; terrain
content generation (scene/terrain.py) runs on it.

The device path uses **synchronous** generations: every cell reads the
previous generation.

- ``ca2d_step`` / ``ca2d_run``: plain batched torch over ``(..., H, W)``
  uint8 grids; ``ca2d_run`` is the plain version of K3.
- ``ca2d_run_fused``: K3, the hand-written CUDA kernel (csrc/ca2d.cu),
  four cells to a word, all ``steps`` generations in one launch with the
  grid resident in shared memory (over a thread-block cluster, or one CTA
  per grid), or one launch per generation for a grid no cluster holds;
  ``ca2d_plan`` picks the route. Replaces ``_ca2d_kernel`` /
  ``ca2d_run_pallas`` of the JAX package.

Rule encoding matches struct cell_automaton (ca-common.h): ``born_mask`` /
``surv_mask`` are bitmasks over neighbor counts; a dead cell with count n is
born at value ``nr_states`` when born bit n is set; a live cell survives
unchanged when surv bit n is set, else decays by 1 if ``decay``.

Out-of-bounds neighbors read as 0 (zero boundary, not torus).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.frand import Rand48


@dataclass(frozen=True)
class CARule:
    """struct cell_automaton (ca-common.h)."""

    name: str
    born_mask: int
    surv_mask: int
    nr_states: int
    decay: bool = False
    neigh: str = "m1"  # m1 | vn1 | mv | vnv


def _ca_range(start: int, end: int) -> int:
    """CA_RANGE (ca3d.h:38): bits [start, end) — note end-exclusive."""
    return ((1 << (end - start)) - 1) << start


# Rules used by the reference content pipeline (terrain.c:393-415)
CA_TEST = CARule("test", born_mask=3 << 2, surv_mask=3 << 7, nr_states=4,
                 decay=True, neigh="m1")
CA_COOL_TREE = CARule("cool tree", born_mask=0x1E, surv_mask=0xFF,
                      nr_states=20, decay=False, neigh="mv")
CA_ASH_PINUS = CARule("ash pinus", born_mask=0xFFFFFF, surv_mask=0xFFFFFF,
                      nr_states=21, decay=False, neigh="mv")


def _np_get(arr: np.ndarray, x: int, y: int) -> int:
    side_y, side_x = arr.shape
    if x < 0 or x >= side_x or y < 0 or y >= side_y:
        return 0
    return int(arr[y, x])


def _np_neigh(arr: np.ndarray, x: int, y: int, neigh: str) -> int:
    v = _np_get(arr, x, y)
    vn = [(1, 0), (-1, 0), (0, 1), (0, -1)]
    diag = [(1, 1), (-1, 1), (1, -1), (-1, -1)]
    offs = vn if neigh in ("vn1", "vnv") else vn + diag
    if neigh in ("vn1", "m1"):
        return sum(1 for dx, dy in offs if _np_get(arr, x + dx, y + dy) != 0)
    return sum(1 for dx, dy in offs if _np_get(arr, x + dx, y + dy) > v)


def ca2d_step_seq_np(rule: CARule, arr: np.ndarray) -> np.ndarray:
    """Exact port of ca2d_step (ca2d.c:61-77): in-place, x-major scan."""
    arr = arr.copy()
    side = arr.shape[0]
    for x in range(side):
        for y in range(side):
            n = _np_neigh(arr, x, y, rule.neigh)
            v = int(arr[y, x])
            if v == 0 and (rule.born_mask >> n) & 1:
                arr[y, x] = rule.nr_states
            elif v != 0 and (rule.surv_mask >> n) & 1:
                pass
            elif v != 0 and rule.decay:
                arr[y, x] = v - 1
    return arr


def ca2d_seed_np(rule: CARule, side: int, rng: Rand48) -> np.ndarray:
    """Exact port of the ca2d_generate seeding loop (ca2d.c:85-92)."""
    arr = np.zeros((side, side), dtype=np.uint8)
    for x in range(side):
        for y in range(side):
            v = rng.lrand48() % 8
            arr[y, x] = rule.nr_states if v <= rule.nr_states else 0
    return arr


def ca2d_generate_np(rule: CARule, side: int, steps: int, rng: Rand48) -> np.ndarray:
    """Exact port of ca2d_generate (ca2d.c:79-98)."""
    arr = ca2d_seed_np(rule, side, rng)
    for _ in range(steps):
        arr = ca2d_step_seq_np(rule, arr)
    return arr


# ---------------------------------------------------------------------------
# synchronous torch step (batched) — the plain version of K3
# ---------------------------------------------------------------------------

_VN_OFFS = ((0, 1), (0, -1), (1, 0), (-1, 0))
_DIAG_OFFS = ((1, 1), (1, -1), (-1, 1), (-1, -1))
NEIGH_MODES = ("m1", "vn1", "mv", "vnv")     # the kernel's mode numbers


def mask_table(mask: int, n_max: int, device=None) -> torch.Tensor:
    """(n_max + 1,) bool: bit n of ``mask`` for every neighbor count n."""
    return torch.tensor([bool((mask >> n) & 1) for n in range(n_max + 1)],
                        dtype=torch.bool, device=device)


def _neigh_count(v, neigh: str):
    """Neighbor count of an int32 (..., H, W) grid, zero boundary."""
    h, w = v.shape[-2:]
    p = F.pad(v, (1, 1, 1, 1))
    offs = _VN_OFFS if neigh in ("vn1", "vnv") else _VN_OFFS + _DIAG_OFFS
    n = torch.zeros_like(v)
    for dy, dx in offs:
        nb = p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        n += (nb != 0) if neigh in ("vn1", "m1") else (nb > v)
    return n


def ca2d_step(rule: CARule, grid: torch.Tensor) -> torch.Tensor:
    """One synchronous generation. grid: (..., H, W) uint8."""
    v = grid.to(torch.int32)
    n = _neigh_count(v, rule.neigh).long()
    born = (v == 0) & mask_table(rule.born_mask, 8, v.device)[n]
    surv = (v != 0) & mask_table(rule.surv_mask, 8, v.device)[n]
    out = torch.where(born, rule.nr_states, v)
    if rule.decay:
        out = torch.where((v != 0) & ~surv, v - 1, out)
    return out.to(torch.uint8)


def ca2d_run(rule: CARule, grid: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` synchronous generations (the plain version of K3)."""
    out = grid.clone()
    for _ in range(steps):
        out = ca2d_step(rule, out)
    return out


def ca2d_seed(rule: CARule, shape, generator=None, device=None):
    """Batched seeding with the C distribution (lrand48() % 8 <= nr_states
    → nr_states, ca2d.c:88-91), drawn from a torch generator (not the
    JAX package's stream)."""
    device = resolve_device(device)
    v = torch.randint(0, 8, tuple(shape), generator=generator,
                      device=device, dtype=torch.int32)
    return torch.where(v <= rule.nr_states, rule.nr_states,
                       0).to(torch.uint8)


# ---------------------------------------------------------------------------
# K3's packed arithmetic in plain torch: the kernel's per-word formulas,
# for the tests (debugging the byte tricks needs no card)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_H7, _H8, _L1 = 0x7F7F7F7F, 0x80808080, 0x01010101


def _pack(grid):
    """(..., H, W) uint8 → (..., H, ceil(W / 4)) int64 words of 32 bits:
    cell x is byte x % 4 of word x // 4 (little-endian); pad bytes are 0."""
    w = grid.shape[-1]
    ww = -(-w // 4)
    g = F.pad(grid.to(torch.int64), (0, 4 * ww - w))
    g = g.reshape(*grid.shape[:-1], ww, 4)
    return g[..., 0] | g[..., 1] << 8 | g[..., 2] << 16 | g[..., 3] << 24


def _unpack(words, w: int):
    b = torch.stack([(words >> (8 * k)) & 0xFF for k in range(4)], -1)
    return b.reshape(*words.shape[:-1], -1)[..., :w].to(torch.uint8)


def _nz(x):
    """1 in every byte of x that is not 0."""
    return ((((x & _H7) + _H7) | x) & _H8) >> 7


def _gt(a, v):
    """1 in every byte where a > v (unsigned): the carry out of
    a + ~v, from the low 7 bits' sum and a majority of the top bits."""
    nv = ~v & _M32
    s = (a & _H7) + (nv & _H7)
    return (((a & nv) | (a & s) | (nv & s)) & _H8) >> 7


def _funnel_l(lo, hi):
    """__funnelshift_l(lo, hi, 8): cell x - 1 in the place of cell x."""
    return ((hi << 8) | (lo >> 24)) & _M32


def _funnel_r(lo, hi):
    """__funnelshift_r(lo, hi, 8): cell x + 1 in the place of cell x."""
    return ((lo >> 8) | (hi << 24)) & _M32


def _table(mask: int):
    """A mask as the kernel's lookup: bytes for counts 0-7 in two words,
    count 8 as 0x01 in every byte or 0."""
    bit = [(mask >> k) & 1 for k in range(9)]
    lo = sum(bit[k] << (8 * k) for k in range(4))
    hi = sum(bit[k + 4] << (8 * k) for k in range(4))
    return lo, hi, _L1 * bit[8]


def _lookup(table, n):
    """Bit n of the mask in every byte (counts n <= 8): __byte_perm on the
    8-byte table with the counts' low 3 bits as selector nibbles, then
    count 8 patched in."""
    lo, hi, b8 = table
    m = n & 0x07070707
    t = m | (m >> 4)
    sel = (t & 0xFF) | ((t >> 8) & 0xFF00)           # nibble k = count k
    perm = torch.zeros_like(n)
    for k in range(4):
        idx = (sel >> (4 * k)) & 7
        src = torch.where(idx < 4, torch.full_like(n, lo),
                          torch.full_like(n, hi))
        perm |= ((src >> (8 * (idx & 3))) & 0xFF) << (8 * k)
    eight = (n >> 3) & _L1
    return (perm & ~eight & _M32) | (eight & b8)


def _col_mask(ww: int, w: int, like):
    """Per word column: 0xFF in the bytes that hold cells, 0 in the pad
    bytes of the last word."""
    valid = w - 4 * (ww - 1)
    last = (1 << (8 * valid)) - 1
    m = torch.full((ww,), _M32, dtype=like.dtype, device=like.device)
    m[-1] = last
    return m


def _packed_step_ref(rule: CARule, words, w: int):
    """One synchronous generation on packed words (..., H, WW), by the
    kernel's formulas: a zero word and row around the grid; per row the
    words L, C, R; for m1 / vn1 the nonzero bit of every byte, its
    neighbours' bits shifted in (the row sum of three, reused by three
    rows), the column sum minus the centre; for mv / vnv the neighbours'
    raw bytes through the funnel shifts and a byte compare; then the
    born / survive lookup, a birth adding ``nr_states``, a decay
    subtracting 1, and the pad bytes kept at 0 (never born)."""
    ww = words.shape[-1]
    p = F.pad(words, (1, 1, 1, 1))

    def feat(r):
        L, C, R = r[..., :-2], r[..., 1:-1], r[..., 2:]
        if rule.neigh in ("m1", "vn1"):
            b = _nz(C)
            side = (((b << 8) & _M32) | ((L >> 24) != 0).long()) \
                + ((b >> 8) | (((R & 0xFF) != 0).long() << 24))
            return (b + side if rule.neigh == "m1" else side), b, C
        return _funnel_l(L, C), C, _funnel_r(C, R)

    u, m, d = feat(p[..., :-2, :]), feat(p[..., 1:-1, :]), feat(p[..., 2:, :])
    if rule.neigh == "m1":
        n, v = u[0] + m[0] + d[0] - m[1], m[2]
    elif rule.neigh == "vn1":
        n, v = u[1] + m[0] + d[1], m[2]
    else:
        v = m[1]
        n = _gt(u[1], v) + _gt(m[0], v) + _gt(m[2], v) + _gt(d[1], v)
        if rule.neigh == "mv":
            n = n + _gt(u[0], v) + _gt(u[2], v) + _gt(d[0], v) + _gt(d[2], v)
    alive = _nz(v)
    born = _lookup(_table(rule.born_mask), n) & ~alive & _col_mask(ww, w, v)
    out = v + born * (rule.nr_states & 0xFF)
    if rule.decay:
        out = out - (alive & ~_lookup(_table(rule.surv_mask), n))
    return out


# ---------------------------------------------------------------------------
# K3: the CUDA kernel, its routes and its planner
# ---------------------------------------------------------------------------

CLUSTER_THREADS = 1024   # threads of a cluster-route CTA (ca2d.cu kThreads)
INPLACE_THREADS = 256    # threads of an in-place CTA (kInplaceThreads)
INPLACE_RUN = 16         # rows an in-place thread holds (kInplaceRun)
GLOBAL_BAND = 16         # rows per CTA on the device-memory route
GLOBAL_RUN = 4           # rows a thread walks there (kGlobalRun)


@dataclass(frozen=True)
class CA2DPlan:
    """How K3 runs a (b, h, w) batch: ``route`` "cluster" (each grid in
    row bands over a thread-block cluster of ``cluster`` CTAs, two shared
    buffers each, halo rows read from the neighbours' shared memory),
    "inplace" (one CTA per grid, one shared buffer stepped in place) or
    "global" (one launch per generation over two packed buffers in device
    memory, ``cluster`` CTAs per grid). ``bands`` are the rows of each
    CTA's band; a thread walks ``run`` rows of one word column per item;
    ``smem`` is the dynamic shared memory of one CTA in bytes."""

    b: int
    h: int
    w: int
    route: str
    cluster: int
    bands: tuple
    run: int
    smem: int


def _bands(h: int, n: int) -> tuple:
    """Rows of band i of n over h rows: [i·h // n, (i+1)·h // n)."""
    return tuple((i + 1) * h // n - i * h // n for i in range(n))


def ca2d_plan(b: int, h: int, w: int, smem_limit: int, max_cluster: int,
              n_sms: int = 132, cluster: int | None = None) -> CA2DPlan:
    """K3's route from the shapes and the card's attributes (its opt-in
    shared memory per block, its largest schedulable cluster and its SM
    count), chosen before the launch.

    cluster: the smallest power-of-two cluster whose bands fit in shared
    memory and that gives the card at least ``n_sms`` CTAs with ``b``
    grids; with too few grids for that, the largest that fits. When that
    is one CTA per grid, the grid is stepped in place (one buffer and a
    saved row: three 256² grids per SM, where two buffers allow one; 13 %
    faster on the 1,024 × 256² batch on an H100, PERF.md) if its width
    has at most ``INPLACE_THREADS`` words. A grid that no cluster holds
    takes the device-memory route. ``cluster`` forces a cluster size on
    the two-buffer route, which must fit (``ValueError`` otherwise)."""
    ww = -(-w // 4)
    pitch = 4 * (ww + 2)         # bytes of a packed row and its zero words

    def cluster_smem(cs):        # two buffers of the largest band, a zero row
        return (2 * -(-h // cs) + 1) * pitch

    sizes = [1 << k for k in range(max_cluster.bit_length())
             if 1 << k <= min(max_cluster, h)]
    fits = [cs for cs in sizes if cluster_smem(cs) <= smem_limit]
    if cluster is not None:
        if cluster not in fits:
            raise ValueError(
                f"cluster {cluster} for a {h}x{w} grid: sizes that fit "
                f"are {fits} (largest schedulable {max_cluster}, "
                f"{smem_limit} bytes of shared memory per block)")
        cs = cluster
    elif not fits:
        n = -(-h // GLOBAL_BAND)
        return CA2DPlan(b, h, w, "global", n, _bands(h, n), GLOBAL_RUN, 0)
    else:
        enough = [cs for cs in fits if b * cs >= n_sms]
        cs = enough[0] if enough else fits[-1]
        if cs == 1 and ww <= INPLACE_THREADS:
            # the grid, a saved row and a zero row: less than two buffers
            return CA2DPlan(b, h, w, "inplace", 1, (h,), INPLACE_RUN,
                            (h + 2) * pitch)
    bands = _bands(h, cs)
    run = max(1, -(-max(bands) * ww // CLUSTER_THREADS))
    return CA2DPlan(b, h, w, "cluster", cs, bands, run, cluster_smem(cs))


_CARDS = {}


def ca2d_card(device) -> tuple:
    """(opt-in shared memory per block, largest cluster size the card
    schedules for K3 — the largest power of two up to 16 for which
    cudaOccupancyMaxActiveClusters is > 0 —, SM count) of ``device``."""
    from ..cuda_build import load_lib

    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _CARDS:
        lib = load_lib("ca2d")
        limit = lib.ca2d_smem_limit(idx)
        if limit <= 0:
            raise RuntimeError("cannot read the device's shared memory limit")
        cap, why = 0, []
        for cs in (16, 8, 4, 2, 1):
            n = lib.ca2d_active_clusters(idx, cs, limit)
            if n > 0:
                cap = cs
                break
            why.append(f"{cs}: " + (_cuda_error(lib, -n) if n else "0"))
        if cap == 0:
            raise RuntimeError(f"the card schedules no K3 cluster "
                               f"(cudaOccupancyMaxActiveClusters {why})")
        _CARDS[idx] = (limit, cap, torch.cuda.get_device_properties(
            idx).multi_processor_count)
    return _CARDS[idx]


def _cuda_error(lib, rc: int) -> str:
    return f"CUDA error {rc} ({lib.ca2d_error_string(rc).decode()})"


def ca2d_run_fused(rule: CARule, grid: torch.Tensor, steps: int,
                   plan: CA2DPlan | None = None):
    """K3 (replaces clap_tpu/ops/ca2d.py ``_ca2d_kernel`` /
    ``ca2d_run_pallas``): ``steps`` generations of ``rule``.

    grid: (H, W) or (B, H, W) uint8. CUDA tensors launch the kernel on the
    route of ``plan`` (``ca2d_plan`` of the shapes and the card unless
    given): one launch on the shared-memory routes, ``steps`` + 2 on the
    device-memory route, each counted in ``ca2d_run_fused.launches``. A
    launch the card refuses raises ``RuntimeError``; nothing falls back.
    CPU tensors run the plain version."""
    if grid.dtype != torch.uint8 or grid.dim() not in (2, 3):
        raise ValueError(f"grid must be (H, W) or (B, H, W) uint8, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if not grid.is_cuda:
        return ca2d_run(rule, grid, steps)
    from ..cuda_build import load_lib

    if not grid.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    g3 = grid[None] if grid.dim() == 2 else grid
    b, h, w = g3.shape
    out = torch.empty_like(g3)
    if out.numel() == 0:                      # nothing to step: no launch
        return out[0] if grid.dim() == 2 else out
    if plan is None:
        plan = ca2d_plan(b, h, w, *ca2d_card(grid.device))
    elif (plan.b, plan.h, plan.w) != (b, h, w):
        raise ValueError(f"plan for {(plan.b, plan.h, plan.w)}, grid "
                         f"{(b, h, w)}")
    lib = load_lib("ca2d")
    rule_args = (rule.born_mask & _M32, rule.surv_mask & _M32,
                 rule.nr_states & 0xFF, int(rule.decay),
                 NEIGH_MODES.index(rule.neigh))
    stream = ctypes.c_void_p(torch.cuda.current_stream(grid.device)
                             .cuda_stream)
    src, dst = ctypes.c_void_p(g3.data_ptr()), ctypes.c_void_p(out.data_ptr())
    if plan.route == "global":
        words = torch.empty((2, b, h + 2, -(-w // 4) + 2), dtype=torch.int32,
                            device=grid.device)
        rc = lib.ca2d_global_launch(src, dst, ctypes.c_void_p(
            words.data_ptr()), b, h, w, steps, *rule_args, plan.cluster,
            stream)
        launches = steps + 2
    else:
        rc = lib.ca2d_launch(src, dst, b, h, w, steps, *rule_args,
                             int(plan.route == "inplace"), plan.cluster,
                             plan.run, plan.smem, stream)
        launches = 1
    if rc != 0:
        raise RuntimeError(f"ca2d_run_fused ({plan.route} route, cluster "
                           f"{plan.cluster}): {_cuda_error(lib, rc)}")
    ca2d_run_fused.launches += launches
    return out[0] if grid.dim() == 2 else out


ca2d_run_fused.launches = 0
