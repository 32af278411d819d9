"""2D cellular automata (counterpart of clap_tpu/ops/ca2d.py).

The reference steps the grid **in place** in scan order (ca2d.c:61-77), so a
cell's neighbor count mixes already-updated and not-yet-updated cells.
``ca2d_step_seq_np`` is the bit-exact numpy port of that sweep; terrain
content generation (scene/terrain.py) runs on it.

The device path uses **synchronous** generations: every cell reads the
previous generation.

- ``ca2d_step`` / ``ca2d_run``: plain batched torch over ``(..., H, W)``
  uint8 grids; ``ca2d_run`` is the plain version of K3.
- ``ca2d_run_fused``: K3, all ``steps`` generations in one hand-written
  CUDA kernel (csrc/ca2d.cu) with the grid resident in shared memory;
  replaces ``_ca2d_kernel`` / ``ca2d_run_pallas`` of the JAX package.

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
    v = torch.randint(0, 8, tuple(shape), generator=generator,
                      device=device, dtype=torch.int32)
    return torch.where(v <= rule.nr_states, rule.nr_states,
                       0).to(torch.uint8)


# ---------------------------------------------------------------------------
# K3: the fused CUDA kernel
# ---------------------------------------------------------------------------

def ca2d_smem_limit(device) -> int:
    """Opt-in shared memory per block of ``device`` (bytes): the largest
    halo'd grid one K3 CTA can hold."""
    from ..cuda_build import load_lib

    idx = torch.device(device).index
    limit = load_lib("ca2d").ca2d_smem_limit(
        torch.cuda.current_device() if idx is None else idx)
    if limit <= 0:
        raise RuntimeError("cannot read the device's shared memory limit")
    return limit


def ca2d_run_fused(rule: CARule, grid: torch.Tensor, steps: int):
    """K3 (replaces clap_tpu/ops/ca2d.py ``_ca2d_kernel`` /
    ``ca2d_run_pallas``): ``steps`` generations in one launch, one CTA per
    grid with the grid resident in shared memory.

    grid: (H, W) or (B, H, W) uint8. CUDA tensors launch the kernel; a
    grid whose halo'd bytes exceed the card's opt-in shared memory per
    block raises ``ValueError``. CPU tensors run the plain version."""
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
    if w > 16384:
        raise ValueError(f"grid width {w} exceeds the kernel's 16384")
    lib = load_lib("ca2d")
    need = lib.ca2d_smem_bytes(h, w)
    limit = ca2d_smem_limit(grid.device)
    if need > limit:
        raise ValueError(
            f"a {h}x{w} grid needs {need} bytes of shared memory in one "
            f"block (the halo'd grid and one row); the limit is the card's "
            f"opt-in shared memory per block, {limit} bytes")
    stream = torch.cuda.current_stream(grid.device).cuda_stream
    rc = lib.ca2d_launch(
        ctypes.c_void_p(g3.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        b, h, w, steps, rule.born_mask & 0xFFFFFFFF,
        rule.surv_mask & 0xFFFFFFFF, rule.nr_states, int(rule.decay),
        NEIGH_MODES.index(rule.neigh), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"ca2d_run_fused launch failed: CUDA error {rc}")
    ca2d_run_fused.launches += 1
    return out[0] if grid.dim() == 2 else out


ca2d_run_fused.launches = 0
