"""3D cellular automata (counterpart of clap_tpu/ops/ca3d.py; reference:
core/ca3d.c).

Same split as ca2d: the C code steps in place in scan order (ca3d_run,
ca3d.c:124-142); the device path uses synchronous generations. ca3d_run
always counts Moore-26 neighbors regardless of the rule's configured
neighborhood function (ca3d.c:131 hardcodes ca3d_neighbors_m1), and so
does this module. Rule semantics differ from ca2d: not-surviving cells
always decay by 1, and born cells start at ``nr_states - 1``
(ca3d.c:133-138).

- ``ca3d_step`` / ``ca3d_run`` / ``ca3d_prune`` / ``ca3d_count``: plain
  batched torch over ``(..., D, H, W)`` uint8 grids (the JAX package runs
  these through XLA; there is no kernel).
- ``ca3d_run_seq_np``, ``ca3d_walk_np``, ``ca3d_make_np``: numpy copies of
  the JAX package's host-side reference and cave generator, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.frand import Rand48
from .ca2d import CARule, _ca_range, mask_table

# The 9 named rulesets (ca3d.c:110-122). Masks use CA_n = 1<<n.
_B = lambda *bits: sum(1 << b for b in bits)  # noqa: E731

CA3D_RULES = (
    CARule("ca_445m", born_mask=_B(4), surv_mask=_B(4), nr_states=5),
    CARule("ca_678_678_3m", born_mask=_B(6, 7, 8), surv_mask=_B(6, 7, 8),
           nr_states=3),
    CARule("ca_pyroclastic", born_mask=_B(6, 7, 8), surv_mask=_B(4, 5, 6, 7),
           nr_states=10),
    CARule("ca_amoeba", born_mask=_B(5, 6, 7, 12, 13, 15),
           surv_mask=_ca_range(9, 26), nr_states=5),
    CARule("ca_builder", born_mask=_B(4, 6, 8, 9), surv_mask=_B(2, 6, 9),
           nr_states=10),
    CARule("ca_slow_decay", born_mask=_ca_range(13, 26),
           surv_mask=_B(1, 4, 8, 11) | _ca_range(13, 26), nr_states=5),
    CARule("ca_spiky_growth",
           born_mask=_B(4, 13, 17, 26) | _ca_range(20, 24),
           surv_mask=_ca_range(0, 3) | _ca_range(7, 9) | _ca_range(11, 13)
           | _B(18, 21, 22, 24, 26),
           nr_states=4),
    CARule("ca_coral", born_mask=_ca_range(6, 7) | _B(9, 12),
           surv_mask=_ca_range(5, 8), nr_states=4),
    CARule("ca_crystal_1", born_mask=_B(1, 3), surv_mask=_ca_range(0, 6),
           nr_states=2, neigh="vn1"),
)


# ---------------------------------------------------------------------------
# numpy sequential reference
# ---------------------------------------------------------------------------

def _np_get3(arr, x, y, z):
    dz, dy_, dx = arr.shape
    if x < 0 or x >= dx or y < 0 or y >= dy_ or z < 0 or z >= dz:
        return 0
    return int(arr[z, y, x])


def _np_m26(arr, x, y, z):
    n = 0
    for cz in range(z - 1, z + 2):
        for cy in range(y - 1, y + 2):
            for cx in range(x - 1, x + 2):
                n += _np_get3(arr, cx, cy, cz) != 0
    n -= _np_get3(arr, x, y, z) != 0
    return n


def ca3d_run_seq_np(rule: CARule, arr: np.ndarray, steps: int) -> np.ndarray:
    """Exact port of ca3d_run (ca3d.c:124-142). arr: (D2, D1, D0) i.e.
    [z, y, x] to mirror xyzarray's z-major layout."""
    arr = arr.astype(np.int32).copy()
    dz, dy_, dx = arr.shape
    for _ in range(steps):
        for z in range(dz):
            for y in range(dy_):
                for x in range(dx):
                    n = _np_m26(arr, x, y, z)
                    state = int(arr[z, y, x])
                    if state != 0 and not ((rule.surv_mask >> n) & 1):
                        arr[z, y, x] = state - 1
                    elif state == 0 and ((rule.born_mask >> n) & 1):
                        arr[z, y, x] = rule.nr_states - 1
    return arr.astype(np.uint8)


# ---------------------------------------------------------------------------
# synchronous torch versions (batched over leading axes)
# ---------------------------------------------------------------------------

def _shift3d(v, dz, dy, dx):
    """result[z, y, x] = v[z+dz, y+dy, x+dx], zero outside the grid."""
    d, h, w = v.shape[-3:]
    p = F.pad(v, (1, 1, 1, 1, 1, 1))
    return p[..., 1 + dz:1 + dz + d, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _m26_count(v):
    """Moore-26 count of nonzero neighbors, separable: the 3×3×3 box sum is
    three 1-D passes, minus the center."""
    b = (v != 0).to(v.dtype)
    s = b + _shift3d(b, 0, 0, 1) + _shift3d(b, 0, 0, -1)
    s = s + _shift3d(s, 0, 1, 0) + _shift3d(s, 0, -1, 0)
    s = s + _shift3d(s, 1, 0, 0) + _shift3d(s, -1, 0, 0)
    return s - b


def ca3d_step(rule: CARule, grid: torch.Tensor) -> torch.Tensor:
    """One synchronous ca3d_run generation. grid: (..., D, H, W) uint8."""
    v = grid.to(torch.int32)
    n = _m26_count(v).long()
    surv = mask_table(rule.surv_mask, 26, v.device)[n]
    born = mask_table(rule.born_mask, 26, v.device)[n]
    decayed = torch.where((v != 0) & ~surv, v - 1, v)
    out = torch.where((v == 0) & born, rule.nr_states - 1, decayed)
    return out.to(torch.uint8)


def ca3d_run(rule: CARule, grid: torch.Tensor, steps: int) -> torch.Tensor:
    out = grid.clone()
    for _ in range(steps):
        out = ca3d_step(rule, out)
    return out


_FACE_OFFS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))


def ca3d_prune(grid: torch.Tensor) -> torch.Tensor:
    """Synchronous two-pass prune (ca3d.c:41-59): zero cells whose 6 face
    neighbors are all nonzero, evaluated on the input generation."""
    v = grid.to(torch.int32)
    n = torch.zeros_like(v)
    for off in _FACE_OFFS:
        n += _shift3d(v, *off) != 0
    return torch.where(n == 6, 0, v).to(torch.uint8)


def ca3d_count(grid: torch.Tensor) -> torch.Tensor:
    """xyzarray_count (xyarray.c:72-81): int32 per grid."""
    return (grid != 0).sum(dim=(-3, -2, -1)).to(torch.int32)


# ---------------------------------------------------------------------------
# host-side cave generation (ca3d_make / ca3d_walk)
# ---------------------------------------------------------------------------

_HIST_SIZE = 128
_TRIES = 12


def ca3d_walk_np(arr: np.ndarray, steps: int, val: int,
                 rng: Rand48) -> np.ndarray:
    """Exact port of ca3d_walk (ca3d.c:63-99) + prune. arr is [z, y, x]."""
    arr = arr.copy()
    dz, dy_, dx = arr.shape
    dims = (dx, dy_, dz)  # xyzarray dim order
    cur = [dx // 2, dy_ // 2, dz // 2]
    history = []
    for _ in range(steps):
        arr[cur[2], cur[1], cur[0]] = val
        found = None
        for _try in range(_TRIES):
            nxt = list(cur)
            d = rng.lrand48() % 3
            nxt[d] += 1 if (rng.lrand48() & 1) else -1
            if all(0 <= nxt[i] < dims[i] for i in range(3)) and arr[
                nxt[2], nxt[1], nxt[0]
            ] == 0:
                found = nxt
                break
        if found is None:
            cur = list(history.pop())
            continue
        if len(history) == _HIST_SIZE:
            # C: history full → `continue` without updating cur (ca3d.c:92-93)
            continue
        history.append(tuple(found))
        cur = found

    # prune (sequential in C; pruning marks then clears — replicate)
    marks = np.zeros_like(arr, dtype=bool)
    for z in range(dz):
        for y in range(dy_):
            for x in range(dx):
                n = 0
                for ox, oy, oz in _FACE_OFFS:
                    xx, yy, zz = x + ox, y + oy, z + oz
                    if 0 <= xx < dx and 0 <= yy < dy_ and 0 <= zz < dz:
                        n += (arr[zz, yy, xx] != 0) or marks[zz, yy, xx]
                if n == 6:
                    marks[z, y, x] = True
    arr[marks] = 0
    return arr


def ca3d_make_np(d0: int, d1: int, d2: int, rng: Rand48) -> np.ndarray:
    """Exact port of ca3d_make (ca3d.c:145-169): walled box + cave walk."""
    arr = np.zeros((d2, d1, d0), dtype=np.uint8)
    arr[0, :, :] = 5
    arr[d2 - 1, :, :] = 5
    arr[:, 0, :] = 5
    arr[:, d1 - 1, :] = 5
    arr[:, :, 0] = 5
    arr[:, :, d0 - 1] = 5
    steps = min(d0 * d1, d1 * d2, d0 * d2)
    return ca3d_walk_np(arr, steps, 5, rng)
