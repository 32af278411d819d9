"""2D cellular automata, host half (reference: clap_tpu/ops/ca2d.py).

The reference steps the grid **in place** in scan order (ca2d.c:61-77), so a
cell's neighbor count mixes already-updated and not-yet-updated cells.
``ca2d_step_seq_np`` is the bit-exact numpy port of that sweep; terrain
content generation (scene/terrain.py) runs on it.

The synchronous device step and its fused kernel (``_ca2d_kernel`` in the
JAX package) are not ported yet; they land in this module.

Rule encoding matches struct cell_automaton (ca-common.h): ``born_mask`` /
``surv_mask`` are bitmasks over neighbor counts; a dead cell with count n is
born at value ``nr_states`` when born bit n is set; a live cell survives
unchanged when surv bit n is set, else decays by 1 if ``decay``.

Out-of-bounds neighbors read as 0 (zero boundary, not torus).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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
