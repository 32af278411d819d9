"""Bit-exact drand48/lrand48 replica.

The reference seeds libc's rand48 family for all procedural content:
terrain lattice noise (terrain.c:15-18 seeds srand48 per lattice point),
BSP splits (terrain.c bsp_process), CA seeding (ca2d.c ca2d_generate), and
cave walks (ca3d.c ca3d_walk). Reproducing those bit streams lets the
host-side content pipeline generate identical worlds for parity tests.

rand48 is the LCG  X' = (a*X + c) mod 2^48  with a=0x5DEECE66D, c=0xB.
srand48(s) sets X = (s << 16) | 0x330E. drand48 returns X/2^48 as double;
lrand48 returns X >> 17 (31-bit non-negative).

Implemented in numpy (host-side content gen is numpy; device code uses
jax.random instead — RNG keys replace global seeding in the TPU engine).
"""
from __future__ import annotations

import numpy as np

_A = 0x5DEECE66D
_C = 0xB
_MASK = (1 << 48) - 1


class Rand48:
    """Sequential stateful replica of srand48/drand48/lrand48/rand."""

    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self.x = (((seed & 0xFFFFFFFF) << 16) | 0x330E) & _MASK

    def _step(self) -> int:
        self.x = (self.x * _A + _C) & _MASK
        return self.x

    def drand48(self) -> float:
        return self._step() / float(1 << 48)

    def lrand48(self) -> int:
        return self._step() >> 17

    def mrand48(self) -> int:
        v = self._step() >> 16
        return v - (1 << 32) if v >= (1 << 31) else v


def srand48_state(seed) -> np.ndarray:
    """Vectorized: initial state array for an array of seeds (uint64)."""
    seed = np.asarray(seed, dtype=np.uint64)
    return (((seed & np.uint64(0xFFFFFFFF)) << np.uint64(16)) | np.uint64(0x330E)) & np.uint64(_MASK)


def rand48_next(state: np.ndarray) -> np.ndarray:
    """One LCG step (vectorized, uint64 wrap-safe since mod 2^48 < 2^64)."""
    return (state * np.uint64(_A) + np.uint64(_C)) & np.uint64(_MASK)


def drand48_from_state(state: np.ndarray) -> np.ndarray:
    return state.astype(np.float64) / float(1 << 48)


def hash_height(seed: int, x, z) -> np.ndarray:
    """get_rand_height (terrain.c:15-19): srand48(seed ^ (x + z*43210)),
    one drand48, mapped to [-1, 1). Vectorized over x/z lattices."""
    x = np.asarray(x, dtype=np.int64)
    z = np.asarray(z, dtype=np.int64)
    mix = np.uint64(seed) ^ (x + z * 43210).astype(np.uint64)
    st = rand48_next(srand48_state(mix))
    return drand48_from_state(st) * 2.0 - 1.0
