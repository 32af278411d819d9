"""Mesh utilities + native optimizer bindings (reference: core/mesh.{c,h};
counterpart of clap_tpu/scene/mesh.py).

- ``optimize``: vertex dedup/remap + cache-aware index reorder
  (mesh_optimize, mesh.c:270-341 — the reference calls meshoptimizer).
- ``build_lods``: LOD index chains at 50/75/87.5% with a sloppy
  vertex-clustering fallback (mesh_idx_to_lod, mesh.c:379-428;
  LOD_MAX=4, model.h:42).
- AABB computation (mesh.c AABB calc).

The optimizer is native C++ (native/meshopt.cpp, the same source the JAX
package loads) built with native/Makefile on first use and loaded via
ctypes. There is no numpy fallback: without the library LOD
simplification would silently be skipped and the port would render a
different scene, so a missing or unbuildable library raises.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

LOD_MAX = 4
LOD_FRACTIONS = (1.0, 0.5, 0.25, 0.125)  # mesh.c:379-428: 50/75/87.5% cuts

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB = None


def _load_native():
    """Build (if needed) and load native/libmeshopt.so; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _NATIVE_DIR / "libmeshopt.so"
    if not so.exists():
        r = subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"building {so} failed (rc {r.returncode}):\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.moq_dedup.restype = ctypes.c_int
    lib.moq_simplify.restype = ctypes.c_int
    lib.moq_simplify_sloppy.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def _cptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def dedup(verts: np.ndarray) -> tuple[np.ndarray, int]:
    """remap[v_old] = v_new over quantized-equal rows. verts (V, C)."""
    verts = np.ascontiguousarray(verts, np.float32)
    lib = _load_native()
    remap = np.empty(len(verts), np.uint32)
    n = lib.moq_dedup(_cptr(verts, ctypes.c_float), len(verts),
                      verts.shape[1], _cptr(remap, ctypes.c_uint))
    return remap, n


def optimize(verts: np.ndarray, attrs: list[np.ndarray], idx: np.ndarray):
    """mesh_optimize: dedup vertices (remapping all attribute streams)
    then reorder indices for vertex-cache locality."""
    idx = np.ascontiguousarray(idx, np.uint32).reshape(-1)
    key = np.concatenate([np.asarray(verts, np.float32)]
                         + [np.asarray(a, np.float32).reshape(len(verts), -1)
                            for a in attrs], axis=1)
    remap, n_unique = dedup(key)
    new_verts = np.empty((n_unique, verts.shape[1]), np.float32)
    new_verts[remap] = verts
    new_attrs = []
    for a in attrs:
        a = np.asarray(a, np.float32)
        na = np.empty((n_unique,) + a.shape[1:], np.float32)
        na[remap] = a
        new_attrs.append(na)
    new_idx = remap[idx].astype(np.uint32)

    lib = _load_native()
    if len(new_idx):
        lib.moq_cache_optimize(_cptr(new_idx, ctypes.c_uint), len(new_idx),
                               n_unique)
    return new_verts, new_attrs, new_idx


def simplify(verts: np.ndarray, idx: np.ndarray, target_idx: int) -> np.ndarray:
    """QEM edge-collapse to ≈target index count, with vertex-clustering
    fallback when QEM can't reach the target (mesh.c:404-414 "sloppy")."""
    verts = np.ascontiguousarray(verts[:, :3], np.float32)
    idx = np.ascontiguousarray(idx, np.uint32).reshape(-1)
    lib = _load_native()
    if len(idx) <= target_idx:
        return idx
    out = np.empty(len(idx), np.uint32)
    n = lib.moq_simplify(_cptr(verts, ctypes.c_float), len(verts),
                         _cptr(idx, ctypes.c_uint), len(idx),
                         int(target_idx), _cptr(out, ctypes.c_uint))
    if n > target_idx * 1.5:  # sloppy fallback
        ext = verts.max(0) - verts.min(0)
        cell = float(max(ext.max(), 1e-3)) / max(
            (target_idx / 6.0) ** 0.5, 1.0)
        n = lib.moq_simplify_sloppy(_cptr(verts, ctypes.c_float), len(verts),
                                    _cptr(idx, ctypes.c_uint), len(idx),
                                    ctypes.c_float(cell),
                                    _cptr(out, ctypes.c_uint))
    return out[:n].copy()


def build_lods(verts: np.ndarray, idx: np.ndarray) -> list[np.ndarray]:
    """Per-LOD index buffers (mesh_idx_to_lod; model.c:27-62)."""
    lods = [np.asarray(idx, np.uint32).reshape(-1)]
    for frac in LOD_FRACTIONS[1:]:
        target = max(int(len(lods[0]) * frac) // 3 * 3, 3)
        lods.append(simplify(verts, lods[0], target))
    return lods


def aabb(verts: np.ndarray) -> np.ndarray:
    v = np.asarray(verts)
    return np.stack([v.min(0), v.max(0)])
