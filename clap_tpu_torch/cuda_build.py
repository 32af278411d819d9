"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface, loaded through ctypes — no PyTorch headers, ninja or pybind.
The library goes to ``clap_tpu_torch/_build/`` (ignored by git), keyed by
a hash of its source and the flags, at first use; a failed build raises.
``build_all`` starts one nvcc per source at once and waits for them all.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]


def _bind_raster(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.raster_tile_launch.argtypes = [P] * 9 + [I] * 13 + [P]
    lib.raster_tile_launch.restype = I
    lib.raster_depth_launch.argtypes = [P] * 5 + [I] * 13 + [P]
    lib.raster_depth_launch.restype = I


def _bind_ca2d(lib):
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.ca2d_launch.argtypes = [P, P, I, I, I, I, U, U] + [I] * 7 + [P]
    lib.ca2d_global_launch.argtypes = [P, P, P, I, I, I, I, U, U] \
        + [I] * 4 + [P]
    lib.ca2d_smem_limit.argtypes = [I]
    lib.ca2d_active_clusters.argtypes = [I, I, I]
    lib.ca2d_barrier_probe.argtypes = [I, I, P]
    for fn in (lib.ca2d_launch, lib.ca2d_global_launch, lib.ca2d_smem_limit,
               lib.ca2d_active_clusters, lib.ca2d_barrier_probe):
        fn.restype = I
    lib.ca2d_error_string.argtypes = [I]
    lib.ca2d_error_string.restype = ctypes.c_char_p


# source name -> its ctypes signatures
SOURCES = {"raster": _bind_raster, "ca2d": _bind_ca2d}

_LIBS = {}
build_info = {}   # per source name: {"path", "seconds" (0 when cached),
                  # "log" (nvcc/ptxas output)}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _target(name: str):
    src = _PKG / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}_{digest}.so"


def build_all(names=tuple(SOURCES)) -> dict:
    """Compile every named source whose library (same source and flags) is
    not built yet, one nvcc process each, all started together; returns
    {name: library path}."""
    procs = {}
    for name in names:
        src, out = _target(name)
        if out.exists():
            build_info[name] = dict(path=out, seconds=0.0, log="(cached)")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    failed = []
    for name, (p, tmp, out, t0) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (rc {p.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = dict(path=out, seconds=time.perf_counter() - t0,
                                log=log.strip())
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: build_info[name]["path"] for name in names}


def load_lib(name: str):
    """The library built from csrc/<name>.cu, with its ctypes signatures."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        SOURCES[name](lib)
        _LIBS[name] = lib
    return lib
