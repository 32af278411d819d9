"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc into a shared library with a plain C
interface, loaded through ctypes — no PyTorch headers, ninja or pybind.
The library goes to ``clap_tpu_torch/_build/`` (ignored by git), keyed by
a hash of the source and the flags, at first use; a failed build raises.
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
RASTER_SRC = _PKG / "csrc" / "raster.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

_RASTER = None
build_info = {}   # the last build(): {"path", "seconds" (0 when cached),
                  # "log" (nvcc/ptxas output)}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise FileNotFoundError("nvcc not found (PATH or /usr/local/cuda/bin)")


def build(src: Path = RASTER_SRC) -> Path:
    """Compile ``src`` into BUILD_DIR unless a library built from the same
    source and flags exists; returns the library path."""
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}_{digest}.so"
    if out.exists():
        build_info.update(path=out, seconds=0.0, log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} (rc {r.returncode}):\n"
                           f"{r.stdout}\n{r.stderr}")
    os.replace(tmp, out)
    build_info.update(path=out, seconds=time.perf_counter() - t0,
                      log=(r.stdout + r.stderr).strip())
    return out


def load_raster_lib():
    """The raster kernels' library with its ctypes signatures."""
    global _RASTER
    if _RASTER is not None:
        return _RASTER
    lib = ctypes.CDLL(str(build(RASTER_SRC)))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.raster_tile_launch.argtypes = [P] * 8 + [I] * 11 + [P]
    lib.raster_tile_launch.restype = I
    lib.raster_depth_launch.argtypes = [P] * 4 + [I] * 11 + [P]
    lib.raster_depth_launch.restype = I
    _RASTER = lib
    return lib
