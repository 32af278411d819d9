#!/usr/bin/env python3
"""K1 and K2 (clap_tpu_torch render/raster.py ``raster_tile`` /
``raster_depth``) measured on one CUDA card, with CUDA events:

    python3 tools/torch_raster_ab.py [--old CHECKOUT] [--reps N] [--pairs P]

Inputs are the slice's own (chip_smoke.py's phase 5 world, 64 envs ×
256²): the main pass and the cascade atlas after 11 frames of
``step_and_render``, and the 1,024² static shadow bake. Prints the card
(nvidia-smi name and power limit), the ptxas lines of csrc/raster.cu, then
per input the kernel alone, the input preparation (``kernel_inputs``), the
two of them together, and the per-tile pre-gather that the earlier
``kernel_inputs`` made (``_gather_lists``, the same index ops) alone.
Times are device time (``chip_smoke.time_ms``: a spin on the stream holds
the start event until every call is queued).

With ``--old``, the checkout's own csrc/raster.cu and
clap_tpu_torch/render/raster.py (an earlier K1/K2 that takes per-tile
pre-gathered records: C ``raster_tile_launch(counts, trec, brec, 5 planes,
B, n_tiles, ntx, tile_h, tile_w, sub, cap, n_big, chunk, Hp, Wp, stream)``,
its ``kernel_inputs`` returning ``(counts, trec, brec, ...)``) are built and
loaded beside this tree's and timed against them in the order old, new,
new, old, on the same inputs, with a bit-identical check of every plane:
the kernel alone once, ``kernel_inputs`` + kernel ``--pairs`` times, with
the median and range of each side. The last line is a JSON object of
every time.
"""
import argparse
import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip() \
        .splitlines()[0].strip()


def start_nvcc(src: Path, out: Path):
    from clap_tpu_torch import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                             "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish_nvcc(proc, out: Path):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    return ctypes.CDLL(str(out)), log.strip()


def ptxas(tag, log):
    for line in log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas{tag}: {line.strip()}", flush=True)


def load_old_raster(checkout: Path):
    """The checkout's render/raster.py as a module of its own (only its
    plain-torch helpers are called; its imports are ctypes, numpy and
    torch)."""
    path = checkout / "clap_tpu_torch" / "render" / "raster.py"
    spec = importlib.util.spec_from_file_location(
        "clap_tpu_torch.render._raster_old", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--frames", type=int, default=11)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_raster_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from clap_tpu_torch import cuda_build
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize
    card = smi("name,power.limit")
    print(f"card: {card}", flush=True)
    res = {"card": card}

    # ------------------------------------------------ builds, in parallel
    bd = cuda_build.BUILD_DIR
    old = old_lib = None
    if a.old is not None:
        proc = start_nvcc(a.old / "clap_tpu_torch" / "csrc" / "raster.cu",
                          bd / "raster_old.so")
    cuda_build.build_all(("raster",))
    ptxas("", cuda_build.build_info["raster"]["log"])
    if a.old is not None:
        old_lib, log = finish_nvcc(proc, bd / "raster_old.so")
        ptxas(" (old)", log)
        P, I = ctypes.c_void_p, ctypes.c_int
        old_lib.raster_tile_launch.argtypes = [P] * 8 + [I] * 11 + [P]
        old_lib.raster_depth_launch.argtypes = [P] * 4 + [I] * 11 + [P]
        old = load_old_raster(a.old)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def stream():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def old_launch(depth_only, counts, trec, brec, width, height, th, tw, sub,
                   chunk):
        """The earlier kernel on its own pre-gathered arguments."""
        B, n_tiles = counts.shape[:2]
        ntx, nty = R.cdiv(width, tw), R.cdiv(height, th)
        cap, n_big = trec.shape[2] // sub, brec.shape[1]
        Hp, Wp = nty * th, ntx * tw
        outs = [torch.empty((B, Hp, Wp), device=dev)
                for _ in range(1 if depth_only else 5)]
        fn = old_lib.raster_depth_launch if depth_only \
            else old_lib.raster_tile_launch
        rc = fn(ptr(counts), ptr(trec), ptr(brec), *(ptr(o) for o in outs),
                B, n_tiles, ntx, th, tw, sub, cap, n_big, chunk, Hp, Wp,
                stream())
        if rc:
            raise RuntimeError(f"old kernel: CUDA error {rc}")
        return outs[0] if depth_only else tuple(outs)

    def time_ms(fn):
        return CS.time_ms(fn, (), a.reps)

    def abba(name, fa, fb, la, lb):
        t = [(la, time_ms(fa)), (lb, time_ms(fb)), (lb, time_ms(fb)),
             (la, time_ms(fa))]
        print(f"{name}, {la}, {lb}, {lb}, {la} (ms): "
              f"{[round(x, 4) for _, x in t]}", flush=True)
        res[name] = t
        return t

    def spread(name, t):
        """Median and range of each side of a run of A, B, B, A pairs."""
        for side in dict(t):
            v = sorted(x for k, x in t if k == side)
            m = statistics.median(v)
            res[f"{name}: {side} median ms"] = m
            print(f"{name}: {side} median {m:.4f} ms, range {v[0]:.4f}-"
                  f"{v[-1]:.4f} ms over {len(v)}", flush=True)

    def same(x, y):
        x = x if isinstance(x, tuple) else (x,)
        y = y if isinstance(y, tuple) else (y,)
        return all(bool(torch.equal(p, q)) for p, q in zip(x, y))

    # ------------------------------------------------------------- inputs
    w = CS.build_slice(dev)
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    renderer = CS.make_renderer(w, static)
    gs = w["gs"]
    for _ in range(a.frames):
        gs, _img = step_and_render(w["gw"], renderer, gs, w["ins"])
    sync()
    _, rec, binned, srec, sbin, dims = CS.frame_records(
        renderer, gs.engine, gs.joint_mats)
    brec, bbin, bdims = CS.bake_records(w["rt"], w["tb"], w["lights"])
    cases = [
        (f"K1 frame {a.frames} {CS.N_SLICE} envs {CS.RES}^2", False,
         (rec, binned, CS.RES, CS.RES)),
        (f"K2 frame {a.frames} cascade atlas {dims[1]}x{dims[0]}", True,
         (srec, sbin, *dims)),
        (f"K2 static bake {bdims[1]}x{bdims[0]}", True, (brec, bbin, *bdims)),
    ]
    print(f"inputs: {[c[0] for c in cases]}", flush=True)

    for name, depth_only, inp in cases:
        kern = R.raster_depth if depth_only else R.raster_tile
        args = R.kernel_inputs(*inp, depth_only=depth_only)
        ncoef = R.NCOEF_DEPTH if depth_only else R.NCOEF

        def new_all(inp=inp, depth_only=depth_only, kern=kern):
            return kern(*R.kernel_inputs(*inp, depth_only=depth_only))

        res[f"{name}: new kernel ms"] = time_ms(lambda: kern(*args))
        res[f"{name}: new kernel_inputs ms"] = time_ms(
            lambda: R.kernel_inputs(*inp, depth_only=depth_only))
        res[f"{name}: new kernel_inputs + kernel ms"] = time_ms(new_all)
        res[f"{name}: the earlier pre-gather alone ms"] = time_ms(
            lambda: R._gather_lists(*args[:4], ncoef))
        print(f"{name}: kernel {res[f'{name}: new kernel ms']:.4f} ms, "
              f"kernel_inputs {res[f'{name}: new kernel_inputs ms']:.4f} "
              f"ms, both {res[f'{name}: new kernel_inputs + kernel ms']:.4f}"
              f" ms; the earlier per-tile pre-gather alone "
              f"{res[f'{name}: the earlier pre-gather alone ms']:.4f} ms",
              flush=True)
        if old is None:
            continue
        oargs = old.kernel_inputs(*inp, depth_only=depth_only)

        def old_all(inp=inp, depth_only=depth_only):
            return old_launch(depth_only, *old.kernel_inputs(
                *inp, depth_only=depth_only))

        ok = same(old_launch(depth_only, *oargs), kern(*args))
        print(f"{name}: old and new bit-identical {ok}", flush=True)
        if not ok:
            raise RuntimeError(f"{name}: old and new kernels differ")
        res[f"{name}: bit-identical"] = ok
        res[f"{name}: old kernel_inputs ms"] = time_ms(
            lambda: old.kernel_inputs(*inp, depth_only=depth_only))
        print(f"{name}: kernel_inputs old "
              f"{res[f'{name}: old kernel_inputs ms']:.4f} ms, new "
              f"{res[f'{name}: new kernel_inputs ms']:.4f} ms", flush=True)
        abba(f"{name}: kernel alone", lambda: old_launch(depth_only, *oargs),
             lambda: kern(*args), "old", "new")
        t = []
        for p in range(a.pairs):
            t += abba(f"{name}: kernel_inputs + kernel, pair {p}", old_all,
                      new_all, "old", "new")
        spread(f"{name}: kernel_inputs + kernel", t)

    print(card, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
