#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device — the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions; TF32 off and float32 matmul precision "highest".
2. build — nvcc compiles clap_tpu_torch/csrc/raster.cu (sm_90a) into
   clap_tpu_torch/_build/; prints the seconds and ptxas' register lines.
3. parity — K1 (raster_tile) and K2 (raster_depth) against their plain
   PyTorch versions on the same inputs: the kernel-parity scene at 128²,
   then the slice's own first-frame records (env 0's G-buffer records, its
   4-cascade shadow atlas and the 1024² static bake). Bar: tid agreement
   ≥ 99.5% and depth within 1e-4 where ids agree (K2: depth within 1e-4
   on ≥ 99.5% of pixels).
4. headless — engine_step at 4,096 envs on the headline testbed scene:
   1 warm-up + 30 timed frames, ms/frame and env-steps/s.
5. slice — step_and_render at 64 envs × 256² (engine_step with camera
   occlusion, cluster-record assembly, the composed frame with the baked
   static shadow): 1 warm-up + 10 timed frames, ms/frame, env-fps, peak
   memory, clusters/tiles at capacity, each kernel timed alone next to its
   plain version, launch counts of the driven run, and an end-to-end check
   of two envs' images against the plain CPU path.

Then a JSON line of the kernels, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises (exit code 1);
with no CUDA device the script exits with code 2 and prints no result.
"""
import json
import math
import subprocess
import sys
import time

N_HEADLESS = 4096
N_SLICE = 64
RES = 256


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import numpy as np

    from clap_tpu_torch import cuda_build
    from clap_tpu_torch import mathx as mx
    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
    from clap_tpu_torch.engine.step import engine_step, inputs_zero
    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.lights import lights_empty
    from clap_tpu_torch.render.pipeline import (RenderOptions, shadow_records,
                                                surface_records)
    from clap_tpu_torch.render.scenerender import (
        bake_static_shadow, build_render_tables, default_edge_ids,
        kernel_attrs_ok, shadow_static_mask, static_shadow_geometry)
    from clap_tpu_torch.render.view import cascade_subviews
    from clap_tpu_torch.scene import testbed as tbm
    from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sync = torch.cuda.synchronize

    # ---------------------------------------------------------------- 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul off")
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}; python "
        f"{sys.version.split()[0]}; matmul precision highest, TF32 off")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    cuda_build.load_raster_lib()
    info = cuda_build.build_info
    log(f"phase 2 build: raster.cu -> {info['path'].name} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s)")
    for line in cuda_build.build_info["log"].splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ------------------------------------------------- kernel comparison
    def cmp_tile(k, r):
        same = k[1] == r[1]
        hit = same & (r[1] >= 0)
        err = 0.0
        for i in (0, 2, 3, 4):
            if bool(hit.any()):
                err = max(err, float((k[i] - r[i]).abs()[hit].max()))
        depth_err = float((k[0] - r[0]).abs()[hit].max()) if bool(
            hit.any()) else 0.0
        return float(same.float().mean()), depth_err, err

    def cmp_depth(k, r):
        fk, fr = torch.isfinite(k), torch.isfinite(r)
        both = fk & fr
        diff = torch.where(both, (k - r).abs(), torch.zeros_like(k))
        agree = (fk == fr) & (diff <= 1e-4)
        err = float(diff.max()) if bool(both.any()) else 0.0
        return float(agree.float().mean()), err

    def check_tile(name, args):
        k = R.raster_tile(*args)
        sync()
        r = R.raster_tile_ref(*args)
        agree, derr, err = cmp_tile(k, r)
        exact = all(bool(torch.equal(a, b)) for a, b in zip(k, r))
        log(f"phase 3 parity {name}: K1 tid agreement {agree:.6f}, depth "
            f"max err {derr:.3g} where ids agree, planes max err {err:.3g}"
            f", bit-exact {exact}")
        require(agree >= 0.995 and derr <= 1e-4, f"K1 parity on {name}")
        return k, r, err

    def check_depth(name, args):
        k = R.raster_depth(*args)
        sync()
        r = R.raster_depth_ref(*args)
        agree, err = cmp_depth(k, r)
        log(f"phase 3 parity {name}: K2 depth agreement {agree:.6f}, max "
            f"err {err:.3g}, bit-exact {bool(torch.equal(k, r))}")
        require(agree >= 0.995, f"K2 parity on {name}")
        return k, r, err

    # ---------------------------------------------------------------- 3a
    t = terrain_init_square_landscape(5, -8.0, 0.0, -8.0, 16.0, 24)
    verts = torch.as_tensor(t.vx, device=dev)
    faces = torch.as_tensor(t.idx.reshape(-1, 3).astype(np.int32),
                            device=dev)
    eye = torch.tensor([6.0, 6.0, 6.0], device=dev)
    view = mx.mat4_look_at(eye, torch.zeros(3, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], device=dev))
    proj = mx.mat4_perspective(math.pi / 3, 1.0, 0.1, 50.0, device=dev)
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], -1) \
        @ (proj @ view).T
    rec, ok = R.assemble_tri_records(
        *R.project_to_screen(clip[None], 128, 128), faces,
        torch.ones((1, faces.shape[0]), dtype=torch.bool, device=dev))
    binned = R.bin_triangles(rec, ok, 128, 128)
    k, _r, _ = check_tile("scene 128^2",
                          R.kernel_inputs(rec, binned, 128, 128))
    brute = R.raster_brute(rec[0], ok[0], 128, 128)
    log(f"phase 3 parity scene 128^2: K1 vs raster_brute tid agreement "
        f"{float((k[1][0, :128, :128].int() == brute.tri_id).float().mean()):.6f}")
    check_depth("scene 128^2", R.kernel_inputs(rec, binned, 128, 128,
                                               depth_only=True))

    # ---------------------------------------------------------------- 4
    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=64, device=dev)
    st = tbm.replicate_state(tb.state0, N_HEADLESS)
    ins = tree_map(lambda x: x.expand(N_HEADLESS, *x.shape).clone(),
                   inputs_zero(1, device=dev))
    ins.motion[:, 0, 0] = 1.0
    st = engine_step(tb.cfg, st, ins)
    sync()
    t0 = time.perf_counter()
    for _ in range(30):
        st = engine_step(tb.cfg, st, ins)
    sync()
    dt = (time.perf_counter() - t0) / 30
    require(bool(torch.isfinite(st.phys.pos).all()), "headless state finite")
    require(bool((st.frame == 31).all()), "headless frame counter")
    log(f"phase 4 headless: {N_HEADLESS} envs, {dt * 1e3:.2f} ms/frame, "
        f"{N_HEADLESS / dt:.0f} env-steps/s ({smi})")
    del st, ins, tb

    # ---------------------------------------------------------------- 5
    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=96, n_chars=2, terrain_chunks=4,
                           device=dev)
    ent = tb.cfg.entities
    rt = build_render_tables(
        tbm.testbed_models(tb, skinned_chars=False, textured=False),
        ent.model_id, ent.active,
        entity_edge_id=default_edge_ids(ent.active, ent.body_is_char),
        entity_shadow_static=shadow_static_mask(ent), device=dev)
    require(kernel_attrs_ok(rt), "kernel_attrs eligibility")
    lights = lights_empty(1, device=dev)
    d = torch.tensor([-0.4, -0.8, -0.4], device=dev)
    lights.direction[0] = d / torch.linalg.vector_norm(d)
    lights.color[0] = torch.tensor([1.0, 0.95, 0.9], device=dev)
    lights.is_dir[0] = True
    lights.active[0] = True
    opts = RenderOptions(width=RES, height=RES, shadow_size=256,
                         film_grain=0.0, record_compact=8192,
                         raster_cap=2048, kernel_attrs=True)
    st = tbm.replicate_state(tb.state0, N_SLICE)
    ins = tree_map(lambda x: x.expand(N_SLICE, *x.shape).clone(),
                   inputs_zero(2, device=dev))
    ins.motion[:, 0, 0] = 1.0
    frame0 = st.frame.clone()
    torch.cuda.reset_peak_memory_stats()

    # the driven run: launch counts start here
    R.raster_tile.launches = 0
    R.raster_depth.launches = 0
    t0 = time.perf_counter()
    static = bake_static_shadow(rt, tb.state0.mx, lights.direction[0],
                                shadow_size=1024, far=200.0)
    renderer = SceneRenderer(rt, lights, opts, skip_culling=ent.skip_culling,
                             static_shadow=static, lod_scale=RES / 720.0)
    st, imgs = step_and_render(tb.cfg, renderer, st, ins)
    sync()
    warm = time.perf_counter() - t0
    st1 = st
    t0 = time.perf_counter()
    for _ in range(10):
        st, imgs = step_and_render(tb.cfg, renderer, st, ins)
    sync()
    dt = (time.perf_counter() - t0) / 10
    launches = {"raster_tile": R.raster_tile.launches,
                "raster_depth": R.raster_depth.launches}
    peak = torch.cuda.max_memory_allocated()

    require(bool(((st.frame - frame0) == 11).all()), "frame counter +11")
    require(bool(torch.isfinite(imgs).all()), "images finite")
    std = imgs.reshape(N_SLICE, -1).std(dim=1)
    luma = imgs.reshape(N_SLICE, -1).mean(dim=1)
    require(bool((std > 0.01).all()), "per-env image std > 0.01")
    require(bool(((luma > 0.02) & (luma < 0.98)).all()),
            "per-env mean luma in (0.02, 0.98)")
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on the main path: {launches}")

    geom = renderer.geometry(st)
    nval = geom.comp_valid.sum(-1) // R.CLUSTER
    at_cap = int((nval >= opts.record_compact // R.CLUSTER).sum())
    rec, binned, _ = surface_records(opts, geom)
    stats = R.bin_stats(binned)
    log(f"phase 5 slice: {N_SLICE} envs x {RES}^2, {dt * 1e3:.2f} ms/frame, "
        f"{N_SLICE / dt:.1f} env-fps, warm-up frame (bake included) "
        f"{warm:.2f} s, peak memory {peak / 2**30:.2f} GiB, envs with "
        f"clusters_at_cap {at_cap}/{N_SLICE}, main-pass tiles at capacity "
        f"{stats['tiles_at_cap']}/{stats['n_tiles']} (max "
        f"{stats['max_per_tile']} of {stats['cap']} records), image std "
        f"min {float(std.min()):.4f}, mean luma {float(luma.min()):.4f}.."
        f"{float(luma.max()):.4f} ({smi})")
    log(f"phase 5 launches in the driven run: {launches}")

    # ---------------------------------------------------------------- 3b
    st0 = tree_map(lambda x: x[:1], st1)
    views0 = renderer.views(st0)
    g0 = renderer.geometry(st0, views0)
    rec0, binned0, _ = surface_records(opts, g0)
    check_tile("slice frame 1 env 0 G-buffer 256^2",
               R.kernel_inputs(rec0, binned0, RES, RES))
    casc, _ = cascade_subviews(views0, renderer.proj, lights.direction[0],
                               0.1, 200.0)
    srec, sbin, (w, h, th, tw) = shadow_records(opts, g0, casc.view,
                                                casc.proj)
    check_depth(f"slice frame 1 env 0 cascade atlas {h}x{w}",
                R.kernel_inputs(srec, sbin, w, h, th, tw, depth_only=True))
    gs, sv, _ = static_shadow_geometry(rt, tb.state0.mx, lights.direction[0])
    brec, bbin, (w, h, th, tw) = shadow_records(
        RenderOptions(shadow_size=1024), gs, sv.view[None], sv.proj[None])
    check_depth(f"static bake {h}x{w}",
                R.kernel_inputs(brec, bbin, w, h, th, tw, depth_only=True))

    # ------------------------------------------------ 5b kernel timing
    def time_ms(fn, args, reps):
        fn(*args)
        sync()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        sync()
        return e0.elapsed_time(e1) / reps

    tile_args = R.kernel_inputs(rec, binned, RES, RES)
    _, _, tile_err = check_tile(f"slice frame 11 all {N_SLICE} envs",
                                tile_args)
    casc, _ = cascade_subviews(renderer.views(st), renderer.proj,
                               lights.direction[0], 0.1, 200.0)
    srec, sbin, (w, h, th, tw) = shadow_records(opts, geom, casc.view,
                                                casc.proj)
    depth_args = R.kernel_inputs(srec, sbin, w, h, th, tw, depth_only=True)
    _, _, depth_err = check_depth(f"slice frame 11 all {N_SLICE} envs "
                                  f"cascade atlas", depth_args)
    k1_ms = time_ms(R.raster_tile, tile_args, 20)
    k1_plain = time_ms(R.raster_tile_ref, tile_args, 3)
    k2_ms = time_ms(R.raster_depth, depth_args, 20)
    k2_plain = time_ms(R.raster_depth_ref, depth_args, 3)
    log(f"phase 5 kernel timing ({N_SLICE} envs, frame 11 inputs): K1 "
        f"raster_tile {k1_ms:.3f} ms vs plain {k1_plain:.3f} ms; K2 "
        f"raster_depth {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms ({smi})")

    # ------------------------------------- 5c end-to-end vs the CPU path
    cpu_renderer = SceneRenderer(
        tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, rt),
        tree_map(lambda x: x.cpu(), lights), opts,
        skip_culling=ent.skip_culling.cpu(),
        static_shadow=tuple(x.cpu() for x in static),
        lod_scale=RES / 720.0)
    ref = cpu_renderer(tree_map(lambda x: x[:2].cpu(), st))
    mse = ((imgs[:2].cpu() - ref) ** 2).reshape(2, -1).mean(1)
    psnr = [10 * math.log10(1.0 / max(float(m), 1e-12)) for m in mse]
    log(f"phase 5 end-to-end: envs 0-1 CUDA frame vs plain CPU path PSNR "
        f"{psnr[0]:.1f} / {psnr[1]:.1f} dB")
    require(min(psnr) >= 35.0, "end-to-end PSNR >= 35 dB")

    src = "clap_tpu_torch/csrc/raster.cu"
    log(json.dumps({"kernels": [
        {"name": "raster_tile", "route": "cuda", "source": src,
         "replaces": "clap_tpu/render/raster.py:1041",
         "launches": launches["raster_tile"], "max_abs_err": tile_err,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "raster_depth", "route": "cuda", "source": src,
         "replaces": "clap_tpu/render/raster.py:633",
         "launches": launches["raster_depth"], "max_abs_err": depth_err,
         "ms": k2_ms, "plain_ms": k2_plain},
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
