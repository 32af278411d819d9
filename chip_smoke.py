#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clap_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device — the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions; TF32 off and float32 matmul precision "highest".
2. build — nvcc compiles clap_tpu_torch/csrc/raster.cu and ca2d.cu
   (sm_90a, one nvcc each, started together) into clap_tpu_torch/_build/;
   prints the seconds and ptxas' register lines.
3. parity — K1 (raster_tile) and K2 (raster_depth) against their plain
   PyTorch versions on the same inputs: the kernel-parity scene at 128²,
   then the slice's own first-frame records (env 0's G-buffer records, its
   4-cascade shadow atlas and the 1024² static bake), and in phase 5 all
   64 envs at frame 11. Bar: bit-exact (and, as the reference's own bar,
   tid agreement ≥ 99.5% and depth within 1e-4 where ids agree).
4. headless — engine_step at 4,096 envs on the headline testbed scene:
   1 warm-up + 30 timed frames, ms/frame and env-steps/s.
5. slice — step_and_render at 64 envs × 256², the JAX bench's default
   composition (bench.py:544-673): game_step with the game config and demo
   rig of bench.py:546-559 (engine step with camera occlusion, switch
   rules, rig animation), LBS-skinned ring-column characters
   (build_testbed_char_skin, SKIN=1), cluster-record assembly with the
   skinned range, and the composed frame with the baked static shadow: 1
   warm-up + 10 timed frames, each env on its own inputs (its walk
   direction, jump frame and camera turn; every env's walker ends at its
   own place and the first and last env's images differ), ms/frame,
   env-fps, peak memory,
   clusters/tiles at capacity, the skinned records per env, the pose
   (frame 11 drawn with frame 1's joint matrices moves pixels), each
   kernel timed alone next to its plain version and its bound (what these
   inputs need, counted on the plain version's walk: records walked,
   covered pixel-record pairs, wins; beside them the brute-force tests and
   the kernel's tests after its per-warp reject), the input preparation
   (kernel_inputs) of each, launch counts of the driven run, and an
   end-to-end check of envs 0, 1, 32 and 63 against the plain CPU path.
6. CA — K3 (ca2d_run_fused) bit-exact against its plain version ca2d_run
   for 5 rules on every route, each line with its route, cluster size and
   launches per call: 4 shapes (64², 96×160, 37×53, 256² × 1,000),
   512² and 1,024² over a cluster, 256² × 64 at every cluster size the
   card schedules, 132 × 37×53 in place, 2,048² × 5 on the
   device-memory route; the CA path driven (the JAX bench's config
   #1: one 256² CA_TEST grid × 1,000 generations, then 1,024 × 256² × 100)
   and timed against the plain version and its bound (CUDA events; config
   #1's bound also with 1,000 cluster barriers timed alone);
   cave_scene(48³, rule 2, 8 steps) on the card equals the CPU run.
7. skinning — the JAX bench's config #3 (1,024 instances, 64 joints,
   4,096 verts): pose sampling, joint matrices and batched LBS, ms per
   call and skinned verts/s; four instances against the CPU path (1e-4).
8. textured — the JAX bench's ``step_and_render_textured`` config
   (bench.py:566-575, 620-666) at 64 envs × 256²: skinned and textured
   characters, textured trees; the tables are not flat-eligible, so the
   frame takes the member-granularity assembly and the per-pixel attribute
   gather (K1 on 19-column barycentric records). As phase 5: 1 warm-up +
   10 timed frames, checks, launches, K1 bit-exact on frame 11's records
   and timed beside its plain version, input preparation and bound, and
   envs 0, 1, 32 and 63 against the plain CPU path. 8b: the textured
   frame at 4 envs with normal-map layers (tangent-space TBN) and
   material fBm on the spheres and terrain: each env against the plain
   CPU path (PSNR >= 35 dB), and taking the normal layers or the fBm away
   changes the card's image.
9. full frame — the JAX bench's ``full_frame`` and ``full_frame_dense``
   (bench.py:168-278) at 1280 × 720: hand-built terrain (and 256 cubes,
   about 117k triangles, raster_cap 4096) with corner-expanded static
   streams. 1 warm-up + 3 frames, wall ms and device busy ms
   (torch.profiler; median and range), peak memory, tiles at capacity,
   the image checks (finite, std > 0.01, a nudged camera changes the
   image); K1 and K2 bit-exact on each
   frame's records and cascade atlas, timed beside their plain versions
   with input preparation and bounds; the default frame against the plain
   CPU path (PSNR >= 35 dB).
10. production — ``full_frame_production`` (bench.py:281-420): the dense
    scene as render tables, kernel_attrs, cluster records (cap 81,920),
    the terrain baked once into a 2,048² atlas (cold and warm ms): frames
    as phase 9, clusters at the cap; K1 (extras, 720p) and K2 (the bake
    and the frame's 4 × 512² cascade atlas) bit-exact, timed, bounded.
11. batched — ``batched_render`` (bench.py:423-497): 64 views × 256² of
    one shared terrain, kernel_attrs over member geometry,
    ``render_frame_batch`` with one shared light atlas (required: one K2
    launch per batch, on one (1, 256, 256) atlas, bit-exact on the inputs
    the batch gave it): ms per batch, frames/s, img_std, peak memory; K1
    on extras records built from faces and normals and K2 on the shared
    atlas bit-exact, timed, bounded.
12. shading rate — ``shading_rate`` (bench.py:739-755, 879-884): the
    skinned flagship at 8 envs at internal_scale 2 against 1 from one
    state (PSNR printed; the image has the full shape, is finite and is
    not the full-resolution frame), then 64 envs at internal_scale 2
    driven as phase 5: ms/frame, env-fps, wall and device ms; K1 on the
    internal 128² extras records and K2 on the cascade atlas of the last
    frame bit-exact, timed, bounded.
13. game frame — the game's own rendered frame (demo/testbed.py:62-200,
    ``--render``) through ``game_frame_step`` (game_step with the camera
    occlusion, then GameFrameRenderer): 1 env × 640 × 360, two spore
    systems of 256 live particles drawn by K1, film grain on the committed
    blue noise, textured skinned characters, the single-env assembly and
    the 1,024² static bake. 1 warm-up + 5 frames, wall and device busy ms
    (median and range), the render alone, peak memory, launches (two K1 a
    frame, one K2 and the bake); every frame finite with std > 0.01,
    particles and grain change pixels; K1 bit-exact on the particle and
    surface records, K2 on the atlas and the bake, timed and bounded; the
    frame against the port's CPU path (PSNR >= 35 dB; the JAX package
    cannot raster 640 wide).
14. options — the skinned flagship (phase 5's world, 64 envs × 256²) from
    one state: the default frame and one frame per render option
    (model_msaa 2, shadow_msaa 2, PCF, laplace edges, SSAO kernel mode,
    fog noise, material fog, a 32³ ``teal orange`` LUT) and the menu blur
    of the default frame: wall and device busy ms (median and range of 3
    after a warm-up), peak memory, launches; each finite, full-size and
    different from the default frame. K1 bit-exact on model_msaa 2's 512²
    records and K2 on shadow_msaa 2's (64, 2,048, 512) atlas, timed and
    bounded.
15. level — the authored level demo/level57.json through the port's loader
    and asset pack (scene/assets57.py), wired as demo/platformer.py:46-66
    (the demo rig, footstep SFX, the switch/platform rules): the load's
    host seconds and counts; game_step of the scripted walk (Tab at 2/3)
    at 4,096 envs × 80 frames, wall and device busy ms, env-steps/s, the
    frame each switch latches, env 0 against the port's CPU run (made in a
    worker process meanwhile: the same latch frames, positions within
    1e-3), the two camera slots; the rotating beam (per-env triangles
    following the entity's full transform; env b turned by 2π·b/1,024)
    and a 4-character roster at 1,024 envs, held the same way; the level's
    frame at 1 env × 640 × 360 (game_frame_step) and at 64 envs × 256²
    (step_and_render): 1 warm-up + 5 wall-timed + 2 profiled frames, peak
    memory, launches, K1 and K2 bit-exact on each frame's own inputs,
    timed and bounded, the 64-env frame against the plain CPU path (PSNR
    >= 35 dB), render_frame_debug's taps on the 640 × 360 frame.

16. engine — the engine shell (``python -m clap_tpu_torch.demo.testbed
    --render --fuzzer``, ``build_world`` with footsteps): ``Engine.run``
    of 120 frames at 1 × 640 × 360 with sound, the PNG dump to a
    temporary directory and the live display (one loopback WebSocket
    client that receives PNG frames and sends a key); checks: 120 frames,
    the last frame finite with std > 0.01 and mean luma in (0.02, 0.98),
    frame 119's PNG decodes to it, footsteps played and 120 × 800 audio
    samples, a NaN written into the body positions before frame 59 (its
    step and render run over it) reset to the initial session by the
    watchdog at 60, two K1 and one K2 a frame; wall ms per frame
    (median and range) and ``profiler.report()`` (host dispatch segments);
    the session through ``save_checkpoint`` / ``load_checkpoint``
    bit-exact; a second Engine with graphics only equal to
    ``game_frame_step`` bit for bit over 3 frames, its wall and device busy
    ms and device ops per frame beside ``game_frame_step``'s, K1/K2
    bit-exact on its frame's records (``kernel_report``), its ``-E``
    abort; the headless soak (``--envs 4096``): ``fuzz_batch`` +
    ``engine_step`` × 60 frames, env-steps/s, the fuzzer's draws card ==
    CPU for envs 0 and 4,095 over frames 0-59 (inputs within 1e-6),
    ``finite_mask``, a NaN in env 7 through ``quarantine``.

17. UI, overlay and demos — (a) over 8 frames of the Engine's testbed
    frame (graphics only, 1 env × 640 × 360; K1 surface and particles, K2
    atlas) a caller's overlay: an osd line, a nested Menu and an
    InteractiveDebugUI (standard_modules, one Adjustable) driven by
    InputRecords, a toast slid in by a UiAnimator, draw_lines of every
    body's AABB and a cross at each character; pixels change only inside
    the quads and on the line pixels, the card's composite equals the CPU
    composite bit for bit, no host sync in it (sync-debug "error"), ms per
    composite (wall, device busy) beside the frame's, K1/K2 bit-exact on the
    last overlay frame's records, timed and bounded; (b)
    render_frame_debug → compose_pass_browser of that frame (120 × 90
    thumbnails, the counts line; the font used); (c) ``python -m
    clap_tpu_torch.demo.flythrough`` at its defaults (8 frames × 20 sim
    frames at 640 × 360): one K1 and one K2 a frame, each frame finite with
    std > 0.01 and unlike the one before, ms per sim frame and per render,
    K1/K2 bit-exact on the last frame's records, timed and bounded, that
    frame against the port's CPU path (PSNR >= 35 dB); (d) the platformer
    demo's run (120 frames, Tab at 80) against the port's CPU run, made
    after the card's: the same events, control frames and footstep log,
    positions within 1e-3; ms/frame.
18. sharding — env-axis sharding (clap_tpu_torch.parallel): (a)
    ``dryrun_multichip`` (__graft_entry__.py's composed frame, 2 envs per
    entry) on a mesh of every card and on a 4-entry mesh of cuda:0, the
    latter bit-exact against the same world unsharded, the mean luma
    printed; (b) phase 5's flagship from its distinct per-env states at
    frame 11 for 3 more frames unsharded, sharded over the 4-entry mesh of
    cuda:0 and (with more than one card) over the cards: state and every
    env's image bit-exact against the unsharded run, the cross-env mean
    from per-shard sums within 1e-6 relative, one K1 and one K2 per shard
    per frame, wall and device busy ms per frame of each run, K1/K2
    bit-exact on the last shard's records, timed and bounded.

Each new path's kernel launches are counted from 0 over its driven run.

Then a JSON line of the kernels (``raster_tile`` / ``raster_depth`` with
each path's launches and kernel numbers as prefixed fields: ``textured_``,
``full_frame_``, ``full_frame_dense_``, ``production_``, ``batched_``,
``shading_rate_``, ``game_frame_``, ``particles_``, ``msaa_``,
``shadow_msaa_``, ``level_``, ``level_batch_``, ``engine_``,
``engine_particles_``, ``overlay_``, ``overlay_particles_``,
``flythrough_``, ``sharded_``), the
nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``. Any failed check raises (exit code 1);
with no CUDA device the script exits with code 2 and prints no result.
"""
import contextlib
import json
import math
import os
import subprocess
import sys
import time

N_HEADLESS = 4096
N_SLICE = 64
RES = 256
NAN_AT = 59        # phase 16: the frame that steps and renders a NaN state
TBN_ENVS = 4       # phase 8b's envs
FEATURE_RMS = 0.02     # phase 8b: a pixel a feature moves by this RMS or more
SHARD_FRAMES = 3   # phase 18: the flagship's checked frames each way
SHARD_REPS = 3     # phase 18: its wall-timed and profiled frames each way
MESH_ENTRIES = 4   # phase 18: the one-card mesh's entries


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
    from clap_tpu_torch.engine.step import engine_step, inputs_zero
    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.scenerender import kernel_attrs_ok
    from clap_tpu_torch.scene import testbed as tbm
    from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

    sync = torch.cuda.synchronize
    laps = {}                        # phase(s) -> host seconds
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - clock[0], 1)
        clock[0] = now

    # ---------------------------------------------------------------- 1
    dev, smi = setup_card()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}; python "
        f"{sys.version.split()[0]}; matmul precision highest, TF32 off")
    raw, avg = check_device_busy(dev)
    log(f"phase 1 device busy reader: the profiler's raw CUDA events sum "
        f"{raw:.4f} ms, key_averages() {avg:.4f} ms on 20 matmuls, a fill "
        f"and a copy (torch {torch.__version__})")

    # ---------------------------------------------------------------- 2
    t0 = time.perf_counter()
    cuda_build.build_all()
    log(f"phase 2 build: {len(cuda_build.build_info)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, info in cuda_build.build_info.items():
        log(f"phase 2 build: {name}.cu -> {info['path'].name} (nvcc "
            f"{info['seconds']:.1f} s)")
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    check_tile, check_depth = parity_checks(sync)

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
    w5 = build_slice(dev)
    tb, rt, cs, lights = (w5[k] for k in ("tb", "rt", "cs", "lights"))
    require(kernel_attrs_ok(rt), "kernel_attrs eligibility")
    d5 = drive_frames(w5, sync, require)
    renderer, gs, imgs, st = d5["renderer"], d5["gs"], d5["imgs"], d5["st"]
    launches = d5["launches"]
    require(renderer.cluster_records, "the flagship takes cluster records")
    geom, rec, binned, srec, sbin, (w, h, th, tw) = frame_records(
        renderer, st, gs.joint_mats)
    T5 = geom.comp.shape[-1]
    n_skin = cs.char_ents.shape[0] * cs.n_main
    # the compacted rigid clusters, ahead of the skinned range
    nval = geom.comp_valid[:, :T5 - n_skin].sum(-1) // R.CLUSTER
    at_cap = int((nval >= renderer.opts.record_compact // R.CLUSTER).sum())
    stats = R.bin_stats(binned)
    log(f"phase 5 slice (skinned characters): {N_SLICE} envs x {RES}^2, "
        f"{d5['dt'] * 1e3:.2f} ms/frame, {N_SLICE / d5['dt']:.1f} env-fps, "
        f"warm-up frame (bake included) {d5['warm']:.2f} s, peak memory "
        f"{d5['peak'] / 2**30:.2f} GiB, envs with clusters_at_cap "
        f"{at_cap}/{N_SLICE}, main-pass tiles at capacity "
        f"{stats['tiles_at_cap']}/{stats['n_tiles']} (max "
        f"{stats['max_per_tile']} of {stats['cap']} records), "
        f"{d5['summary']} ({smi})")
    log(f"phase 5 skinned records per env: {n_skin} main records "
        f"({cs.char_ents.shape[0]} chars x {cs.n_main}, LOD 0 faces "
        f"cluster-padded) after the {T5 - n_skin} compacted rigid records, "
        f"{int(geom.comp_valid[:, T5 - n_skin:].sum()) // N_SLICE} valid; "
        f"{3 * cs.n_shadow * cs.char_ents.shape[0]} skinned shadow corner "
        f"rows of {geom.shadow_corner_verts.shape[1]}")
    log(f"phase 5 launches in the driven run: {launches}")
    # the pose: frame 11's state drawn with frame 1's joint matrices and
    # with its own
    moved = (renderer(st, d5["jm1"]) - imgs).abs().amax(-1) > 0.02
    n_moved = moved.reshape(N_SLICE, -1).sum(1)
    log(f"phase 5 pose: frame 11 drawn with frame 1's joint matrices and "
        f"its own differs on {int(n_moved.min())}..{int(n_moved.max())} "
        f"pixels per env")
    require(bool((n_moved > 0).all()), "the pose moves character pixels")

    # ---------------------------------------------------------------- 3b
    st0 = tree_map(lambda x: x[:1], d5["st1"])
    _, rec0, binned0, srec0, sbin0, d0 = frame_records(renderer, st0,
                                                       d5["jm1"][:1])
    check_tile("slice frame 1 env 0 G-buffer 256^2",
               R.kernel_inputs(rec0, binned0, RES, RES))
    check_depth(f"slice frame 1 env 0 cascade atlas {d0[1]}x{d0[0]}",
                R.kernel_inputs(srec0, sbin0, *d0, depth_only=True))
    brec, bbin, db = bake_records(rt, tb, lights)
    check_depth(f"static bake {db[1]}x{db[0]}",
                R.kernel_inputs(brec, bbin, *db, depth_only=True))

    # ------------------------------------------------ 5b kernel timing
    tile_args = R.kernel_inputs(rec, binned, RES, RES)
    _, _, tile_err = check_tile(f"slice frame 11 all {N_SLICE} envs",
                                tile_args)
    depth_args = R.kernel_inputs(srec, sbin, w, h, th, tw, depth_only=True)
    _, _, depth_err = check_depth(f"slice frame 11 all {N_SLICE} envs "
                                  f"cascade atlas", depth_args)
    k1_ms = time_ms(R.raster_tile, tile_args, 20)
    k1_plain = time_ms(R.raster_tile_ref, tile_args, 3)
    k2_ms = time_ms(R.raster_depth, depth_args, 20)
    k2_plain = time_ms(R.raster_depth_ref, depth_args, 3)
    # the input preparation of each launch (coefficient rows, counts)
    k1_prep = time_ms(R.kernel_inputs, (rec, binned, RES, RES), 20)
    k2_prep = time_ms(lambda: R.kernel_inputs(srec, sbin, w, h, th, tw,
                                              depth_only=True), (), 20)
    k1_bound = walk_bound(R, R.raster_tile_ref, tile_args, R.NCOEF, 5, 12)
    k2_bound = walk_bound(R, R.raster_depth_ref, depth_args, R.NCOEF_DEPTH,
                          1, 0)
    log(f"phase 5 kernel timing ({N_SLICE} envs, frame 11 inputs): K1 "
        f"raster_tile {k1_ms:.3f} ms vs plain {k1_plain:.3f} ms; K2 "
        f"raster_depth {k2_ms:.3f} ms vs plain {k2_plain:.3f} ms; input "
        f"preparation (kernel_inputs) K1 {k1_prep:.3f} ms, K2 "
        f"{k2_prep:.3f} ms ({smi})")
    log_bounds("phase 5", (("K1", k1_bound), ("K2", k2_bound)))

    # ------------------------------------- 5c end-to-end vs the CPU path
    psnr = cpu_psnr(w5, d5)
    log(f"phase 5 end-to-end: envs {psnr_envs(N_SLICE)} (distinct states) "
        f"CUDA frame vs plain CPU path PSNR "
        f"{' / '.join(f'{p:.1f}' for p in psnr)} dB")
    require(min(psnr) >= 35.0, "end-to-end PSNR >= 35 dB")

    # phase 18 goes on from this world's distinct per-env states, kept on
    # the host until then so that no later phase's peak memory holds them
    # (the world itself stays, as it always has)
    flag = dict(w=w5, gs=to_device(d5["gs"], "cpu"),
                static=to_device(d5["static"], "cpu"), frame=11)
    del d5, gs, imgs, renderer, st, geom, rec, binned, tile_args
    torch.cuda.empty_cache()
    lap("1-5")

    # ---------------------------------------------------------------- 6
    ca = run_ca_phase(dev, smi, require)
    lap("6")

    # ---------------------------------------------------------------- 7
    run_skinning_phase(dev, smi, require)
    lap("7")

    # ---------------------------------------------------------------- 8
    tex = run_textured_phase(dev, smi, require, sync, check_tile,
                             check_depth)
    tbn = run_tbn_fbm_check(dev, smi, require, check_tile, check_depth)
    torch.cuda.empty_cache()
    lap("8")

    # ------------------------------------------------------------ 9-12
    ff = run_full_frame_phase(dev, smi, require, check_tile, check_depth)
    lap("9")
    prod = run_production_phase(dev, smi, require, check_tile, check_depth)
    lap("10")
    bat = run_batched_phase(dev, smi, require, check_tile, check_depth)
    lap("11")
    rate = run_shading_rate_phase(dev, smi, sync, require, check_tile,
                                  check_depth)
    lap("12")

    # ----------------------------------------------------------- 13-14
    game = run_game_frame_phase(dev, smi, require, check_tile, check_depth)
    lap("13")
    opt = run_options_phase(dev, smi, require, check_tile, check_depth)
    lap("14")

    # -------------------------------------------------------------- 15
    lvl = run_level_phase(dev, smi, require, check_tile, check_depth)
    lap("15")

    # -------------------------------------------------------------- 16
    eng = run_engine_phase(dev, smi, require, check_tile, check_depth)
    lap("16")

    # -------------------------------------------------------------- 17
    ovl = run_overlay_phase(dev, smi, require, check_tile, check_depth)
    lap("17")

    # -------------------------------------------------------------- 18
    shd = run_sharding_phase(dev, smi, require, check_tile, check_depth,
                             flag)
    del flag
    lap("18")
    log(f"phase host seconds: {json.dumps(laps)}, total "
        f"{sum(laps.values()):.0f} s")

    def fields(prefix, launches, rep):
        """A path's launches and one kernel report as extra fields."""
        f = {} if launches is None else {f"{prefix}_launches": launches}
        f.update({f"{prefix}_max_abs_err": rep["max_abs_err"],
                  f"{prefix}_ms": rep["ms"],
                  f"{prefix}_plain_ms": rep["plain_ms"],
                  f"{prefix}_bound_ms": rep["bound"][0],
                  f"{prefix}_bound_by": rep["bound"][1]})
        return f

    def paths(k):
        rep = "k1" if k == "raster_tile" else "k2"
        f = {}
        for prefix, path in (("full_frame", ff["full_frame"]),
                             ("full_frame_dense", ff["full_frame_dense"]),
                             ("production", prod), ("batched", bat),
                             ("shading_rate", rate)):
            f.update(fields(prefix, path["launches"][k], path[rep]))
        if k == "raster_depth":       # the production frame's own atlas
            f.update(fields("production_cascade", None,
                            prod["k2_cascade"]))
        # the game frame: its surface (K1) and cascade atlas (K2), the
        # particles' K1 and the bake's K2; the options' supersampled passes
        f.update(fields("game_frame", game["launches"][k], game[rep]))
        if k == "raster_tile":
            f.update(fields("particles", game["launches"][k],
                            game["particles"]))
            f.update(fields("msaa", opt["msaa_launches"][k], opt["msaa"]))
        else:
            f.update(fields("game_frame_bake", None, game["bake"]))
            f.update(fields("shadow_msaa", opt["shadow_msaa_launches"][k],
                            opt["shadow_msaa"]))
        # the authored level: its 640 x 360 frame and its 64-env batch
        f.update(fields("level", lvl["frame_launches"][k], lvl[rep]))
        f.update(fields("level_batch", lvl["batch_launches"][k],
                        lvl[rep + "b"]))
        # the engine shell: Engine.run's frame (its surface and particles
        # on K1, its cascade atlas on K2)
        f.update(fields("engine", eng["launches"][k], eng[rep]))
        if k == "raster_tile":
            f.update(fields("engine_particles", eng["launches"][k],
                            eng["particles"]))
        # the UI slice: the Engine's frame under the overlay (its surface
        # and particles on K1, its cascade atlas on K2) and the flythrough
        # demo's frames
        f.update(fields("overlay", ovl["launches"][k], ovl["overlay_" + rep]))
        if k == "raster_tile":
            f.update(fields("overlay_particles", ovl["launches"][k],
                            ovl["overlay_particles"]))
        f.update(fields("flythrough", ovl["fly_launches"][k], ovl[rep]))
        # normal maps and material fBm (phase 8b: the textured frame's
        # barycentric records and its cascade atlas)
        f.update(fields("tbn", tbn["launches"][k], tbn[rep]))
        # env-axis sharding: the dryrun's composed frame (the last shard's
        # records on the one-card mesh; launches of its run there) and the
        # flagship over that mesh (launches of its 3 frames, the last
        # shard's records)
        f.update(fields("dryrun", shd["dryrun_launches"][k],
                        shd["dryrun_" + rep]))
        f.update(fields("sharded", shd["launches"][k], shd[rep]))
        return f

    # library_ms: no single PyTorch call computes a first-wins tile walk
    # or a multi-generation CA
    src = "clap_tpu_torch/csrc/raster.cu"
    log(json.dumps({"kernels": [
        {"name": "raster_tile", "route": "cuda", "source": src,
         "replaces": "clap_tpu/render/raster.py:1041",
         "launches": launches["raster_tile"], "max_abs_err": tile_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "textured_launches": tex["launches"]["raster_tile"],
         "textured_max_abs_err": tex["max_abs_err"],
         "textured_ms": tex["ms"], "textured_plain_ms": tex["plain_ms"],
         "textured_bound_ms": tex["bound"][0],
         "textured_bound_by": tex["bound"][1], **paths("raster_tile")},
        {"name": "raster_depth", "route": "cuda", "source": src,
         "replaces": "clap_tpu/render/raster.py:633",
         "launches": launches["raster_depth"], "max_abs_err": depth_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "textured_launches": tex["launches"]["raster_depth"],
         **paths("raster_depth")},
        {"name": "ca2d_run_fused", "route": "cuda",
         "source": "clap_tpu_torch/csrc/ca2d.cu",
         "replaces": "clap_tpu/ops/ca2d.py:192",
         "launches": ca["launches"], "max_abs_err": ca["max_abs_err"],
         "ms": ca["ms"], "plain_ms": ca["plain_ms"],
         "bound_ms": ca["bound_ms"], "bound_by": ca["bound_by"],
         "library_ms": None, "barrier_bound_ms": ca["barrier_bound_ms"]},
    ]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def setup_card():
    """Card 0 made current, float32 products at full precision (TF32 off):
    (device, the nvidia-smi line of the card's name and power limit)."""
    import torch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul off")
    return dev, smi


def parity_checks(sync):
    """(check_tile, check_depth): each runs its kernel (K1 ``raster_tile``,
    K2 ``raster_depth``) and its plain version on one argument tuple,
    logs the agreement and requires bit-exact results; returns (kernel
    out, plain out, max abs err). ``sync`` waits for the device."""
    import torch

    from clap_tpu_torch.render import raster as R

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
        require(agree >= 0.995 and derr <= 1e-4 and exact,
                f"K1 bit-exact on {name}")
        return k, r, err

    def check_depth(name, args):
        k = R.raster_depth(*args)
        sync()
        r = R.raster_depth_ref(*args)
        agree, err = cmp_depth(k, r)
        exact = bool(torch.equal(k, r))
        log(f"phase 3 parity {name}: K2 depth agreement {agree:.6f}, max "
            f"err {err:.3g}, bit-exact {exact}")
        require(agree >= 0.995 and exact, f"K2 bit-exact on {name}")
        return k, r, err

    return check_tile, check_depth


def time_ms(fn, args, reps):
    """Device ms per call of ``fn(*args)``, CUDA events around ``reps``
    calls. A spin on the stream holds the start event until every call is
    queued, so the host's launch time between short kernels is not counted
    (where a call waits on the device itself, as the plain walks do, the
    host's pace still shows). The spin is 1.5 times the host time of one
    call per call, counted in cycles at 2 GHz: at the H100's top SM clock
    (1.98 GHz) or below it lasts at least that long."""
    import torch

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * host * reps + 1e-3, 2.0) * 2e9))
    e0.record()
    for _ in range(reps):
        fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def build_slice(dev, n_envs=N_SLICE, textured=False, fbm=False):
    """The slice's world on ``dev``: the composed testbed of bench.py:544-625
    (2 chars, 4 terrain chunks, 96 entities, record_compact 8192, raster_cap
    2048, one directional light) with skinned characters (bench.py:565-588)
    and the game wiring of bench.py:546-559 (the terrain a permanent switch,
    the demo rig on both characters), ``n_envs`` envs at their first state,
    each with its own inputs (``slice_inputs``). ``textured``: the textured
    models and textures of the ``step_and_render_textured`` config
    (bench.py:566-575); ``fbm``: material fBm (tests/test_torch_texture.py's
    parameters) on the sphere and terrain models; kernel_attrs holds where the
    tables allow it, as bench.py:620-621 sets it. Returns a dict: tb, ent,
    rt, cs, textures, lights, opts, gw, gs, ins_at (frame -> Inputs), ins
    (frame 0's)."""
    import torch

    from clap_tpu_torch.anim.system import anim_instances_init
    from clap_tpu_torch.engine.game import GameSessionState, GameWorld
    from clap_tpu_torch.engine.gamelogic import (game_config_empty,
                                                 game_state_init)
    from clap_tpu_torch.render.lights import lights_empty
    from clap_tpu_torch.render.pipeline import RenderOptions
    from clap_tpu_torch.render.scenerender import (build_render_tables,
                                                   default_edge_ids,
                                                   kernel_attrs_ok,
                                                   shadow_static_mask)
    from clap_tpu_torch.scene import testbed as tbm

    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=96, n_chars=2, terrain_chunks=4,
                           device=dev)
    ent = tb.cfg.entities
    models = tbm.testbed_models(tb, skinned_chars=True, textured=textured)
    if fbm:       # the spheres and the terrain chunks (always in view)
        models = [m._replace(mat_fbm=(0.5, 2.0, 0.2, 0.9, 0.0, 0.6))
                  if i == 2 or i >= 4 else m for i, m in enumerate(models)]
    rt = build_render_tables(
        models, ent.model_id, ent.active,
        entity_edge_id=default_edge_ids(ent.active, ent.body_is_char),
        entity_shadow_static=shadow_static_mask(ent), device=dev)
    cs = tbm.build_testbed_char_skin(tb, models, rt, device=dev)
    textures = tbm.testbed_textures(device=dev) if textured else None
    lights = lights_empty(1, device=dev)
    d = torch.tensor([-0.4, -0.8, -0.4], device=dev)
    lights.direction[0] = d / torch.linalg.vector_norm(d)
    lights.color[0] = torch.tensor([1.0, 0.95, 0.9], device=dev)
    lights.is_dir[0] = True
    lights.active[0] = True
    opts = RenderOptions(width=RES, height=RES, shadow_size=256,
                         film_grain=0.0, record_compact=8192,
                         raster_cap=2048, kernel_attrs=kernel_attrs_ok(rt))
    sk, lib, acfg = tbm.build_demo_rig(device=dev)
    gcfg = game_config_empty(1, 96, device=dev)._replace(
        switch_entity=torch.tensor([0], dtype=torch.int32, device=dev),
        switch_valid=torch.tensor([True], device=dev),
        switch_permanent=torch.tensor([True], device=dev))
    gw = GameWorld(scene=tb.cfg, game=gcfg, anim=acfg, anim_sk=sk,
                   anim_lib=lib)
    gs = tbm.replicate_state(GameSessionState(
        engine=tb.state0, game=game_state_init(1, 2, device=dev),
        anim=anim_instances_init(2, device=dev),
        joint_mats=torch.eye(4, device=dev).repeat(2, 3, 1, 1)), n_envs)
    ins_at = slice_inputs(n_envs, dev)
    return dict(tb=tb, ent=ent, rt=rt, cs=cs, textures=textures,
                lights=lights, opts=opts, gw=gw, gs=gs, ins_at=ins_at,
                ins=ins_at(0))


def slice_inputs(n_envs, dev):
    """Each env its own inputs, as tests/test_engine.py:46-60 walks its
    envs in different directions: env e's first character walks along
    angle 2 pi e / n_envs and jumps at frame 2 + e % 8, and its camera
    turns at its own yaw rate (-0.03 to 0.03 rad a frame over the envs);
    the second character stands. Returns ``ins_at(frame)`` -> Inputs
    (B, ...): the tensors are made once on ``dev``, and a frame's jump is
    one comparison on the card."""
    import torch

    from clap_tpu_torch.engine.step import Inputs

    e = torch.arange(n_envs, device=dev)
    ang = e.float() * (2 * math.pi / n_envs)
    motion = torch.zeros((n_envs, 2, 2), device=dev)
    motion[:, 0] = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    cam = torch.zeros((n_envs, 3), device=dev)
    cam[:, 1] = 0.03 * (2.0 * e.float() / max(n_envs - 1, 1) - 1.0)
    jump_at = (2 + e % 8)[:, None]
    first = torch.arange(2, device=dev)[None] == 0
    dash = torch.zeros((n_envs, 2), dtype=torch.bool, device=dev)

    def ins_at(frame):
        return Inputs(motion=motion, jump=(jump_at == frame) & first,
                      cam_delta=cam, dash=dash)

    return ins_at


def sun_lights(dev, n=1, color=(1.0, 0.95, 0.9)):
    """``n`` light slots, slot 0 the one directional light of the JAX
    bench's scenes (direction (-0.4, -0.8, -0.4), bench.py:237-244)."""
    import torch

    from clap_tpu_torch.render.lights import lights_empty

    lights = lights_empty(n, device=dev)
    d = torch.tensor([-0.4, -0.8, -0.4], device=dev)
    lights.direction[0] = d / torch.linalg.vector_norm(d)
    lights.color[0] = torch.tensor(color, device=dev)
    lights.is_dir[0] = True
    lights.active[0] = True
    return lights


def _cube_field(t, n_cubes):
    """bench.py's cube "entities" on the heightfield (bench.py:189-208,
    313-328): per cube its verts, normals and faces, seeded by 9."""
    import numpy as np

    from clap_tpu_torch.scene.primitives import cube

    cv, cn, _cuv, cf = cube(1.6)
    rng = np.random.default_rng(9)
    gx = rng.uniform(-30.0, 30.0, n_cubes)
    gz = rng.uniform(-30.0, 30.0, n_cubes)
    hg = t.heights
    nv = hg.shape[0]
    out = []
    for i in range(n_cubes):
        xi = int((gx[i] + 32.0) / 64.0 * (nv - 1))
        zi = int((gz[i] + 32.0) / 64.0 * (nv - 1))
        h = float(hg[min(xi, nv - 1), min(zi, nv - 1)])
        out.append((cv + np.array([gx[i], h + 0.8, gz[i]], np.float32), cn,
                    cf))
    return out


def look_at(eyes, target, dev):
    """View matrices (B, 4, 4) of eyes (B, 3) looking at ``target``."""
    from clap_tpu_torch import mathx as mx

    return mx.mat4_look_at(eyes, mx.const(target, dev).expand_as(eyes),
                           mx.const([0.0, 1.0, 0.0], dev).expand_as(eyes))


def build_full_frame(dev, nr_v=96, n_cubes=0, raster_cap=0, width=1280,
                     height=720):
    """The JAX bench's ``full_frame`` scene (bench.py:168-244): terrain
    (seed 3, 64 m, ``nr_v``² verts) and ``n_cubes`` cubes as hand-built
    member geometry of one env, faces in Morton order, with the
    corner-expanded static streams (``corner_verts`` corner-major,
    ``shadow_corner_verts`` in record order); 512² cascades, film grain
    off, ``raster_cap``; the camera at (0, 18, 28) looking at (0, 2, 0).
    Returns a dict: geom, opts, eye, view, proj, lights, host (vx, normals,
    faces as numpy)."""
    import math

    import numpy as np
    import torch

    from clap_tpu_torch import mathx as mx
    from clap_tpu_torch.render.pipeline import RenderOptions, SceneGeometry
    from clap_tpu_torch.render.raster import (cluster_faces,
                                              expand_corners_major,
                                              expand_corners_record)
    from clap_tpu_torch.device import resolve_device
    from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

    dev = resolve_device(dev)
    t = terrain_init_square_landscape(3, -32.0, 0.0, -32.0, 64.0, nr_v)
    vx, nrm, idx = t.vx, t.norm, t.idx.reshape(-1, 3)
    if n_cubes:
        vs, ns, fs = [vx], [nrm], [idx]
        base = vx.shape[0]
        for cv, cn, cf in _cube_field(t, n_cubes):
            vs.append(cv)
            ns.append(cn)
            fs.append(cf + base)
            base += cv.shape[0]
        vx = np.concatenate(vs).astype(np.float32)
        nrm = np.concatenate(ns).astype(np.float32)
        idx = np.concatenate(fs).astype(np.int32)
    f_np = np.asarray(cluster_faces(vx, idx)[0])
    V, T = vx.shape[0], f_np.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    geom = SceneGeometry(
        verts=torch.as_tensor(vx, device=dev)[None],
        normals=torch.as_tensor(nrm, device=dev),
        faces=torch.as_tensor(f_np, device=dev),
        face_valid=torch.ones((1, T), dtype=torch.bool, device=dev),
        base_color=torch.full((V, 3), 0.45, **f32),
        rough_metal=torch.tensor([[0.8, 0.0]], **f32).repeat(V, 1),
        emission=torch.zeros((V, 3), **f32),
        corner_verts=expand_corners_major(vx, f_np, dev)[None],
        shadow_corner_verts=expand_corners_record(vx, f_np, dev)[None])
    opts = RenderOptions(width=width, height=height, shadow_size=512,
                         film_grain=0.0, raster_cap=raster_cap)
    eye = torch.tensor([[0.0, 18.0, 28.0]], device=dev)
    return dict(geom=geom, opts=opts, eye=eye,
                view=look_at(eye, [0.0, 2.0, 0.0], dev),
                proj=mx.mat4_perspective(math.pi / 3, width / height, 0.1,
                                         200.0, device=dev),
                lights=sun_lights(dev, 2), host=(vx, nrm, f_np))


def build_production(dev, width=1280, height=720, nr_v=240, n_cubes=256,
                     bake_size=2048, cap=10240 * 8):
    """The JAX bench's ``full_frame_production`` scene (bench.py:281-366):
    the dense scene as render tables (static terrain entity 0, dynamic
    cube-field entity 1), kernel_attrs where eligible, raster_cap 4096,
    cluster records with ``cap`` records, and the terrain's static shadow
    baked at ``bake_size``². Returns a dict: rt, lights, opts, cap, mxs
    (1, 2, 4, 4), eye (1, 3), proj, mx0, bake (s), static_shadow."""
    import math

    import numpy as np
    import torch

    from clap_tpu_torch import mathx as mx
    from clap_tpu_torch.render.pipeline import RenderOptions
    from clap_tpu_torch.render.scenerender import (bake_static_shadow,
                                                   build_render_tables,
                                                   kernel_attrs_ok,
                                                   model_from_mesh)
    from clap_tpu_torch.device import resolve_device
    from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

    dev = resolve_device(dev)
    t = terrain_init_square_landscape(3, -32.0, 0.0, -32.0, 64.0, nr_v)
    vs, ns, fs = [], [], []
    base = 0
    for cv, cn, cf in _cube_field(t, n_cubes):
        vs.append(cv)
        ns.append(cn)
        fs.append(cf + base)
        base += cv.shape[0]
    models = [
        model_from_mesh(t.vx, t.norm, t.idx.reshape(-1, 3),
                        base_color=(0.45, 0.45, 0.45), with_lods=False),
        model_from_mesh(np.concatenate(vs), np.concatenate(ns),
                        np.concatenate(fs), base_color=(0.6, 0.5, 0.4),
                        with_lods=False)]
    rt = build_render_tables(models, np.array([0, 1]), np.ones(2, bool),
                             entity_shadow_static=np.array([True, False]),
                             device=dev)
    lights = sun_lights(dev)
    mx0 = torch.eye(4, device=dev).repeat(2, 1, 1)
    t0 = time.perf_counter()
    static = bake_static_shadow(rt, mx0, lights.direction[0],
                                shadow_size=bake_size)
    if static[0].is_cuda:
        torch.cuda.synchronize()
    bake = time.perf_counter() - t0
    opts = RenderOptions(width=width, height=height, shadow_size=512,
                         film_grain=0.0, raster_cap=4096,
                         kernel_attrs=kernel_attrs_ok(rt))
    return dict(rt=rt, lights=lights, opts=opts, cap=cap,
                mxs=torch.eye(4, device=dev).repeat(1, 2, 1, 1),
                eye=torch.tensor([[0.0, 18.0, 28.0]], device=dev),
                proj=mx.mat4_perspective(math.pi / 3, width / height, 0.1,
                                         200.0, device=dev),
                mx0=mx0, bake=bake, static_shadow=static)


def production_geometry(w, eyes):
    """bench.py:372-384: the views of ``eyes`` (B, 3) and the cluster
    records of the production tables: (geom, views)."""
    import torch

    from clap_tpu_torch.render.scenerender import \
        assemble_cluster_records_batch
    from clap_tpu_torch.render.view import make_subview

    views = look_at(eyes, [0.0, 2.0, 0.0], eyes.device)
    planes = make_subview(views, w["proj"]).planes
    geom = assemble_cluster_records_batch(
        w["rt"], w["mxs"].expand(eyes.shape[0], -1, -1, -1),
        torch.ones((eyes.shape[0], 2), dtype=torch.bool, device=eyes.device),
        planes, eyes, views, w["proj"], cap=w["cap"])
    return geom, views


def production_frame(w, eyes):
    """One ``full_frame_production`` frame of ``eyes`` (B, 3)."""
    from clap_tpu_torch.render.pipeline import render_frame_dynamic_batch

    geom, views = production_geometry(w, eyes)
    return render_frame_dynamic_batch(w["opts"], geom, views, w["proj"],
                                      w["lights"], eyes,
                                      static_shadow=w["static_shadow"])


def build_batched(dev, n_envs=64, res=256):
    """The JAX bench's ``batched_render`` scene (bench.py:423-476): one
    shared terrain (seed 11, 32 m, 48² verts) as render tables, assembled
    once from a reference view (member granularity, the terrain skips
    culling) with its env axis dropped; kernel_attrs where eligible, 256²
    cascade atlas, SSAO off; ``n_envs`` eyes on a ring of radius 12 at
    height 9 looking at the origin. Returns a dict: rt, geom, opts,
    lights, eyes, views, proj."""
    import math

    import numpy as np
    import torch

    from clap_tpu_torch import mathx as mx
    from clap_tpu_torch.render.pipeline import PER_ENV, RenderOptions
    from clap_tpu_torch.render.scenerender import (
        assemble_scene_geometry_batch, build_render_tables, kernel_attrs_ok,
        model_from_mesh)
    from clap_tpu_torch.render.view import make_subview
    from clap_tpu_torch.device import resolve_device
    from clap_tpu_torch.scene.terrain import terrain_init_square_landscape

    dev = resolve_device(dev)
    t = terrain_init_square_landscape(11, -16.0, 0.0, -16.0, 32.0, 48)
    rt = build_render_tables(
        [model_from_mesh(t.vx, t.norm, t.idx.reshape(-1, 3),
                         with_lods=False)], np.array([0]), np.ones(1, bool),
        device=dev)
    proj = mx.mat4_perspective(math.pi / 3, 1.0, 0.1, 100.0, device=dev)
    eye0 = torch.tensor([[12.0, 9.0, 0.0]], device=dev)
    view0 = look_at(eye0, [0.0, 0.0, 0.0], dev)
    gb = assemble_scene_geometry_batch(
        rt, torch.eye(4, device=dev)[None, None],
        torch.ones((1, 1), dtype=torch.bool, device=dev),
        make_subview(view0, proj).planes, eye0,
        skip_culling=torch.tensor([True], device=dev))
    geom = gb._replace(**{f: getattr(gb, f)[0] for f in PER_ENV
                          if getattr(gb, f) is not None})
    ang = torch.arange(n_envs, dtype=torch.float32, device=dev) \
        * (2 * math.pi / n_envs)
    eyes = torch.stack([12 * torch.cos(ang), torch.full_like(ang, 9.0),
                        12 * torch.sin(ang)], -1)
    opts = RenderOptions(width=res, height=res, shadow_size=256,
                         film_grain=0.0, ssao=False,
                         kernel_attrs=kernel_attrs_ok(rt))
    return dict(rt=rt, geom=geom, opts=opts,
                lights=sun_lights(dev, color=(1.0, 1.0, 1.0)), eyes=eyes,
                views=look_at(eyes, [0.0, 0.0, 0.0], dev), proj=proj)


def build_game_frame(dev, width=640, height=360, scene=None, seed=3):
    """The game's own frame as demo/testbed.py:62-200 wires it (``--render``),
    through the port's demo builder (``clap_tpu_torch.demo.testbed.
    build_world``: the testbed with 2 characters, ``scene`` overriding
    build_testbed's arguments, the demo rig, the switch, two spore systems
    of 256 live particles seeded by ``seed``, the four models, three
    textures, the static shadow split, one sun, film grain, particle size
    0.1, ``width`` × ``height`` with 256² cascades); one env. Returns a
    dict: tb, rt, cs, textures, lights, opts, gw, gs, ins, renderer
    (GameFrameRenderer as Engine.attach_graphics makes it, the static
    atlas baked)."""
    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.demo.testbed import build_world
    from clap_tpu_torch.device import resolve_device
    from clap_tpu_torch.engine.core import graphics_renderer
    from clap_tpu_torch.engine.step import inputs_zero
    from clap_tpu_torch.scene.testbed import replicate_state

    dev = resolve_device(dev)
    w = build_world(dev, width=width, height=height, scene=scene, seed=seed)
    tb = w["tb"]
    renderer = graphics_renderer(tb.state0.mx, **w["graphics"])
    ins = tree_map(lambda x: x[None].clone(), inputs_zero(2, device=dev))
    ins.motion[:, 0, 0] = 1.0
    return dict(tb=tb, rt=w["rt"], cs=w["cs"], textures=w["textures"],
                lights=w["lights"], opts=w["opts"], gw=w["gw"],
                gs=replicate_state(w["session0"], 1), ins=ins,
                renderer=renderer)


def make_renderer(w, static, to=None):
    """The SceneRenderer of a ``build_slice`` world with the baked static
    shadow; ``to="cpu"`` makes a copy of it on the CPU."""
    import torch

    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.frame import SceneRenderer

    def mv(t):
        return tree_map(lambda x: x.to(to) if to is not None
                        and torch.is_tensor(x) else x, t)

    return SceneRenderer(mv(w["rt"]), mv(w["lights"]), w["opts"],
                         skip_culling=mv(w["ent"].skip_culling),
                         static_shadow=mv(static), lod_scale=RES / 720.0,
                         char_skin=mv(w["cs"]), textures=mv(w["textures"]))


def drive_frames(w, sync, require, frames=10):
    """The driven run of a ``build_slice`` world: the launch counts start
    at 0, the static shadow bakes, then 1 warm-up and ``frames`` timed
    frames of step_and_render, each env on its own inputs (frame k's call
    takes ``ins_at(k)``). Returns a dict: renderer, static, gs, imgs, st,
    st1 / jm1 (state and joint matrices after frame 1), launches, dt
    (s/frame), warm (s), peak (bytes), summary (a line of checks)."""
    import torch

    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    gw, gs, ins_at = w["gw"], w["gs"], w["ins_at"]
    n = gs.engine.frame.shape[0]
    ins = [ins_at(k) for k in range(frames + 1)]
    frame0 = gs.engine.frame.clone()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    renderer = make_renderer(w, static)
    gs, imgs = step_and_render(gw, renderer, gs, ins[0])
    sync()
    warm = time.perf_counter() - t0
    st1, jm1 = gs.engine, gs.joint_mats.clone()
    t0 = time.perf_counter()
    for k in range(1, frames + 1):
        gs, imgs = step_and_render(gw, renderer, gs, ins[k])
    sync()
    dt = (time.perf_counter() - t0) / frames
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    st = gs.engine
    require(bool(((st.frame - frame0) == frames + 1).all()),
            f"frame counter +{frames + 1}")
    require(bool((gs.anim.queue.clip[..., 0] >= 0).all()),
            "every rig plays an animation clip")
    require(bool(torch.isfinite(gs.joint_mats).all()),
            "joint matrices finite")
    require(bool(torch.isfinite(imgs).all()), "images finite")
    std = imgs.reshape(n, -1).std(dim=1)
    luma = imgs.reshape(n, -1).mean(dim=1)
    require(bool((std > 0.01).all()), "per-env image std > 0.01")
    require(bool(((luma > 0.02) & (luma < 0.98)).all()),
            "per-env mean luma in (0.02, 0.98)")
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on the path: {launches}")
    # distinct envs: every env's walker stands somewhere else, and the
    # first and last env's images differ
    walker = st.phys.pos[:, int(gw.scene.char_params.body[0])]
    n_at = torch.unique(walker, dim=0).shape[0]
    require(n_at == n, f"every env's walker at its own place ({n_at}/{n})")
    require(n == 1 or not torch.equal(imgs[0], imgs[-1]),
            "env 0's image and the last env's differ")
    summary = (f"image std min {float(std.min()):.4f}, mean luma "
               f"{float(luma.min()):.4f}..{float(luma.max()):.4f}, switch "
               f"on in {int(gs.game.switch_on[:, 0].sum())}/{n} envs, clips "
               f"{sorted(set(gs.anim.queue.clip[..., 0].flatten().tolist()))}")
    return dict(renderer=renderer, static=static, gs=gs, imgs=imgs, st=st,
                st1=st1, jm1=jm1, launches=launches, dt=dt, warm=warm,
                peak=peak, summary=summary)


def psnr_envs(n):
    """The envs a frame is held against the CPU path at: 0, 1, n/2, n-1."""
    return sorted({0, min(1, n - 1), n // 2, n - 1})


def cpu_psnr(w, d):
    """PSNR of envs ``psnr_envs`` of the driven run's last frame against
    the same states rendered by the plain CPU path (a CPU copy of the
    renderer)."""
    from clap_tpu_torch.bridge import tree_map

    envs = psnr_envs(d["imgs"].shape[0])
    cpu = make_renderer(w, tuple(x.cpu() for x in d["static"]), to="cpu")
    ref = cpu(tree_map(lambda x: x[envs].cpu(), d["st"]),
              d["gs"].joint_mats[envs].cpu())
    return env_psnr(d["imgs"][envs].cpu(), ref)


def frame_records(renderer, st, joint_mats=None, opts=None):
    """The records and bins of state ``st``'s main pass (22-column extras
    records on the kernel-attrs path, 19-column barycentric records on the
    gather path) and cascade atlas, under ``opts`` (default the
    renderer's): (geometry, rec, binned, srec, sbin, (w, h, th, tw))."""
    from clap_tpu_torch.render.pipeline import (clip_transform,
                                                gather_records,
                                                shadow_records,
                                                surface_records)
    from clap_tpu_torch.render.view import cascade_subviews

    opts = opts or renderer.opts
    views = renderer.views(st)
    geom = renderer.geometry(st, views, joint_mats)
    if renderer.cluster_records:
        rec, binned, _ = surface_records(opts, geom)
    else:
        clip = clip_transform(geom.verts, views, renderer.proj)
        rec, binned = gather_records(opts, geom, clip)[:2]
    casc, _ = cascade_subviews(views, renderer.proj,
                               renderer.lights.direction[0], 0.1, 200.0)
    srec, sbin, dims = shadow_records(opts, geom, casc.view, casc.proj)
    return geom, rec, binned, srec, sbin, dims


def log_bounds(phase, bounds):
    """One line per kernel: its bound from ``walk_bound`` and the counts."""
    for name, (bms, by, n) in bounds:
        log(f"{phase} {name} bound: {bms:.4f} ms ({by}); {n['records']} "
            f"records walked ({n['small']} of the tiles' lists, "
            f"{n['big']} of the big lists once per env; {n['unique']} "
            f"distinct, read once), {n['covered']} "
            f"covered pixel-record pairs, {n['wins']} wins; {n['bytes']} B, "
            f"{n['flops']} flop; pixel-record tests: brute force "
            f"{n['tests']}, the kernel after its per-warp reject "
            f"{n['kernel_tests']} ({n['kept']} of {n['warp_records']} "
            f"warp-records kept)")


def run_textured_phase(dev, smi, require, sync, check_tile, check_depth):
    """Phase 8: the JAX bench's ``step_and_render_textured`` config
    (bench.py:566-575, 620-666) at 64 envs × 256²: skinned and textured
    characters, textured trees, so the tables are not flat-eligible and
    the frame takes the member-granularity assembly and the per-pixel
    attribute gather, K1 in barycentric mode. Checks as phase 5, K1
    bit-exact on frame 11's records and timed beside its plain version,
    its input preparation and its bound; two envs against the CPU path."""
    import torch

    from clap_tpu_torch.render import raster as R

    w = build_slice(dev, textured=True)
    require(not w["opts"].kernel_attrs, "textured tables take the gather "
            "path (kernel_attrs_ok false)")
    d = drive_frames(w, sync, require)
    renderer, gs = d["renderer"], d["gs"]
    require(not renderer.cluster_records, "member-granularity assembly")
    log(f"phase 8 textured (skinned + textured, gather path): {N_SLICE} envs"
        f" x {RES}^2, {d['dt'] * 1e3:.2f} ms/frame, "
        f"{N_SLICE / d['dt']:.1f} env-fps, warm-up frame (bake included) "
        f"{d['warm']:.2f} s, peak memory {d['peak'] / 2**30:.2f} GiB, "
        f"{d['summary']} ({smi})")
    log(f"phase 8 launches in the driven run: {d['launches']}")
    geom, rec, binned, srec, sbin, dims = frame_records(renderer, d["st"],
                                                        gs.joint_mats)
    stats = R.bin_stats(binned)
    log(f"phase 8 records: {rec.shape[1]}-column, {rec.shape[-1]} per env "
        f"(2 x record_compact {renderer.opts.record_compact}), main-pass "
        f"tiles at capacity {stats['tiles_at_cap']}/{stats['n_tiles']} (max "
        f"{stats['max_per_tile']} of {stats['cap']} records)")
    args = R.kernel_inputs(rec, binned, RES, RES)
    _, _, err = check_tile(f"textured frame 11 all {N_SLICE} envs "
                           f"(barycentric records)", args)
    check_depth(f"textured frame 11 all {N_SLICE} envs cascade atlas",
                R.kernel_inputs(srec, sbin, *dims, depth_only=True))
    ms = time_ms(R.raster_tile, args, 20)
    plain = time_ms(R.raster_tile_ref, args, 3)
    prep = time_ms(R.kernel_inputs, (rec, binned, RES, RES), 20)
    bound = walk_bound(R, R.raster_tile_ref, args, R.NCOEF, 5, 12)
    log(f"phase 8 kernel timing ({N_SLICE} envs, frame 11 inputs): K1 "
        f"raster_tile {ms:.3f} ms vs plain {plain:.3f} ms; input "
        f"preparation (kernel_inputs) {prep:.3f} ms ({smi})")
    log_bounds("phase 8", (("K1", bound),))
    psnr = cpu_psnr(w, d)
    log(f"phase 8 end-to-end: envs {psnr_envs(N_SLICE)} (distinct states) "
        f"CUDA frame vs plain CPU path PSNR "
        f"{' / '.join(f'{p:.1f}' for p in psnr)} dB")
    require(min(psnr) >= 35.0, "textured end-to-end PSNR >= 35 dB")
    out = dict(launches=d["launches"], max_abs_err=err, ms=ms,
               plain_ms=plain, bound=bound)
    del d, renderer, gs, geom, rec, binned, args
    torch.cuda.empty_cache()
    return out


def tbn_fbm_frames(dev, n_envs=TBN_ENVS):
    """The textured frame with normal maps and material fBm: the textured
    slice (``build_slice(textured=True, fbm=True)``, each env on its own
    inputs) after 3 frames of ``game_step``, its textures given normal
    layers (tangent space, [0, 1], made from seed 15 as
    tests/test_torch_texture.py makes them; the characters and trees carry
    tangents), rendered through the gather path (K1 on barycentric
    records) at RES² on ``dev`` and on the CPU, each with both features,
    without the normal layers and with the tables' fBm amplitude 0.
    Returns a dict: img / no_normals / no_fbm (``dev``), cpu /
    cpu_no_normals / cpu_no_fbm (the same states on the CPU), launches (of
    the first render), renderer, st, jm (the rendered state and joint
    matrices), geom (its geometry)."""
    import numpy as np
    import torch

    from clap_tpu_torch.engine.game import game_step
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    w = build_slice(dev, n_envs, textured=True, fbm=True)
    L, S = w["textures"].diffuse.shape[:2]
    rng = np.random.default_rng(15)
    nm = np.clip(np.array([0.5, 0.5, 1.0])
                 + rng.uniform(-0.3, 0.3, (L, S, S, 3)), 0.0, 1.0)
    plain_tex = w["textures"]
    w["textures"] = plain_tex._replace(
        normal=torch.as_tensor(nm.astype(np.float32), device=dev))
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    gs = w["gs"]
    for k in range(3):
        gs = game_step(w["gw"], gs, w["ins_at"](k))
    st, jm = gs.engine, gs.joint_mats
    renderer = make_renderer(w, static)
    reset_launches()
    img = renderer(st, jm)
    launches = read_launches()
    geom = renderer.geometry(st, None, jm)
    worlds = {"": w, "no_normals": dict(w, textures=plain_tex),
              "no_fbm": dict(w, rt=w["rt"]._replace(
                  mat_fbm=torch.zeros_like(w["rt"].mat_fbm)))}
    cpu_static = to_device(static, "cpu")
    out = dict(img=img, launches=launches, renderer=renderer, st=st, jm=jm,
               geom=geom)
    for name, wv in worlds.items():
        if name:
            out[name] = make_renderer(wv, static)(st, jm)
        out["cpu_" + name if name else "cpu"] = make_renderer(
            wv, cpu_static, to="cpu")(to_device(st, "cpu"), jm.cpu())
    return out


def env_psnr(a, b, mask=None):
    """PSNR in dB of each env of images ``a`` against ``b`` (B, H, W, 3),
    over the pixels of ``mask`` (B, H, W) where given (nan where an env has
    none)."""
    import torch

    se = ((a.double() - b.double()) ** 2).mean(-1)
    if mask is None:
        mask = torch.ones_like(se, dtype=torch.bool)
    n = mask.reshape(mask.shape[0], -1).sum(1)
    mse = torch.where(mask, se, 0.0).reshape(se.shape[0], -1).sum(1) / n
    return [10 * math.log10(1.0 / max(float(m), 1e-12)) if k else math.nan
            for m, k in zip(mse, n)]


def run_tbn_fbm_check(dev, smi, require, check_tile, check_depth):
    """Phase 8b: ``tbn_fbm_frames`` on the card. The tables carry tangents
    and fBm and the render launches K1 and K2. Each env against the CPU
    path (PSNR >= 35 dB), with both features, with the normal layers only
    and with the fBm only. Each feature is held where it acts: on the
    pixels it moves by ``FEATURE_RMS`` RMS or more in the CPU's image, the
    card's frame is >= 35 dB from the CPU's and the card's frame without
    that feature is < 35 dB from it (the bar fails a card that drops the
    feature). The material fBm of the tables' vertices on the card against
    the CPU shows what the fBm's sin hash gives way to. K1 and K2 on the
    frame's records, bit-exact, timed and bounded. Returns a dict:
    launches, k1, k2 (``kernel_report``s)."""
    import torch

    from clap_tpu_torch.render.shade import material_fbm

    t = tbn_fbm_frames(dev)
    g = t["geom"]
    require(g.tangent is not None and g.mat_fbm is not None
            and bool((g.mat_fbm[:, 0] > 0).any()),
            "the TBN/fBm frame's geometry carries tangents and fBm")
    require(t["launches"] == {"raster_tile": 1, "raster_depth": 1},
            f"the TBN/fBm render launched K1 and K2 once: {t['launches']}")
    img, cpu = t["img"].cpu(), t["cpu"]
    require(bool(torch.isfinite(img).all()), "the TBN/fBm frame is finite")

    def line(vals):
        return " / ".join(f"{p:.1f}" for p in vals)

    both = env_psnr(img, cpu)
    normals_only = env_psnr(t["no_fbm"].cpu(), t["cpu_no_fbm"])
    fbm_only = env_psnr(t["no_normals"].cpu(), t["cpu_no_normals"])
    log(f"phase 8b TBN normal maps + material fBm ({TBN_ENVS} envs x "
        f"{img.shape[2]}x{img.shape[1]}, gather path, launches "
        f"{t['launches']}): CUDA vs plain CPU path PSNR {line(both)} dB; "
        f"normal layers only (fBm amplitude 0 on both) "
        f"{line(normals_only)} dB; fBm only (no normal layers on both) "
        f"{line(fbm_only)} dB ({smi})")
    require(min(both) >= 35.0, "TBN/fBm frame vs CPU PSNR >= 35 dB")
    require(min(normals_only + fbm_only) >= 35.0,
            "each feature alone vs CPU PSNR >= 35 dB")
    for feat, off in (("normal layers", "no_normals"), ("fBm", "no_fbm")):
        moved = ((cpu - t["cpu_" + off]) ** 2).mean(-1).sqrt() >= FEATURE_RMS
        on = env_psnr(img, cpu, moved)
        dropped = env_psnr(t[off].cpu(), cpu, moved)
        whole = env_psnr(t[off].cpu(), cpu)
        per_env = moved.reshape(TBN_ENVS, -1).sum(1).tolist()
        log(f"phase 8b {feat}: {per_env} pixels an env moved by >= "
            f"{FEATURE_RMS} RMS in the CPU frame; there the card's frame "
            f"{line(on)} dB and the card's frame without the {feat} "
            f"{line(dropped)} dB against the CPU's (whole frame without "
            f"them {line(whole)} dB)")
        require(min(per_env) * 1000 >= RES * RES,
                f"the {feat} move >= 0.1 % of the pixels of every env")
        require(min(on) >= 35.0, f"where the {feat} act, card vs CPU >= 35 "
                "dB")
        require(max(dropped) < 35.0, f"where the {feat} act, the card's "
                "frame without them < 35 dB")
    # the fBm of the tables' own vertices, card against CPU
    rt = t["renderer"].rt
    use = rt.mat_fbm[:, 0] > 0
    p, fp = rt.verts[use], rt.mat_fbm[use]
    fk = material_fbm(p, fp[:, 0], 4, fp[:, 1:2]).cpu()
    fc = material_fbm(p.cpu(), fp[:, 0].cpu(), 4, fp[:, 1:2].cpu())
    d = (fk - fc).abs()
    log(f"phase 8b material fBm at the tables' {int(use.sum())} fBm "
        f"vertices, card vs CPU: max abs diff {float(d.max()):.3g}, "
        f"{int((d > 1e-3).sum())} over 1e-3, {int((d > 0.05).sum())} over "
        f"0.05 (the sin hash times 43758.5453 turns an ulp of sin into "
        f"~3e-3 and a fract wrap into ~1)")
    r = t["renderer"]
    _, rec, binned, srec, sbin, dims = frame_records(r, t["st"], t["jm"])
    res = dict(launches=t["launches"])
    res["k1"] = kernel_report("phase 8b", f"TBN/fBm frame {TBN_ENVS} envs "
                              "barycentric records", check_tile, rec, binned,
                              (RES, RES), False, smi)
    res["k2"] = kernel_report("phase 8b", f"TBN/fBm frame cascade atlas "
                              f"{dims[1]}x{dims[0]}", check_depth, srec, sbin,
                              dims, True, smi)
    return res


def driven_run(reps, unit="frames"):
    """What a phase's driven run holds: the warm-up and ``frame_times``'s
    calls."""
    return f"1 warm-up, {reps} wall-timed and {reps} profiled {unit}"


def _raw_busy_ns(prof):
    """The summed duration of the CUDA activity among ``prof``'s raw
    events. ``prof.profiler.kineto_results`` is private to torch.profiler:
    ``check_device_busy`` holds this sum against ``key_averages()``'s once a
    run, and a torch without the attribute stops the script here."""
    from torch.autograd import DeviceType

    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is None:
        raise RuntimeError("torch.profiler has no kineto_results in this "
                           "torch: device_busy_ms cannot read its raw events")
    return sum(e.duration_ns() for e in res.events()
               if e.device_type() == DeviceType.CUDA)


def device_busy_ops(fn):
    """The card's busy ms in one call of ``fn()`` and its number of device
    operations (kernels, copies, fills): (ms, ops). The ms are the summed
    time of the call's kernels, copies and fills under torch.profiler
    (CUDA activity), read from its raw events (the same sum as
    ``key_averages()``, which takes 10-20 s to build for the 54,000 kernels
    of a level frame). A frame queues more kernels than the launch queue
    holds, so CUDA events around it measure the host's pace as well; the
    profiler's sum does not.

    A record can lose device events. On an H100 one record lost all of
    them; others lost kernels in their first millisecond or so (30 of a
    render's 3,722, every tenth launch there; in a long run, 4-7 in every
    record). So each record opens with 64 small launches and a
    synchronize, which take that loss, and counts only the device events
    that answer a host call made after that synchronize (by correlation
    id). Every kernel launch of the call must have its kernel in the
    record, else the call is profiled again, up to five records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pad = torch.zeros(1, device="cuda")
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(64):
                pad.add_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        host = [e for e in events if e.device_type() != DeviceType.CUDA]
        start = min(e.correlation_id() for e in host
                    if e.name() == "cudaDeviceSynchronize")
        calls = {e.correlation_id(): e.name() for e in host
                 if e.correlation_id() > start}
        dev = [e for e in events if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in calls]
        launches = {c for c, name in calls.items()
                    if name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))}
        lost = launches - {e.correlation_id() for e in dev}
        if launches and not lost:
            return sum(e.duration_ns() for e in dev) / 1e6, len(dev)
        log(f"profiler record short: {len(lost)} of {len(launches)} kernel "
            f"launches without their kernel; profiling again")
    raise RuntimeError("five profiler records in a row lost kernels")


def device_busy_ms(fn):
    """The card's busy ms in one call of ``fn()`` (``device_busy_ops``)."""
    return device_busy_ops(fn)[0]


def check_device_busy(dev):
    """Hold ``device_busy_ms``'s raw sum against ``key_averages()``'s (the
    CUDA rows' self device time) on a small workload of kernels, a fill and
    a copy: they must agree within 1 us or 0.1 %. Returns (raw ms,
    key_averages ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(512, 512, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            a = torch.tanh(a @ a * 1e-3)
        torch.zeros(1 << 20, device=dev)
        a.cpu()
        torch.cuda.synchronize()
    raw = _raw_busy_ns(prof) / 1e6
    avg = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            avg += (e.self_cuda_time_total if t is None else t) / 1e3
    require(raw > 0 and abs(raw - avg) <= max(1e-3, 1e-3 * avg),
            f"the profiler's raw device sum {raw:.4f} ms equals "
            f"key_averages()'s {avg:.4f} ms")
    return raw, avg


def frame_times(fn, reps):
    """``reps`` wall times (host clock around one call that ends in a
    synchronize) and ``reps`` device busy times (``device_busy_ms``) of
    ``fn()``, in ms: (wall list, busy list)."""
    import torch

    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return wall, [device_busy_ms(fn) for _ in range(reps)]


def spread(ms):
    """``median (range lo-hi)`` of a list of ms."""
    s = sorted(ms)
    return f"{s[len(s) // 2]:.2f} ms (range {s[0]:.2f}-{s[-1]:.2f})"


def median(ms):
    return sorted(ms)[len(ms) // 2]


def reset_launches():
    from clap_tpu_torch.render import raster as R

    R.raster_tile.launches = 0
    R.raster_depth.launches = 0


def read_launches():
    from clap_tpu_torch.render import raster as R

    return {"raster_tile": R.raster_tile.launches,
            "raster_depth": R.raster_depth.launches}


def kernel_report(phase, name, check, rec, binned, dims, depth_only, smi):
    """One kernel on one path's inputs: bit-exact against its plain version
    (``check``), timed beside it, its input preparation (kernel_inputs)
    timed, and its bound from ``walk_bound``. Returns a dict: max_abs_err,
    ms, plain_ms, prep_ms, bound (ms, by, counts)."""
    from clap_tpu_torch.render import raster as R

    kernel, plain = (R.raster_depth, R.raster_depth_ref) if depth_only \
        else (R.raster_tile, R.raster_tile_ref)

    def prep():
        return R.kernel_inputs(rec, binned, *dims, depth_only=depth_only)

    args = prep()
    err = check(name, args)[2]
    ms = time_ms(kernel, args, 20)
    plain_ms = time_ms(plain, args, 2)
    prep_ms = time_ms(prep, (), 20)
    bound = walk_bound(R, plain, args, R.NCOEF_DEPTH if depth_only
                       else R.NCOEF, 1 if depth_only else 5,
                       0 if depth_only else 12)
    k = "K2 raster_depth" if depth_only else "K1 raster_tile"
    log(f"{phase} kernel timing ({name}): {k} {ms:.3f} ms vs plain "
        f"{plain_ms:.3f} ms; input preparation (kernel_inputs) "
        f"{prep_ms:.3f} ms; {bound[0] / ms:.1%} of its bound ({smi})")
    log_bounds(phase, ((k.split()[0], bound),))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, prep_ms=prep_ms,
                bound=bound)


def image_checks(phase, require, img0, img1):
    """The JAX bench's image checks: finite, std > 0.01, and the nudged
    camera's frame differs from the first (bench.py:250-257)."""
    import torch

    std = float(img0.std())
    depends = bool(((img0 - img1).abs() > 1e-6).any())
    require(bool(torch.isfinite(img0).all()), f"{phase} image finite")
    require(std > 0.01, f"{phase} image std > 0.01")
    require(depends, f"{phase} image depends on the camera")
    return std, depends


def run_full_frame_phase(dev, smi, require, check_tile, check_depth,
                         reps=3):
    """Phase 9: the JAX bench's ``full_frame`` (bench.py:168-278) at 1280 ×
    720, its default scene (nr_v 96, no cubes, raster_cap 0) and the dense
    one (nr_v 240, 256 cubes, raster_cap 4096), both with corner-expanded
    static streams: 1 warm-up + ``reps`` frames, wall and device ms, peak
    memory, binning saturation, the image checks; K1 and K2 bit-exact on
    each frame's records and cascade atlas with times and bounds; the
    default frame against the plain CPU path."""
    import torch

    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.pipeline import (clip_transform,
                                                gather_records, render_frame,
                                                shadow_records)
    from clap_tpu_torch.render.view import cascade_subviews

    out = {}
    for name, nr_v, n_cubes, cap in (("full_frame", 96, 0, 0),
                                     ("full_frame_dense", 240, 256, 4096)):
        w = build_full_frame(dev, nr_v, n_cubes, cap)
        geom, opts, proj, lights = w["geom"], w["opts"], w["proj"], \
            w["lights"]

        def frame(eye, view):
            return render_frame(opts, geom, view, proj, lights, eye)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        img0 = frame(w["eye"], w["view"])
        wall, devt = frame_times(lambda: frame(w["eye"], w["view"]), reps)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        require(all(v > 0 for v in launches.values()),
                f"{name}: every kernel launched on the path: {launches}")
        eye2 = w["eye"] + torch.tensor([[0.5, 0.0, 0.0]], device=dev)
        img1 = frame(eye2, look_at(eye2, [0.0, 2.0, 0.0], dev))
        std, _ = image_checks(f"phase 9 {name}", require, img0, img1)
        # binning saturation of the face path's records (bench.py:260-267)
        rec, ok, _, _ = R.clip_near_records(
            clip_transform(geom.verts, w["view"], proj), geom.faces,
            opts.width, opts.height, geom.face_valid)
        bs = R.bin_stats(R.bin_triangles(rec, ok, opts.width, opts.height,
                                         cap=cap or None))
        T = geom.faces.shape[0]
        log(f"phase 9 {name}: {opts.width}x{opts.height}, {T} triangles, "
            f"{spread(wall)} wall / {spread(devt)} device busy per frame "
            f"({1e3 / median(wall):.1f} fps), peak memory "
            f"{peak / 2**30:.2f} GiB, tiles at capacity "
            f"{bs['tiles_at_cap']}/{bs['n_tiles']} (max {bs['max_per_tile']}"
            f" of {bs['cap']} records), image std {std:.4f}, input-dependent "
            f"True; launches in the driven run ({driven_run(reps)}) "
            f"{launches} ({smi})")
        clip = clip_transform(geom.corner_verts, w["view"], proj)
        rec, binned = gather_records(opts, geom, clip)[:2]
        k1 = kernel_report(
            "phase 9", f"{name} 720p records from the corner stream "
            f"({rec.shape[-1]} records)", check_tile, rec, binned,
            (opts.width, opts.height), False, smi)
        casc, _ = cascade_subviews(w["view"], proj, lights.direction[0],
                                   0.1, 200.0)
        srec, sbin, dims = shadow_records(opts, geom, casc.view, casc.proj)
        k2 = kernel_report(
            "phase 9", f"{name} cascade atlas {dims[1]}x{dims[0]}",
            check_depth, srec, sbin, dims, True, smi)
        out[name] = dict(launches=launches, wall=wall, device=devt,
                         tris=T, tiles_at_cap=bs["tiles_at_cap"], k1=k1,
                         k2=k2)
        if name == "full_frame":
            cpu = tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x,
                           (geom, w["view"], proj, lights, w["eye"]))
            ref = render_frame(opts, cpu[0], cpu[1], cpu[2], cpu[3], cpu[4])
            mse = float(((img0.cpu() - ref) ** 2).mean())
            p = 10 * math.log10(1.0 / max(mse, 1e-12))
            log(f"phase 9 {name} end-to-end: the 720p CUDA frame vs the "
                f"plain CPU path PSNR {p:.1f} dB")
            require(p >= 35.0, "full_frame 720p PSNR >= 35 dB vs the CPU")
        del w, geom, img0, img1, rec, binned, srec, sbin
        torch.cuda.empty_cache()
    return out


def run_production_phase(dev, smi, require, check_tile, check_depth,
                         reps=3):
    """Phase 10: the JAX bench's ``full_frame_production``
    (bench.py:281-420): the dense scene as render tables, kernel_attrs,
    cluster records with cap 81,920, the terrain baked once into a 2,048²
    atlas, 1280 × 720: the bake cold and warm, 1 warm-up + ``reps``
    frames, the image checks, clusters at the cap; K1 (extras, 720p) and
    K2 (the 2,048² bake and the frame's 4 × 512² cascade atlas) bit-exact
    with times and bounds."""
    import torch

    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.pipeline import (RenderOptions,
                                                shadow_records,
                                                surface_records)
    from clap_tpu_torch.render.scenerender import (bake_static_shadow,
                                                   static_shadow_geometry)
    from clap_tpu_torch.render.view import cascade_subviews

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    w = build_production(dev)
    require(w["opts"].kernel_attrs, "production tables are kernel_attrs "
            "eligible")
    bake_cold, size = w["bake"], w["static_shadow"][0].shape[-2]
    opts = w["opts"]
    t0 = time.perf_counter()
    bake_static_shadow(w["rt"], w["mx0"], w["lights"].direction[0],
                       shadow_size=size)
    torch.cuda.synchronize()
    bake_warm = time.perf_counter() - t0
    img0 = production_frame(w, w["eye"])
    wall, devt = frame_times(lambda: production_frame(w, w["eye"]), reps)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(all(v > 0 for v in launches.values()),
            f"production: every kernel launched on the path: {launches}")
    img1 = production_frame(w, w["eye"] + torch.tensor([[0.5, 0.0, 0.0]],
                                                       device=dev))
    std, _ = image_checks("phase 10 production", require, img0, img1)
    geom, views = production_geometry(w, w["eye"])
    nval = int(geom.comp_valid.sum()) // R.CLUSTER
    at_cap = nval >= w["cap"] // R.CLUSTER
    rt = w["rt"]
    log(f"phase 10 full_frame_production: {opts.width}x{opts.height}, "
        f"{rt.faces.shape[0]} triangles, kernel_attrs True, cluster records "
        f"(cap {w['cap']}): {nval} valid clusters, clusters_at_cap "
        f"{at_cap}; static bake {size}^2 of "
        f"{rt.static_shadow_faces.shape[0]} triangles cold "
        f"{bake_cold * 1e3:.1f} ms, warm {bake_warm * 1e3:.1f} ms; dynamic "
        f"shadow triangles {rt.shadow_faces.shape[0]}; {spread(wall)} wall "
        f"/ {spread(devt)} device busy per frame "
        f"({1e3 / median(wall):.1f} fps), "
        f"peak memory {peak / 2**30:.2f} GiB, image std {std:.4f}, "
        f"input-dependent True; launches in the driven run (the bake twice,"
        f" {driven_run(reps)}) {launches} ({smi})")
    rec, binned, _ = surface_records(opts, geom)
    k1 = kernel_report("phase 10", f"production {opts.height}p extras "
                       f"records ({rec.shape[-1]} records)", check_tile, rec,
                       binned, (opts.width, opts.height), False, smi)
    g, sv, _ = static_shadow_geometry(rt, w["mx0"], w["lights"].direction[0])
    srec, sbin, dims = shadow_records(RenderOptions(shadow_size=size), g,
                                      sv.view[None], sv.proj[None])
    k2 = kernel_report("phase 10", f"production static bake "
                       f"{dims[1]}x{dims[0]}", check_depth, srec, sbin, dims,
                       True, smi)
    # the per-frame atlas: the frame's own cascades over the dynamic
    # casters (render_frame's far 200)
    casc, _ = cascade_subviews(views, w["proj"], w["lights"].direction[0],
                               0.1, 200.0)
    srec, sbin, dims = shadow_records(opts, geom, casc.view, casc.proj)
    k2c = kernel_report("phase 10", f"production cascade atlas "
                        f"{dims[1]}x{dims[0]}", check_depth, srec, sbin, dims,
                        True, smi)
    del w, geom, img0, img1, rec, srec
    torch.cuda.empty_cache()
    return dict(launches=launches, wall=wall, device=devt, k1=k1, k2=k2,
                k2_cascade=k2c)


def run_batched_phase(dev, smi, require, check_tile, check_depth, reps=3):
    """Phase 11: the JAX bench's ``batched_render`` (bench.py:423-497): 64
    views × 256² of one shared terrain, kernel_attrs over member geometry,
    ``render_frame_batch`` with one shared light atlas: 1 warm-up +
    ``reps`` batches, wall and device ms, frames/s, peak memory; the shadow
    pass launched once per batch on one (1, S, S) atlas, bit-exact on the
    inputs the first batch gave it; K1 (extras records built from faces
    and normals) and K2 (the shared atlas) bit-exact with times and
    bounds."""
    import torch

    from clap_tpu_torch.render import raster as R
    from clap_tpu_torch.render.pipeline import (clip_transform, per_env,
                                                render_frame_batch,
                                                shadow_records,
                                                surface_records)
    from clap_tpu_torch.render.view import bounds_light_subview

    w = build_batched(dev, N_SLICE, RES)
    require(w["opts"].kernel_attrs, "batched terrain is kernel_attrs "
            "eligible")
    geom, opts = w["geom"], w["opts"]
    n, res, S = w["eyes"].shape[0], opts.width, opts.shadow_size

    def frame():
        return render_frame_batch(opts, geom, w["views"], w["proj"],
                                  w["lights"], w["eyes"], far=100.0)

    class Seen:
        """K2's wrapper, keeping the arguments of each call; its count is
        the wrapper's own (the wrapper adds to ``raster_depth.launches``,
        which this name stands for while it is in place)."""

        def __init__(self, fn):
            self.fn, self.calls = fn, []

        launches = property(lambda s: s.fn.launches,
                            lambda s, v: setattr(s.fn, "launches", v))

        def __call__(self, *args):
            self.calls.append(args)
            return self.fn(*args)

    # K2's inputs in the first batch: the atlas the batch hands on
    k2 = R.raster_depth
    seen = R.raster_depth = Seen(k2)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        img = frame()
    finally:
        R.raster_depth = k2
    depth_calls = seen.calls
    torch.cuda.synchronize()
    one = read_launches()
    wall, devt = frame_times(frame, reps)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(one == {"raster_tile": 1, "raster_depth": 1},
            f"one K1 and one K2 launch per batch (the shared atlas): {one}")
    atlas = [(a[0].shape[0], a[5], a[4]) for a in depth_calls]
    require(atlas == [(1, S, S)], f"the batch's K2 launch renders one "
            f"shared {S}x{S} atlas, not one per view: (B, H, W) {atlas}")
    check_depth(f"batched shared atlas {S}x{S} as the first batch gave it",
                depth_calls[0])
    del depth_calls, seen
    img_std = float(img.std())
    require(bool(torch.isfinite(img).all()), "batched images finite")
    require(img_std > 0.01, "batched img_std > 0.01")
    log(f"phase 11 batched_render: {n} views x {res}^2 of one terrain "
        f"({geom.faces.shape[0]} triangles, member granularity, "
        f"kernel_attrs), shared light atlas: {spread(wall)} wall / "
        f"{spread(devt)} device busy per batch ({n * 1e3 / median(wall):.1f} "
        f"frames/s), peak memory {peak / 2**30:.3f} GiB, img_std "
        f"{img_std:.4f}; launches per batch {one}, in the driven run "
        f"({driven_run(reps, 'batches')}) {launches} ({smi})")
    gb = per_env(geom, n)
    rec, binned, _ = surface_records(
        opts, gb, clip_transform(gb.verts, w["views"], w["proj"]))
    k1 = kernel_report("phase 11", f"batched {n} views extras records from "
                       f"faces and normals", check_tile, rec, binned,
                       (res, res), False, smi)
    g1 = per_env(geom, 1)
    sv, _ = bounds_light_subview(geom.verts.amin(0) - 1.0,
                                 geom.verts.amax(0) + 1.0,
                                 w["lights"].direction[0], far=100.0)
    srec, sbin, dims = shadow_records(opts, g1, sv.view[None], sv.proj[None])
    k2 = kernel_report("phase 11", f"batched shared atlas "
                       f"{dims[1]}x{dims[0]}", check_depth, srec, sbin, dims,
                       True, smi)
    del w, geom, img, rec, srec
    torch.cuda.empty_cache()
    return dict(launches=launches, per_batch=one, wall=wall, device=devt,
                k1=k1, k2=k2)


def run_shading_rate_phase(dev, smi, sync, require, check_tile, check_depth,
                           reps=3):
    """Phase 12: the JAX bench's ``shading_rate`` (bench.py:739-755,
    879-884): the skinned flagship at 8 envs rendered at internal_scale 2
    and 1 from the same state after one step, the PSNR between them; then
    64 envs at internal_scale 2 driven as phase 5 (1 warm-up + 10 frames),
    ms/frame and env-fps, wall and device ms of ``reps`` more frames; K1
    (extras records at the internal 128²) and K2 (the cascade atlas) on
    the last frame's inputs bit-exact with times and bounds."""
    import dataclasses

    import torch

    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    w = build_slice(dev, 8)
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    gs, full = step_and_render(w["gw"], make_renderer(w, static), w["gs"],
                               w["ins"])
    half = make_renderer(dict(w, opts=dataclasses.replace(
        w["opts"], internal_scale=2)), static)(gs.engine, gs.joint_mats)
    sync()
    require(half.shape == full.shape == (full.shape[0], RES, RES, 3),
            "internal_scale 2 image has the full shape")
    require(bool(torch.isfinite(half).all()), "internal_scale 2 finite")
    require(not torch.equal(half, full), "internal_scale 2 is not the full "
            "resolution frame")
    mse = float(((half - full) ** 2).mean())
    psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    log(f"phase 12 shading_rate: {full.shape[0]} envs x {RES}^2 skinned "
        f"flagship, "
        f"internal_scale 2 vs 1 from the same state: PSNR {psnr:.2f} dB")
    del w, gs, full, half
    w = build_slice(dev)
    w["opts"] = dataclasses.replace(w["opts"], internal_scale=2)
    d = drive_frames(w, sync, require)
    renderer, gs = d["renderer"], d["gs"]
    wall, devt = frame_times(
        lambda: step_and_render(w["gw"], renderer, gs, w["ins"]), reps)
    log(f"phase 12 shading_rate: {N_SLICE} envs x {RES}^2 at internal_scale"
        f" 2 ({RES // 2}^2 shading): {d['dt'] * 1e3:.2f} ms/frame over 10 "
        f"frames, {N_SLICE / d['dt']:.1f} env-fps; {spread(wall)} wall / "
        f"{spread(devt)} device busy per frame; peak memory "
        f"{d['peak'] / 2**30:.2f} GiB, {d['summary']}; launches in the "
        f"driven run {d['launches']} ({smi})")
    # the internal frame's inputs: render_frame renders at W // s, H // s
    # with internal_scale 1 (max(., 8) does not bind at 256 / 2)
    ires = RES // 2
    iopts = dataclasses.replace(renderer.opts, width=ires, height=ires,
                                internal_scale=1)
    _, rec, binned, srec, sbin, dims = frame_records(
        renderer, gs.engine, gs.joint_mats, iopts)
    k1 = kernel_report("phase 12", f"shading_rate {N_SLICE} envs internal "
                       f"{ires}^2 extras records", check_tile, rec, binned,
                       (ires, ires), False, smi)
    k2 = kernel_report("phase 12", f"shading_rate {N_SLICE} envs cascade "
                       f"atlas {dims[1]}x{dims[0]}", check_depth, srec, sbin,
                       dims, True, smi)
    out = dict(launches=d["launches"], psnr=psnr, ms=d["dt"] * 1e3,
               wall=wall, device=devt, k1=k1, k2=k2)
    del d, renderer, gs, w, rec, binned, srec, sbin
    torch.cuda.empty_cache()
    return out


def run_game_frame_phase(dev, smi, require, check_tile, check_depth,
                         frames=5, reps=3):
    """Phase 13: the game's own frame (demo/testbed.py:62-200 through
    ``game_frame_step``: game_step with the camera occlusion, then
    GameFrameRenderer) at 1 env × 640 × 360 with two spore systems of 256
    live particles, film grain and the 1,024² static bake: the counts
    start at 0 before the renderer is built (the bake is the path's), 1
    warm-up + ``frames`` wall-timed frames + ``reps`` profiled ones, each
    frame finite with std > 0.01, two K1 launches a frame (the surface and
    the particles) and one K2 (the cascade atlas) besides the bake;
    particles and grain change pixels; K1 bit-exact on the frame's
    particle and surface records, K2 on its atlas and the bake, timed
    beside their plain versions and bounded; the frame against the port's
    own CPU path (the JAX package cannot raster 640 wide)."""
    import copy

    import torch

    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.frame import game_frame_step

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    w = build_game_frame(dev)
    r, gw, gs, ins = w["renderer"], w["gw"], w["gs"], w["ins"]
    W, H = r.opts.width, r.opts.height
    calls = 0

    def step(gs):
        nonlocal calls
        calls += 1
        return game_frame_step(gw, r, gs, ins)

    t0 = time.perf_counter()
    gs, img = step(gs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    walls, stds = [], []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs, img = step(gs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(img).all()), "game frame finite")
        stds.append(float(img.std()))
    busy = [device_busy_ms(lambda: step(gs)) for _ in range(reps)]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(min(stds) > 0.01, f"every game frame has std > 0.01: {stds}")
    require(launches == {"raster_tile": 2 * calls,
                         "raster_depth": calls + 1},
            f"two K1 launches a frame (surface, particles), one K2 (the "
            f"cascades) and the bake over {calls} frames: {launches}")
    st, jm = gs.engine, gs.joint_mats
    rwall, rbusy = frame_times(lambda: r(st, gs.particles, None, jm), 3)
    no_parts = r(st, None, None, jm)
    n_parts = int(((img - no_parts).abs().amax(-1) > 0.02).sum())
    grain, r.grain_noise = r.grain_noise, None
    no_grain = r(st, gs.particles, None, jm)
    r.grain_noise = grain
    g_share = float(((img - no_grain).abs().amax(-1) > 1e-3).float().mean())
    require(n_parts > 20, f"particles change pixels ({n_parts})")
    require(g_share > 0.3, f"film grain changes pixels ({g_share:.3f})")
    log(f"phase 13 game frame (demo/testbed.py --render): 1 env x {W}x{H}, "
        f"{gs.particles.pos[0, :, :, 0].numel()} particles in 2 systems "
        f"({int(r.particle_active.sum())} live), grain {r.opts.film_grain}: {spread(walls)} wall over "
        f"{frames} frames (game_step + render; warm-up with the bake "
        f"{warm:.2f} s) / {spread(busy)} device busy per frame; the render "
        f"alone {spread(rwall)} wall / {spread(rbusy)} device busy; peak "
        f"memory {peak / 2**30:.3f} GiB; image std {min(stds):.4f}.."
        f"{max(stds):.4f}; particles change {n_parts} pixels, grain "
        f"{g_share:.1%}; launches in the driven run (bake, "
        f"{calls} frames) {launches} ({smi})")
    kp, k1, k2 = game_frame_kernels("phase 13", "game frame", r, st,
                                    gs.particles, jm, check_tile, check_depth,
                                    smi)
    brec, bbin, bd = bake_records(w["rt"], w["tb"], w["lights"])
    kb = kernel_report("phase 13", f"game frame static bake {bd[1]}x{bd[0]}",
                       check_depth, brec, bbin, bd, True, smi)
    cpu = copy.deepcopy(r).to("cpu")
    ref = cpu(*tree_map(lambda x: x.cpu(), (st, gs.particles)), None,
              jm.cpu())
    mse = float(((img.cpu() - ref) ** 2).mean())
    p = 10 * math.log10(1.0 / max(mse, 1e-12))
    log(f"phase 13 end-to-end: the {W}x{H} CUDA game frame vs the port's "
        f"plain CPU path PSNR {p:.1f} dB")
    require(p >= 35.0, "game frame PSNR >= 35 dB vs the CPU path")
    out = dict(launches=launches, wall=walls, device=busy, render_wall=rwall,
               render_device=rbusy, psnr=p, k1=k1, particles=kp, k2=k2,
               bake=kb)
    del w, r, gs, img, brec, cpu
    torch.cuda.empty_cache()
    return out


def game_frame_kernels(phase, label, r, st, particles, jm, check_tile,
                       check_depth, smi):
    """K1 on a GameFrameRenderer frame's particle billboards and surface
    records and K2 on its cascade atlas, each from the state ``st``, its
    ``particles`` and joint matrices ``jm`` (``kernel_report``): (K1
    particles, K1 surface, K2 atlas) reports."""
    from clap_tpu_torch.render.pipeline import (clip_transform,
                                                gather_records,
                                                particle_records,
                                                shadow_records)
    from clap_tpu_torch.render.view import cascade_subviews

    W, H = r.opts.width, r.opts.height
    view = r.view(st)
    rec, binned = particle_records(
        r.opts, particles.pos.reshape(1, -1, 3), r.particle_size,
        r.particle_active, view, r.proj)
    kp = kernel_report(phase, f"{label} particle billboards "
                       f"({rec.shape[-1]} records)", check_tile, rec, binned,
                       (W, H), False, smi)
    geom = r.geometry(st, view, jm)
    rec, binned = gather_records(r.opts, geom, clip_transform(
        geom.verts, view, r.proj))[:2]
    k1 = kernel_report(phase, f"{label} surface {W}x{H} "
                       f"({rec.shape[-1]} records)", check_tile, rec, binned,
                       (W, H), False, smi)
    casc, _ = cascade_subviews(view, r.proj, r.lights.direction[0], 0.1,
                               r.far)
    srec, sbin, dims = shadow_records(r.opts, geom, casc.view, casc.proj)
    k2 = kernel_report(phase, f"{label} cascade atlas {dims[1]}x{dims[0]}",
                       check_depth, srec, sbin, dims, True, smi)
    return kp, k1, k2


def run_options_phase(dev, smi, require, check_tile, check_depth, reps=3):
    """Phase 14: the render options on the skinned flagship (phase 5's
    world at 64 envs × 256²) from one state after a step: the default
    frame, then one frame per option (model_msaa 2, shadow_msaa 2, PCF,
    laplace edges, SSAO kernel mode, fog noise, material fog, a baked
    ``teal orange`` LUT at 32³) and the pause-menu blur of the default
    frame: per variant 1 warm-up + ``reps`` wall-timed and ``reps``
    profiled frames, peak memory, launches; each finite, full-size and
    different from the default frame. K1 bit-exact on model_msaa 2's 512²
    records and K2 on shadow_msaa 2's (64, 2,048, 512) atlas, timed and
    bounded."""
    import dataclasses

    import torch

    from clap_tpu_torch.engine.game import game_step
    from clap_tpu_torch.render.lut import bake_lut, lut_find
    from clap_tpu_torch.render.pipeline import menu_blur
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    w = build_slice(dev)
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    gs = game_step(w["gw"], w["gs"], w["ins"])
    st, jm = gs.engine, gs.joint_mats
    base = w["opts"]
    lut = bake_lut(lut_find("teal orange"), 32, device=dev)
    variants = [
        ("default", {}, {}),
        ("model_msaa 2", dict(model_msaa=2), {}),
        ("shadow_msaa 2", dict(shadow_msaa=2), {}),
        ("pcf", dict(shadow_vsm=False), {}),
        ("laplace edges", dict(edge_sobel=False), {}),
        ("ssao kernel", dict(ssao_mode="kernel"), {}),
        ("fog_noise", dict(fog_noise=True), {}),
        ("material_fog", dict(material_fog=True), {}),
        ("lighting_lut teal orange 32^3", dict(lighting_lut=True),
         dict(lut_volume=lut)),
    ]
    out, default = {}, None
    shape = (st.pos.shape[0], RES, RES, 3)
    for name, okw, rkw in variants + [("menu_blur", None, None)]:
        if okw is None:
            def fn():
                return menu_blur(default, base)
        else:
            rv = make_renderer(dict(w, opts=dataclasses.replace(base, **okw)),
                               static)

            def fn(rv=rv, rkw=rkw):
                return rv(st, jm, **rkw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        img = fn()
        wall, busy = frame_times(fn, reps)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        require(tuple(img.shape) == shape and bool(torch.isfinite(img).all()),
                f"{name}: finite {shape} frame")
        diff = 0.0 if default is None else float((img - default).abs().max())
        if default is None:
            default = img
        else:
            require(diff > 0.0, f"{name} differs from the default frame")
        if okw is not None:
            require(all(v > 0 for v in launches.values()),
                    f"{name}: K1 and K2 launched: {launches}")
        log(f"phase 14 option {name}: {spread(wall)} wall / {spread(busy)} "
            f"device busy per frame of {shape[0]} envs x {RES}^2, peak "
            f"memory {peak / 2**30:.2f} GiB, max abs diff from the default "
            f"frame {diff:.4g}; launches in its run (1 warm-up, {reps} "
            f"wall-timed and {reps} profiled) {launches} ({smi})")
        out[name] = dict(wall=wall, device=busy, peak=peak, diff=diff,
                         launches=launches)
        del img
    msaa = dataclasses.replace(base, width=2 * RES, height=2 * RES)
    rf = make_renderer(w, static)
    _, rec, binned, _, _, _ = frame_records(rf, st, jm, msaa)
    k1 = kernel_report("phase 14", f"model_msaa 2 {shape[0]} envs "
                       f"{2 * RES}^2 extras records", check_tile, rec, binned,
                       (2 * RES, 2 * RES), False, smi)
    smsaa = dataclasses.replace(base, shadow_msaa=2)
    *_, srec, sbin, dims = frame_records(rf, st, jm, smsaa)
    k2 = kernel_report("phase 14", f"shadow_msaa 2 {shape[0]} envs cascade "
                       f"atlas {dims[1]}x{dims[0]}", check_depth, srec, sbin,
                       dims, True, smi)
    del w, rf, rec, binned, srec, sbin, default
    torch.cuda.empty_cache()
    return dict(variants=out, msaa=k1, shadow_msaa=k2,
                msaa_launches=out["model_msaa 2"]["launches"],
                shadow_msaa_launches=out["shadow_msaa 2"]["launches"])


# the rotating beam of tests/test_rotating_platform.py:20-32: collision that
# follows its entity's full transform
ROTATING_BEAM = {
    "name": "rot_platform",
    "collision_follows_entities": True,
    "collision_follows_rotation": True,
    "model": [
        {"name": "hero", "gltf": "box:0.6,2.0,0.6",
         "physics": {"geom": "capsule", "mass": 70.0},
         "character": [{"name": "hero1", "position": [2.5, 4.0, 0.0]}]},
        {"name": "beam", "gltf": "box:6.0,0.4,1.0",
         "physics": {"geom": "trimesh"},
         "entity": [{"name": "beam.0", "position": [0, 2.0, 0]}]},
    ],
}
LEVEL_FRAMES = 80          # the scripted walk; control switches at 2/3
# the beam: the character's drop onto it (or past its top); the roster:
# a few frames of the 4-character batched move
VARIANT_FRAMES = {"beam": 45, "roster4": 8}
LEVEL_WALL_FRAMES = 3      # each render's wall-timed frames


def level_doc(variant="level57"):
    """The level's scene.json text: ``level57`` (demo/level57.json) or
    ``roster4`` (the level with two more characters, a roster of 4)."""
    from pathlib import Path

    level = json.loads((Path(__file__).resolve().parent / "demo"
                        / "level57.json").read_text())
    if variant == "roster4":
        level["model"][3]["character"] += [
            {"name": "hero.2", "position": [-5.0, 0.0, 0.0]},
            {"name": "hero.3", "position": [-7.5, 0.0, 0.0]}]
    return json.dumps(level)


def build_level(dev, n_envs, variant="level57"):
    """The level's game on ``dev``, ``n_envs`` envs at the loaded state:
    ``level57`` and ``roster4`` wired by the platformer demo's
    ``build_world`` (clap_tpu_torch/demo/platformer.py, as
    demo/platformer.py:46-66: the demo rig on every character, footstep
    SFX, the switch/platform rules of the level's gameplay blocks); the
    rotating ``beam`` has no gameplay blocks and no rigs: env b turns it
    by 2π·b/n_envs about y, the character above x = 2.5. Returns a dict:
    scene, load_s (the load's host seconds), gw, gs."""
    import torch

    from clap_tpu_torch.demo.platformer import build_world
    from clap_tpu_torch.device import resolve_device
    from clap_tpu_torch.engine.game import GameSessionState, GameWorld
    from clap_tpu_torch.scene import testbed as tbm
    from clap_tpu_torch.scene.assets57 import make_box_gltf
    from clap_tpu_torch.scene.loader import load_scene

    dev = resolve_device(dev)
    if variant != "beam":
        w = build_world(dev, doc=level_doc(variant))
        return dict(scene=w["scene"], load_s=w["load_s"], gw=w["gw"],
                    gs=tbm.replicate_state(w["session0"], n_envs))

    def loader(name):
        dims = [float(x) for x in name.split(":")[1].split(",")]
        return make_box_gltf(*dims).encode()

    t0 = time.perf_counter()
    scene = load_scene(json.dumps(ROTATING_BEAM), asset_loader=loader,
                       device=dev, max_entities=8, max_bodies=2)
    load_s = time.perf_counter() - t0
    gw = GameWorld(scene=scene.cfg)
    gs = tbm.replicate_state(GameSessionState(engine=scene.state0), n_envs)
    ang = torch.arange(n_envs, device=dev) * (2 * math.pi / n_envs)
    gs.engine.rot[:, 1] = torch.stack(
        [torch.zeros_like(ang), torch.sin(ang / 2),
         torch.zeros_like(ang), torch.cos(ang / 2)], -1)
    return dict(scene=scene, load_s=load_s, gw=gw, gs=gs)


def drive_level(w, frames, record=(0,), timed=False, profiled=0):
    """demo/platformer.py's scripted walk over every env: the controlled
    character walks +x (a one-hot of each env's control slot, made on the
    device), Tab at 2/3 of ``frames`` cycles control; game_step with the
    camera occlusion on. A scene without gameplay blocks (the beam) gets
    no input, as tests/test_rotating_platform.py drives it. Records envs
    ``record``'s character body positions per frame and each env's first
    frame with each switch on (-1: never), on the device. ``timed``: each frame's wall ms (host clock,
    a synchronize after it); ``profiled``: that many more frames, each
    under device_busy_ms (not in the trajectory). Returns a dict: gs,
    traj (frames, R, C, 3), latch (B, K), wall, busy."""
    import torch

    from clap_tpu_torch.engine.game import game_step
    from clap_tpu_torch.engine.step import Inputs

    gw, gs = w["gw"], w["gs"]
    dev = gs.engine.pos.device
    B, C = gs.engine.chars.state.shape
    chars = torch.arange(C, device=dev)
    body = w["scene"].cfg.char_params.body.long()
    rec = torch.as_tensor(record, device=dev)
    traj = torch.zeros(frames, len(record), C, 3, device=dev)
    has_game = gs.game is not None
    K = gs.game.switch_on.shape[1] if has_game else 0
    latch = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    frame_ids = torch.arange(frames, dtype=torch.int32, device=dev)
    tab = (torch.zeros(B, dtype=torch.bool, device=dev),
           torch.ones(B, dtype=torch.bool, device=dev))
    zero = dict(jump=torch.zeros(B, C, dtype=torch.bool, device=dev),
                cam_delta=torch.zeros(B, 3, device=dev),
                dash=torch.zeros(B, C, dtype=torch.bool, device=dev))
    switch_frame = frames * 2 // 3

    def one(gs, f):
        ctrl = gs.game.control.long()[:, None] if has_game \
            else torch.full((B, 1), -1, dtype=torch.long, device=dev)
        walk = torch.stack([(chars[None] == ctrl).float(),
                            torch.zeros(B, C, device=dev)], -1)
        return game_step(gw, gs, Inputs(motion=walk, **zero),
                         next_character=tab[f == switch_frame],
                         camera_occlusion=True)

    wall = []
    for f in range(frames):
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        gs = one(gs, f)
        if timed:
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        traj[f] = gs.engine.phys.pos[rec][:, body]
        if has_game:
            latch = torch.where((latch < 0) & gs.game.switch_on,
                                frame_ids[f], latch)
    busy = []
    for _ in range(profiled):
        out = {}

        def fn():
            out["gs"] = one(gs, frames)
        busy.append(device_busy_ms(fn))
        gs = out["gs"]
    return dict(gs=gs, traj=traj, latch=latch, wall=wall, busy=busy)


def level_renderers(scene, dev, frame_size=(640, 360), res=RES):
    """The level's renderers: its tables and texture layers from
    scene_render_setup (the crate's checker: the gather path), the
    GameFrameRenderer of one env at ``frame_size`` and the SceneRenderer
    of an env batch at ``res``². Returns (game frame renderer, batch
    renderer)."""
    from clap_tpu_torch.engine.frame import GameFrameRenderer, SceneRenderer
    from clap_tpu_torch.render.pipeline import RenderOptions
    from clap_tpu_torch.scene.content import scene_render_setup

    rt, ts = scene_render_setup(scene, device=dev)
    skip = scene.cfg.entities.skip_culling
    frame = GameFrameRenderer(rt, scene.lights,
                              RenderOptions(width=frame_size[0],
                                            height=frame_size[1],
                                            film_grain=0.0),
                              skip_culling=skip, textures=ts)
    batch = SceneRenderer(rt, scene.lights,
                          RenderOptions(width=res, height=res,
                                        shadow_size=256, film_grain=0.0),
                          skip_culling=skip, lod_scale=res / 720.0,
                          textures=ts)
    return frame, batch


def level_cpu_references(n_variant):
    """The port's CPU runs that phase 15 holds the card against, made in a
    worker process while the card runs: env 0 of the level's scripted walk
    (LEVEL_FRAMES frames) and the variants' recorded envs (the beam's env
    0 and its env turned 90 degrees of ``n_variant``, the roster's env 0).
    Returns {name: (trajectory, latch frames)} as numpy arrays."""
    import torch

    from clap_tpu_torch.bridge import tree_map

    torch.set_num_threads(2)
    d = drive_level(build_level("cpu", 1), LEVEL_FRAMES)
    out = {"level57": (d["traj"].numpy(), d["latch"].numpy())}
    for variant, rec in (("beam", (0, n_variant // 4)), ("roster4", (0,))):
        w = build_level("cpu", n_variant, variant)
        w["gs"] = tree_map(lambda x: x[list(rec)].clone(), w["gs"])
        d = drive_level(w, VARIANT_FRAMES[variant], tuple(range(len(rec))))
        out[variant] = (d["traj"].numpy(), d["latch"].numpy())
    return out


def run_level_phase(dev, smi, require, check_tile, check_depth, reps=2,
                    n_headless=N_HEADLESS, n_variant=1024, n_batch=N_SLICE,
                    frame_size=(640, 360), res=RES):
    """Phase 15: the authored level (demo/level57.json) through the port's
    loader and the level's asset pack. Headless game_step of
    demo/platformer.py's scripted walk at 4,096 envs (LEVEL_FRAMES frames,
    Tab at 2/3), held against the port's CPU run of env 0 (the same latch
    frames, positions within 1e-3), the camera bank's two slots; the
    rotating beam and a 4-character roster at 1,024 envs each, held the
    same way; then the level rendered at 1 env × 640 × 360
    (game_frame_step, GameFrameRenderer) and at 64 envs × 256²
    (step_and_render): 1 warm-up + LEVEL_WALL_FRAMES wall-timed + ``reps``
    profiled frames each, peak memory, launches counted from 0; K1 and K2
    bit-exact on each frame's own inputs, timed and bounded; the 64-env
    frame against the plain CPU path; render_frame_debug's taps on the 640 × 360
    frame. The CPU runs the card is held against are made in a worker
    process (``level_cpu_references``) while the card runs. The sizes are
    arguments, so the phase can be rehearsed small on the CPU."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        refs = pool.submit(level_cpu_references, n_variant)
        return _level_phase(dev, smi, require, check_tile, check_depth, reps,
                            n_headless, n_variant, n_batch, frame_size, res,
                            refs)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _level_phase(dev, smi, require, check_tile, check_depth, reps,
                 n_headless, n_variant, n_batch, frame_size, res, refs):
    """run_level_phase's body; ``refs``: the future of
    level_cpu_references."""
    import copy

    import torch

    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.frame import game_frame_step, step_and_render
    from clap_tpu_torch.engine.step import inputs_zero
    from clap_tpu_torch.render.passbrowser import (PASS_ORDER,
                                                   render_frame_debug)
    from clap_tpu_torch.render.pipeline import (clip_transform,
                                                gather_records,
                                                shadow_records)
    from clap_tpu_torch.render.view import cascade_subviews

    secs, clock = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        secs[name] = round(now - clock[0], 1)
        clock[0] = now

    # ------------------------------------------------------- the load
    w = build_level(dev, n_headless)
    sc = w["scene"]
    cfg = sc.cfg
    n_tris = int(cfg.world.tri_valid.shape[0])
    log(f"phase 15 level load (demo/level57.json, the port's loader and "
        f"asset pack): {w['load_s']:.3f} s on the host; "
        f"{int(cfg.entities.active.sum())} entities in "
        f"{cfg.entities.active.shape[0]} slots, "
        f"{int(cfg.bodies.active.sum())} bodies in "
        f"{cfg.bodies.active.shape[0]} slots, "
        f"{cfg.char_params.body.shape[0]} characters, {n_tris} collision "
        f"triangles, {sc.state0.cameras.pos.shape[0]} cameras ({smi})")
    require(n_tris == 84 and sc.state0.cameras.pos.shape[0] == 2,
            "level57: 84 collision triangles, 2 cameras")

    mark("load")

    # ------------------------------------------- headless at 4,096 envs
    torch.cuda.synchronize()
    d = drive_level(w, LEVEL_FRAMES, timed=True, profiled=reps)
    st = d["gs"].engine
    latch = d["latch"]
    l0 = latch[0].tolist()
    require(bool((latch == latch[0]).all()),
            "every env latches each switch on the same frame")
    t0 = time.perf_counter()
    ref = refs.result()
    wait_s = time.perf_counter() - t0
    traj, ref_latch = ref["level57"]
    err = float((d["traj"].cpu() - torch.as_tensor(traj)).abs().max())
    require(ref_latch[0].tolist() == l0,
            f"card latch frames {l0} == CPU {ref_latch[0].tolist()}")
    require(l0[0] >= 0, "switch A latches in the scripted walk")
    require(err <= 1e-3, f"env 0 on the card within 1e-3 of the CPU run "
            f"({err:.3g})")
    eyes = st.cameras.pos
    require(bool(((eyes[:, 0] - eyes[:, 1]).norm(dim=-1) > 1.0).all()),
            "the two camera slots' eyes differ")
    require(all(bool(torch.equal(a, b[:, 0]))
                for a, b in zip(st.camera, st.cameras)),
            "the active camera is slot 0")
    wall = median(d["wall"])
    log(f"phase 15 headless game_step (the scripted walk, camera "
        f"occlusion): {n_headless} envs x {LEVEL_FRAMES} frames, "
        f"{spread(d['wall'])} wall / {spread(d['busy'])} device busy per "
        f"frame, {n_headless / wall * 1e3:.0f} env-steps/s; switches latch "
        f"at frames {l0} (-1: not in the run), control to character "
        f"{int(d['gs'].game.control[0])} at frame {LEVEL_FRAMES * 2 // 3}; "
        f"env 0 vs the CPU run: same latch frames, max abs position error "
        f"{err:.3g} (the CPU runs, made meanwhile, waited for {wait_s:.1f} "
        f"s); camera slot eyes at least "
        f"{float((eyes[:, 0] - eyes[:, 1]).norm(dim=-1).min()):.2f} m apart "
        f"({smi})")
    out = dict(headless_wall=d["wall"], headless_busy=d["busy"], latch=l0,
               headless_err=err)
    gs_env0 = tree_map(lambda x: x[:1].clone(), d["gs"])
    gw = w["gw"]
    del w, d, st
    torch.cuda.empty_cache()

    mark("headless")

    # ------------------------------------------ variants at 1,024 envs
    for variant, rec in (("beam", (0, n_variant // 4)), ("roster4", (0,))):
        w = build_level(dev, n_variant, variant)
        torch.cuda.synchronize()
        frames = VARIANT_FRAMES[variant]
        d = drive_level(w, frames, rec, timed=True)
        traj, ref_latch = ref[variant]
        err = float((d["traj"].cpu() - torch.as_tensor(traj)).abs().max())
        require(err <= 1e-3, f"{variant}: the card within 1e-3 of the CPU "
                f"run ({err:.3g})")
        same = ref_latch.tolist() == d["latch"][list(rec)].cpu().tolist()
        require(same, f"{variant}: latch frames as on the CPU")
        st = d["gs"].engine
        C = st.chars.state.shape[1]
        extra = ""
        if variant == "beam":
            foot = st.phys.pos[:, 0, 1] - w["scene"].cfg.bodies.yoffset[0]
            on = foot > 2.0
            q = rec[1]
            extra = (f"; characters held by the turned beam in "
                     f"{int(on.sum())}/{on.shape[0]} envs (env 0 "
                     f"{float(foot[0]):.2f} m, env {q} (90 degrees) "
                     f"{float(foot[q]):.2f} m)")
            require(float(foot[0]) > 2.0 and float(foot[q]) < 1.9,
                    "the beam holds the character where it lies and drops "
                    "it past its top (2.2 m) where it used to lie")
        log(f"phase 15 variant {variant}: {n_variant} envs x {frames} "
            f"frames, {C} characters, {spread(d['wall'])} wall per frame, "
            f"{n_variant / median(d['wall']) * 1e3:.0f} env-steps/s; envs "
            f"{list(rec)} vs the CPU run: max abs position error "
            f"{err:.3g}{extra} ({smi})")
        out[f"{variant}_wall"] = d["wall"]
        del w, d, st
        torch.cuda.empty_cache()
        mark(variant)

    # ------------------------------------ the rendered level, 640 x 360
    fr, br = level_renderers(sc, dev, frame_size, res)
    W, H = fr.opts.width, fr.opts.height
    ins1 = tree_map(lambda x: x[None].clone(), inputs_zero(2, device=dev))
    ins1.motion[:, 0, 0] = 1.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gs = gs_env0
    calls = 0

    def frame(gs):
        nonlocal calls
        calls += 1
        return game_frame_step(gw, fr, gs, ins1)

    gs, img = frame(gs)
    walls, stds = [], []
    for _ in range(LEVEL_WALL_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs, img = frame(gs)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(img).all()), "level frame finite")
        stds.append(float(img.std()))
    busy = [device_busy_ms(lambda: frame(gs)) for _ in range(reps)]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    require(min(stds) > 0.01, f"every level frame has std > 0.01: {stds}")
    require(launches == {"raster_tile": calls, "raster_depth": calls},
            f"one K1 and one K2 launch a frame over {calls} frames: "
            f"{launches}")
    st1 = gs.engine
    view = fr.view(st1)
    geom = fr.geometry(st1, view)
    rec, binned = gather_records(fr.opts, geom, clip_transform(
        geom.verts, view, fr.proj))[:2]
    log(f"phase 15 level frame (game_frame_step, GameFrameRenderer): 1 env "
        f"x {W}x{H}, {rec.shape[-1]} records (the gather path, "
        f"{rec.shape[-2]}-column): {spread(walls)} wall / {spread(busy)} "
        f"device busy per frame (game_step + render), peak memory "
        f"{peak / 2**30:.3f} GiB, image std {min(stds):.4f}.."
        f"{max(stds):.4f}, launches in the driven run ({calls} frames) "
        f"{launches} ({smi})")
    k1 = kernel_report("phase 15", f"level frame surface {W}x{H} "
                       f"({rec.shape[-1]} records)", check_tile, rec, binned,
                       (W, H), False, smi)
    casc, _ = cascade_subviews(view, fr.proj, fr.lights.direction[0], 0.1,
                               fr.far)
    srec, sbin, dims = shadow_records(fr.opts, geom, casc.view, casc.proj)
    k2 = kernel_report("phase 15", f"level frame cascade atlas "
                       f"{dims[1]}x{dims[0]}", check_depth, srec, sbin, dims,
                       True, smi)
    dimg, taps, counts = render_frame_debug(
        fr.opts, geom, view, fr.proj, fr.lights, st1.camera.pos,
        textures=fr.textures)
    require(sorted(taps) == sorted(PASS_ORDER), f"a tap of every pass: "
            f"{sorted(taps)}")
    for name, t in taps.items():
        ok = torch.isfinite(t)
        if name == "depth":          # +inf where no surface was hit
            ok = ok | (t == math.inf)
        require(bool(ok.all()), f"tap {name} finite")
    require(bool(torch.equal(dimg, img)), "the debug run draws the frame")
    log(f"phase 15 render_frame_debug on the {W}x{H} level frame: "
        + ", ".join(f"{n} {tuple(taps[n].shape)}" for n in PASS_ORDER
                    if n in taps)
        + "; counts " + ", ".join(f"{k} {int(v[0])}"
                                  for k, v in counts.items()))
    out.update(frame_wall=walls, frame_busy=busy, frame_peak=peak,
               frame_launches=launches, k1=k1, k2=k2)
    del taps, dimg, geom, rec, srec

    mark("frame")

    # ---------------------------------- the rendered level, 64 x 256^2
    wb = build_level(dev, n_batch)
    gsb, gwb = wb["gs"], wb["gw"]
    insb = tree_map(lambda x: x.expand(n_batch, *x.shape).clone(),
                    inputs_zero(2, device=dev))
    insb.motion[:, 0, 0] = 1.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gsb, imgs = step_and_render(gwb, br, gsb, insb)
    walls = []
    for _ in range(LEVEL_WALL_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gsb, imgs = step_and_render(gwb, br, gsb, insb)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    busy = [device_busy_ms(lambda: step_and_render(gwb, br, gsb, insb))
            for _ in range(reps)]
    launches_b = read_launches()
    peak_b = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(imgs).all()), "64-env level frame finite")
    std = imgs.reshape(n_batch, -1).std(dim=1)
    require(bool((std > 0.01).all()), "per-env std > 0.01")
    require(all(v > 0 for v in launches_b.values()),
            f"K1 and K2 launched on the 64-env path: {launches_b}")
    stb = gsb.engine
    _, rec, binned, srec, sbin, dims = frame_records(br, stb)
    cpu = copy.deepcopy(br).to("cpu")
    ref = cpu(tree_map(lambda x: x[:2].cpu(), stb))
    mse = ((imgs[:2].cpu() - ref) ** 2).reshape(2, -1).mean(1)
    psnr = [10 * math.log10(1.0 / max(float(m), 1e-12)) for m in mse]
    log(f"phase 15 level batch (step_and_render, SceneRenderer): "
        f"{n_batch} envs x {res}^2, {rec.shape[-1]} records per env: "
        f"{spread(walls)} wall / {spread(busy)} device busy per frame, "
        f"{n_batch / median(walls) * 1e3:.0f} env-fps, peak memory "
        f"{peak_b / 2**30:.3f} GiB, image std min {float(std.min()):.4f}, "
        f"launches in the driven run ({1 + LEVEL_WALL_FRAMES + reps} "
        f"frames) {launches_b}; envs 0-1 vs the plain CPU path PSNR "
        f"{psnr[0]:.1f} / {psnr[1]:.1f} dB ({smi})")
    require(min(psnr) >= 35.0, "64-env level frame PSNR >= 35 dB vs CPU")
    k1b = kernel_report("phase 15", f"level batch {n_batch} envs {res}^2 "
                        f"surface", check_tile, rec, binned, (res, res),
                        False, smi)
    k2b = kernel_report("phase 15", f"level batch cascade atlas "
                        f"{dims[1]}x{dims[0]}", check_depth, srec, sbin, dims,
                        True, smi)
    out.update(batch_wall=walls, batch_busy=busy, batch_peak=peak_b,
               batch_launches=launches_b, batch_psnr=psnr, k1b=k1b, k2b=k2b)
    del wb, gsb, imgs, rec, srec, cpu, fr, br
    torch.cuda.empty_cache()
    mark("batch")
    log(f"phase 15 sub-steps, host seconds: {json.dumps(secs)} (headless: "
        f"{sum(out['headless_wall']) / 1e3:.1f} s of wall-timed frames)")
    out["seconds"] = secs
    return out


class DisplayClient:
    """One loopback WebSocket client of a DisplayServer (as
    tests/test_display.py connects one): the handshake, one key event
    sent, then a thread that reads every frame the server pushes (a
    client that stopped reading would stall the engine's sendall) and
    keeps the first PNG frame."""

    def __init__(self, host, port, key="w"):
        import socket
        import threading

        from clap_tpu_torch.utils import websocket as ws

        self.ws = ws
        self.sock = socket.create_connection((host, port), timeout=10)
        req, accept = ws.handshake_request(host, port, "/ws")
        self.sock.sendall(req)
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += self.sock.recv(4096)
        require(accept.encode() in buf, "display WebSocket handshake")
        self.rest = buf.split(b"\r\n\r\n", 1)[1]
        self.sock.sendall(ws.encode_frame(
            json.dumps({"t": "key", "key": key, "down": True}).encode(),
            ws.OP_TEXT, mask=True))
        self.frames, self.first = 0, None
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        import socket

        self.sock.settimeout(0.2)
        while not self.stop.is_set():
            try:
                data = self.sock.recv(1 << 20)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            msgs, self.rest = self.ws.decode_frames(self.rest + data)
            for op, payload in msgs:
                if op == self.ws.OP_BIN:
                    self.frames += 1
                    if self.first is None:
                        self.first = payload

    def close(self):
        self.stop.set()
        self.thread.join(timeout=5)
        self.sock.close()


def run_engine_phase(dev, smi, require, check_tile, check_depth, frames=120,
                     size=(640, 360), scene=None, n_soak=N_HEADLESS,
                     soak_frames=60, reps=5):
    """Phase 16: the engine shell (``python -m clap_tpu_torch.demo.testbed
    --render --fuzzer``): (a) ``Engine.run`` for ``frames`` frames of the
    demo's game frame at ``size`` with the fuzzer, sound, the PNG dump and
    the live display (one loopback client); a NaN written into the body
    positions before frame 59, whose step and render then run over it,
    reset by the watchdog at 60 (the run goes on from the reset); a second
    Engine with graphics only held bit-exact against ``game_frame_step``,
    timed, and its -E abort; K1 / K2 on its own frame's records; (b) the
    headless soak ``--envs``: ``fuzz_batch`` + ``engine_step`` at
    ``n_soak`` envs × ``soak_frames``, the fuzzer's draws card vs CPU,
    ``finite_mask`` and ``quarantine``; (c) the session through
    ``save_checkpoint`` / ``load_checkpoint``. Size arguments let it run
    small on the CPU."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from clap_tpu_torch.bridge import tree_leaves, tree_map
    from clap_tpu_torch.demo.testbed import build_world, soak
    from clap_tpu_torch.engine.core import (ClapConfig, Engine,
                                            graphics_renderer)
    from clap_tpu_torch.engine.frame import game_frame_step
    from clap_tpu_torch.engine.fuzzer import fuzz_draws, fuzz_inputs
    from clap_tpu_torch.engine.step import inputs_zero
    from clap_tpu_torch.scene.testbed import replicate_state
    from clap_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from clap_tpu_torch.utils.guards import finite_mask, quarantine
    from clap_tpu_torch.utils.png import decode_png

    sync = torch.cuda.synchronize
    W, H = size
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    secs = {}
    t_start = time.perf_counter()
    try:
        # ------------------------------------------ (a) Engine.run, attached
        w = build_world(dev, width=W, height=H, scene=scene, footsteps=True)
        tb = w["tb"]
        walls, marks, nan_seen, reset = [], [], [], []

        def frame_cb(eng):
            sync()                  # the frame's work done: its wall time
            marks.append(time.perf_counter())
            if eng.frame_no == NAN_AT - 1:      # frame NAN_AT steps over it
                eng.state.phys.pos[0, 0, 1] = float("nan")   # live, in place
            if eng.frame_no == NAN_AT:
                nan_seen.append(
                    not bool(torch.isfinite(eng.state.phys.pos).all())
                    and not bool(torch.isfinite(eng.last_frame).all()))

        eng = Engine(ClapConfig(title="testbed", fuzzer=True, graphics=True,
                                width=W, height=H, settings=False,
                                frame_cb=frame_cb),
                     tb.cfg, tb.state0, game_world=w["gw"],
                     session0=w["session0"], device=dev)
        eng.attach_graphics(**w["graphics"], out_dir=tmp)
        eng.attach_sound()
        disp = eng.attach_display(port=0, max_fps=0)
        client = DisplayClient(disp.host, disp.port)
        watchdog = eng._watchdog

        def watched():
            watchdog()
            if eng.frame_no == NAN_AT + 1:
                reset.append(all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(eng.session), tree_leaves(eng._session0))))

        eng._watchdog = watched
        deadline = time.monotonic() + 10
        while disp.n_clients < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        require(disp.n_clients == 1, "the display client connected")
        sync()
        reset_launches()
        marks.append(time.perf_counter())
        eng.run(max_frames=frames)
        launches = read_launches()
        walls = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        deadline = time.monotonic() + 10
        while client.first is None and time.monotonic() < deadline:
            time.sleep(0.01)
        client.close()
        key_seen = disp.record.up
        disp.close()
        secs["engine run"] = round(time.perf_counter() - t_start, 1)
        last = eng.last_frame
        luma = float(last.mean())
        require(eng.frame_no == frames, f"frame_no == {frames}")
        require(bool(torch.isfinite(last).all()), "the last frame is finite")
        require(float(last.std()) > 0.01, "the last frame has std > 0.01")
        require(0.02 < luma < 0.98, f"the last frame's mean luma {luma:.3f}")
        png = decode_png(open(f"{tmp}/frame_{frames - 1:04d}.png",
                              "rb").read())
        want = np.clip(np.rint(last.cpu().numpy() * 255), 0, 255)
        require(np.array_equal(png[..., :3], want.astype(np.uint8)),
                f"frame_{frames - 1:04d}.png decodes to the last frame")
        n_voices = len(eng.voice_log)
        n_audio = sum(len(b) for b in eng.audio_buffer)
        require(n_voices >= 1, "footsteps played")
        require(n_audio == frames * round(eng.sound.rate / 60),
                f"{n_audio} audio samples for {frames} frames")
        require(client.first is not None, "the display client got a frame")
        require(decode_png(client.first).shape[:2] == (H, W),
                "the display's PNG has the frame's size")
        require(key_seen, "the display folded the client's key event")
        require(nan_seen == [True], f"frame {NAN_AT} stepped and rendered "
                f"over the NaN state")
        require(reset == [True], f"the watchdog at {NAN_AT + 1} reset the "
                f"NaN state to the initial session")
        require(bool(torch.isfinite(eng.state.phys.pos).all()),
                f"the state is finite at frame {frames}")
        require(launches == {"raster_tile": 2 * frames,
                             "raster_depth": frames},
                f"two K1 launches a frame (surface, particles) and one K2 "
                f"(the cascades) over {frames} frames: {launches}")
        rep = eng.profiler.report()
        log(f"phase 16 engine (python -m clap_tpu_torch.demo.testbed "
            f"--render --fuzzer, sound, --dump, display): Engine.run "
            f"{frames} frames at 1 env x {W}x{H}: {spread(walls)} wall per "
            f"frame (host clock, the card synchronised in the frame "
            f"callback); {n_voices} footsteps, {n_audio} audio samples; "
            f"the display client got {client.frames} PNG frames; last frame "
            f"std {float(last.std()):.4f}, mean {luma:.4f}; launches "
            f"{launches}; frame {NAN_AT} stepped and rendered over a NaN "
            f"body position, the watchdog reset it at {NAN_AT + 1} ({smi})")
        log(f"phase 16 profiler.report() (host dispatch segments, not "
            f"device time): {json.dumps(rep)}")

        # (c) the session through a checkpoint, on the card
        path = save_checkpoint(f"{tmp}/session", eng.session)
        back = load_checkpoint(path, eng.session)
        la, lb = tree_leaves(eng.session), tree_leaves(back)
        require(len(la) == len(lb) and all(
            torch.equal(a, b) and a.device == b.device
            for a, b in zip(la, lb)), "checkpoint round trip bit-exact")
        log(f"phase 16 checkpoint: the session's {len(la)} tensors through "
            f"save_checkpoint / load_checkpoint bit-exact on {dev}")
        del eng, client, disp

        # ------------------------------- (a) graphics only vs the frame fn
        seed = 5
        ins = inputs_zero(2, device=dev)
        ins.motion[0, 0] = 1.0
        ins.motion[1, 1] = -0.6
        plain = Engine(ClapConfig(title="testbed", width=W, height=H,
                                  settings=False),
                       tb.cfg, tb.state0, argv=["-E"], game_world=w["gw"],
                       session0=w["session0"], device=dev, seed=seed)
        r = plain.attach_graphics(**w["graphics"])
        ref_r = graphics_renderer(tb.state0.mx, **w["graphics"])
        gs = replicate_state(w["session0"], 1)
        gen = torch.Generator(device=dev).manual_seed(seed)
        bins = tree_map(lambda x: x[None], ins)
        for _ in range(3):
            plain.frame(ins)
            gs, img = game_frame_step(w["gw"], ref_r, gs, bins, generator=gen)
        la, lb = tree_leaves(plain.session), tree_leaves(gs)
        same = len(la) == len(lb) and all(torch.equal(a, b)
                                          for a, b in zip(la, lb))
        require(same and torch.equal(plain.last_frame, img[0]),
                "3 frames of the graphics Engine equal game_frame_step's "
                "bit for bit")
        wall = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            plain.frame(ins)
            sync()
            wall.append((time.perf_counter() - t0) * 1e3)
        busy, ops = zip(*[device_busy_ops(lambda: plain.frame(ins))
                          for _ in range(3)])
        gwall = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            gs, img = game_frame_step(w["gw"], ref_r, gs, bins, generator=gen)
            sync()
            gwall.append((time.perf_counter() - t0) * 1e3)
        gbusy, gops = zip(*[device_busy_ops(
            lambda: game_frame_step(w["gw"], ref_r, gs, bins, generator=gen))
            for _ in range(3)])
        reset_launches()
        plain.frame(ins)
        per_frame = read_launches()
        require(per_frame == {"raster_tile": 2, "raster_depth": 1},
                f"the Engine's frame launches K1 twice and K2 once: "
                f"{per_frame}")
        log(f"phase 16 engine with graphics only (1 env x {W}x{H}, no "
            f"fuzzer): equals game_frame_step bit for bit over 3 frames; "
            f"{spread(wall)} wall / {spread(list(busy))} device busy per "
            f"frame, {median(list(ops))} device ops a frame (kernels, "
            f"copies, fills); game_frame_step alone {spread(gwall)} wall / "
            f"{spread(list(gbusy))} device busy, {median(list(gops))} ops "
            f"({smi})")
        st, parts, jm = plain.state, plain.session.particles, \
            plain.session.joint_mats
        kp, k1, k2 = game_frame_kernels("phase 16", "engine frame", r, st,
                                        parts, jm, check_tile, check_depth,
                                        smi)
        # the NaN goes in before the frame: its step and render run over it
        plain.frame_no = NAN_AT
        plain.state.phys.pos[0, 0, 1] = float("nan")
        try:
            plain.frame(ins)
            aborted = False
        except FloatingPointError:
            aborted = True
        require(aborted, "-E: the watchdog raises FloatingPointError")
        log("phase 16 -E: a NaN in the body positions raises "
            "FloatingPointError at the next watchdog tick")
        secs["engine plain"] = round(time.perf_counter() - t_start
                                     - sum(secs.values()), 1)
        del plain, r, ref_r, gs, img, w
        torch.cuda.empty_cache()

        # --------------------------------------------- (b) headless soak
        hw = build_world(dev, render=False, scene=scene)
        soak(hw, n_soak, 2, dev)                              # warm-up
        sts, rate = soak(hw, n_soak, soak_frames, dev)
        envs = torch.tensor([0, n_soak - 1])
        for f in range(soak_frames):
            a = fuzz_draws(0, f, envs.to(dev), 1, dev)
            b = fuzz_draws(0, f, envs, 1, "cpu")
            require(torch.equal(a.cpu(), b), f"fuzzer draws frame {f} card "
                    f"== CPU bit for bit")
            ia = fuzz_inputs(0, f, env=envs.to(dev), device=dev)
            ib = fuzz_inputs(0, f, env=envs, device="cpu")
            err = max(float((x.cpu() - y).abs().max())
                      for x, y in zip((ia.motion, ia.cam_delta),
                                      (ib.motion, ib.cam_delta)))
            require(err <= 1e-6 and torch.equal(ia.jump.cpu(), ib.jump),
                    f"fuzzer inputs frame {f} card vs CPU within 1e-6 "
                    f"({err:.3g})")
        require(bool(finite_mask(sts).all()), "finite_mask all true")
        require(bool((sts.frame == soak_frames).all()), "soak frame counter")
        sts.phys.pos[7, 0, 1] = float("nan")
        fixed, ok = quarantine(sts, hw["tb"].state0)
        keep = torch.arange(n_soak, device=dev) != 7
        la, lb = tree_leaves(sts), tree_leaves(fixed)
        l0 = tree_leaves(hw["tb"].state0)
        require(not bool(ok[7]) and bool(ok[keep].all()),
                "quarantine flags env 7 alone")
        require(all(torch.equal(x[keep], y[keep]) for x, y in zip(la, lb)),
                f"quarantine leaves the other {n_soak - 1} envs "
                f"bit-identical")
        require(all(torch.equal(y[7], z) for y, z in zip(lb, l0)),
                "quarantine resets env 7 to the initial state")
        log(f"phase 16 soak (--envs {n_soak}): fuzz_batch + engine_step, "
            f"{n_soak} envs x {soak_frames} frames: {rate:.0f} env-steps/s "
            f"(host clock, the card synchronised at both ends); the "
            f"fuzzer's draws of envs 0 and {n_soak - 1}, frames 0-"
            f"{soak_frames - 1}, card == CPU bit for bit, inputs within "
            f"1e-6; finite_mask all true; a NaN in env 7 quarantined, the "
            f"other envs bit-identical ({smi})")
        secs["soak"] = round(time.perf_counter() - t_start
                             - sum(secs.values()), 1)
        log(f"phase 16 sub-steps, host seconds: {json.dumps(secs)}")
        del sts, fixed, hw
        torch.cuda.empty_cache()
        return dict(launches=launches, per_frame=per_frame, wall=walls,
                    plain_wall=wall, plain_busy=list(busy),
                    plain_ops=list(ops), game_wall=gwall,
                    game_busy=list(gbusy), rate=rate, k1=k1, particles=kp,
                    k2=k2, report=rep)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 17: the records that drive the overlay, one pair per frame (the
# menu's, the debug panel's): the menu goes down into SETTINGS and its
# nested GRAPHICS, fires SHADOWS and backs out to its root; the panel
# opens, climbs (wrapping) from its first row to the frame module's
# Adjustable, nudges it up and folds the physics module
OVERLAY_INPUTS = (
    (dict(down=True), dict(menu_toggle=True)),
    (dict(enter=True), dict(up=True)),
    (dict(down=True), dict(up=True)),
    (dict(up=True), dict(up=True)),
    (dict(enter=True), dict(up=True)),
    (dict(enter=True), dict(right=True)),
    (dict(menu_toggle=True), dict(down=True)),
    (dict(menu_toggle=True), dict(enter=True)),
)
PLATFORMER_FRAMES = (120, 80)     # phase 17 (d): frames, the Tab's frame


def overlay_ui(eng, font=None):
    """The UI a caller lays over an Engine's frame (the port's render/ui,
    ui_anim and debugui): an ``osd`` line, a ``Menu`` of nested items, an
    ``InteractiveDebugUI`` with ``standard_modules(eng)`` (every module
    enabled) and one ``Adjustable``, and a toast that a ``UiAnimator``
    slides in. Returns a dict of them and ``fired`` (the menu leaves that
    fired)."""
    from clap_tpu_torch.render.debugui import (Adjustable,
                                               InteractiveDebugUI,
                                               standard_modules)
    from clap_tpu_torch.render.ui import AF, Menu, MenuItem, UiElement, osd
    from clap_tpu_torch.render.ui_anim import UiAnimator

    W, H = eng.renderer.opts.width, eng.renderer.opts.height
    fired = []

    def leaf(menu, item):
        fired.append(item.name)

    menu = Menu([MenuItem("RESUME", fn=leaf),
                 MenuItem("SETTINGS", items=[
                     MenuItem("GRAPHICS", items=[
                         MenuItem("SHADOWS", fn=leaf),
                         MenuItem("GRAIN", fn=leaf)]),
                     MenuItem("AUDIO", fn=leaf)]),
                 MenuItem("QUIT", fn=leaf)], W, H, font=font)
    dui = InteractiveDebugUI(width=W, height=H, font=font)
    standard_modules(dui, eng)
    for name in dui.modules:
        dui.toggle(name, True)
    tweak = {"exposure": 1.0}
    dui.register_adjustable("frame", "exposure", Adjustable(
        get=lambda: tweak["exposure"],
        set=lambda v: tweak.__setitem__("exposure", v), step=0.25))
    toast = UiElement(text="CHECKPOINT SAVED", text_scale=2, font=font,
                      affinity=AF.RIGHT | AF.BOTTOM, x=16.0, y=-60.0,
                      color=(0.1, 0.3, 0.1, 0.7))
    anim = UiAnimator()
    anim.slide_in(toast, -60.0, 16.0, duration=0.1)
    return dict(menu=menu, dui=dui, hud=osd("CLAP-TPU TESTBED  ESC: MENU",
                                            font=font),
                toast=toast, anim=anim, fired=fired, tweak=tweak)


def overlay_boxes(eng):
    """The bodies the overlay boxes (each active slot, read once: a host
    fact of the scene), their half extents (the capsule's, y the long
    axis; on the device) and the characters' body slots."""
    import torch

    b = eng.scene_cfg.bodies
    active = [i for i, a in enumerate(b.active.tolist()) if a]
    ext = torch.stack([b.radius, b.half_len + b.radius, b.radius], -1)
    return dict(bodies=active, ext=ext, chars=eng.scene_cfg.host.char_body)


def overlay_layout(ui, eng, f, boxes):
    """Frame ``f``'s overlay on the host, as a caller makes it: route the
    frame's records to the menu and the debug panel, step the animation,
    lay out the quads (osd and toast, menu, panel column); build the debug
    lines of the Engine's state on its device (an AABB per body, a cross
    at each character). Returns (quads, lines, view (4, 4), proj)."""
    from clap_tpu_torch.engine.input import InputRecord
    from clap_tpu_torch.render.debug_draw import (add_aabb, add_cross,
                                                  lines_empty)
    from clap_tpu_torch.render.ui import ui_layout

    W, H = eng.renderer.opts.width, eng.renderer.opts.height
    rm, rd = OVERLAY_INPUTS[f % len(OVERLAY_INPUTS)]
    ui["menu"].handle_input(InputRecord(**rm))
    ui["dui"].handle_input(InputRecord(**rd))
    ui["anim"].step(1 / 60)
    quads = ui_layout([ui["hud"], ui["toast"]], W, H) + ui["menu"].quads \
        + ui_layout(ui["dui"].build_elements(), W, H)
    pos = eng.state.phys.pos[0]
    dev = pos.device
    dl, idx = lines_empty(device=dev), 0
    for i in boxes["bodies"]:
        dl, idx = add_aabb(dl, idx, pos[i] - boxes["ext"][i],
                           pos[i] + boxes["ext"][i])
    for i in boxes["chars"]:
        dl, idx = add_cross(dl, idx, pos[i], 0.4)
    return quads, dl, eng.renderer.view(eng.state)[0], eng.renderer.proj


def overlay(frame, quads, lines, view, proj):
    """The composite of one frame (H, W, 3): the UI quads, then the debug
    lines."""
    from clap_tpu_torch.render.debug_draw import draw_lines
    from clap_tpu_torch.render.ui import ui_compose

    return draw_lines(ui_compose(frame, quads), lines, view, proj)


def quad_mask(quads, H, W, dev):
    """(H, W) bool: the pixels the quads may draw, each clipped rectangle
    and its text's (ui_compose places the text 4 px in from the clipped
    corner, so on a quad cut by the frame's edge it can reach past the
    quad)."""
    import torch

    m = torch.zeros(H, W, dtype=torch.bool, device=dev)
    for q in quads:
        x0, y0, x1, y1 = max(q.x0, 0), max(q.y0, 0), min(q.x1, W), \
            min(q.y1, H)
        if x1 <= x0 or y1 <= y0:
            continue
        m[y0:y1, x0:x1] = True
        if q.text_bitmap is not None:
            th, tw = q.text_bitmap.shape
            m[y0 + 4:y0 + 4 + th, x0 + 4:x0 + 4 + tw] = True
    return m


def to_device(tree, dev):
    """A tree (dicts and NamedTuples) with its tensors on ``dev``."""
    import torch

    from clap_tpu_torch.bridge import tree_map

    return tree_map(lambda x: x.to(dev) if torch.is_tensor(x) else x, tree)


def run_overlay_phase(dev, smi, require, check_tile, check_depth,
                      size=(640, 360), scene=None, frames=8, fly_args=(),
                      plat=PLATFORMER_FRAMES, reps=3):
    """Phase 17: the UI layer, the debug overlay, the pass browser and the
    two other demos on the card. (a) Over ``frames`` frames of the
    Engine's testbed frame (``build_world``, graphics only, 1 env at
    ``size``) a caller's overlay (``overlay_ui`` / ``overlay_layout``):
    pixels change only inside the quads and on the line pixels, the card's
    composite equals the CPU composite bit for bit, no host sync in it
    (sync-debug "error"), ms per composite beside the frame's; (b)
    ``render_frame_debug`` → ``compose_pass_browser`` of the last frame;
    (c) ``python -m clap_tpu_torch.demo.flythrough`` (``fly_args`` added to
    its defaults) with K1/K2 on its last frame's records, each frame
    checked, the last against the CPU path; (d) the platformer's ``run``
    of ``plat`` (frames, Tab frame) against the port's CPU run, made after
    the card's timed run, so no CPU job runs beside a timed window. Size
    arguments let it run small on the CPU."""
    import shutil
    import tempfile

    import torch

    from clap_tpu_torch.demo import flythrough as F
    from clap_tpu_torch.demo import platformer as P
    from clap_tpu_torch.demo.testbed import build_world
    from clap_tpu_torch.engine.core import ClapConfig, Engine
    from clap_tpu_torch.render.debug_draw import draw_lines
    from clap_tpu_torch.render.font import load_font
    from clap_tpu_torch.render.passbrowser import (compose_pass_browser,
                                                   render_frame_debug)
    from clap_tpu_torch.render.pipeline import (clip_transform,
                                                gather_records,
                                                shadow_records)
    from clap_tpu_torch.render.ui import ui_compose
    from clap_tpu_torch.render.view import cascade_subviews

    sync = torch.cuda.synchronize
    W, H = size
    secs = {}
    t_start = time.perf_counter()

    def lap(name):
        secs[name] = round(time.perf_counter() - t_start
                           - sum(secs.values()), 1)

    # ------------------------------------- (a) the overlay over the frame
    font = load_font(14)
    font_name = "GlyphAtlas at size 14" if font is not None \
        else "5x7 (no PIL or face)"
    w = build_world(dev, width=W, height=H, scene=scene)
    tb = w["tb"]
    eng = Engine(ClapConfig(title="testbed", graphics=True, width=W,
                            height=H, settings=False),
                 tb.cfg, tb.state0, game_world=w["gw"],
                 session0=w["session0"], device=dev)
    eng.attach_graphics(**w["graphics"])
    ui = overlay_ui(eng, font)
    boxes = overlay_boxes(eng)
    reset_launches()
    fwall, cwall, worst, n_quad_px, n_line_px = [], [], 0.0, 0, 0
    for f in range(frames):
        sync()
        t0 = time.perf_counter()
        eng.frame()
        sync()
        fwall.append((time.perf_counter() - t0) * 1e3)
        frame = eng.last_frame
        quads, dl, view, proj = overlay_layout(ui, eng, f, boxes)
        sync()
        t0 = time.perf_counter()
        out = overlay(frame, quads, dl, view, proj)
        sync()
        cwall.append((time.perf_counter() - t0) * 1e3)
        ui_out = ui_compose(frame, quads)
        in_quads = quad_mask(quads, H, W, frame.device)
        on_lines = torch.isfinite(draw_lines(
            torch.full_like(frame, float("nan")), dl, view, proj)).all(-1)
        ui_px = (ui_out != frame).any(-1)
        line_px = (out != ui_out).any(-1)
        require(not bool((ui_px & ~in_quads).any()),
                f"overlay frame {f}: the UI changes pixels only inside its "
                f"quads")
        require(not bool((line_px & ~on_lines).any()),
                f"overlay frame {f}: the lines change only line pixels")
        n_quad_px = max(n_quad_px, int(ui_px.sum()))
        n_line_px = max(n_line_px, int(line_px.sum()))
        cpu = overlay(frame.cpu(), quads, to_device(dl, "cpu"), view.cpu(),
                      proj.cpu())
        worst = max(worst, float((out.cpu() - cpu).abs().max()))
        require(torch.equal(out.cpu(), cpu),
                f"overlay frame {f}: the card's composite equals the CPU's "
                f"bit for bit (max diff {worst:.3g})")
    launches = read_launches()
    okp, ok1, ok2 = game_frame_kernels(
        "phase 17", "overlay frame", eng.renderer, eng.state,
        eng.session.particles, eng.session.joint_mats, check_tile,
        check_depth, smi)
    require(n_quad_px > 0 and n_line_px > 0,
            f"the UI ({n_quad_px} px) and the lines ({n_line_px} px) draw")
    require(all(v > 0 for v in launches.values()),
            f"K1 and K2 launched under the overlay: {launches}")
    require(ui["fired"] == ["SHADOWS"] and len(ui["menu"].stack) == 1
            and ui["tweak"]["exposure"] == 1.25
            and not ui["dui"].modules["physics"].unfolded,
            f"the menu fired {ui['fired']} and is back at its root, the "
            f"panel set {ui['tweak']} and folded the physics module")
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        overlay(frame, quads, dl, view, proj)
        sync_free = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cbusy = [device_busy_ms(lambda: overlay(frame, quads, dl, view, proj))
             for _ in range(reps)]
    fbusy = [device_busy_ms(eng.frame) for _ in range(reps)]
    log(f"phase 17 overlay over the Engine's frame (1 env x {W}x{H}, "
        f"{frames} frames): {len(quads)} quads (osd, toast, "
        f"{len(ui['menu'].items)} menu items, the debug column), "
        f"{len(boxes['bodies'])} AABBs and "
        f"{len(boxes['chars'])} crosses; font {font_name}; composite "
        f"(ui_compose + draw_lines) {spread(cwall)} wall / {spread(cbusy)} "
        f"device busy; the frame itself {spread(fwall)} wall / "
        f"{spread(fbusy)} device busy; pixels change only in the quads "
        f"(up to {n_quad_px}) and on the lines (up to {n_line_px}); card "
        f"== CPU bit for bit (max diff {worst:.3g}); no host sync in the "
        f"composite: {sync_free}; menu leaves fired {ui['fired']}; "
        f"launches {launches} ({smi})")
    lap("overlay")

    # ------------------------------------------- (b) the pass browser
    r, st = eng.renderer, eng.state
    parts, jm = eng.session.particles, eng.session.joint_mats
    sync()
    t0 = time.perf_counter()
    view = r.view(st)
    img, taps, counts = render_frame_debug(
        r.opts, r.geometry(st, view, jm), view, r.proj, r.lights,
        st.camera.pos, far=r.far, static_shadow=r.static_shadow,
        textures=r.textures, grain_noise=r.grain_noise,
        particles=r.particle_args(parts))
    sync()
    t_debug = time.perf_counter() - t0
    t0 = time.perf_counter()
    pic = compose_pass_browser({k: v[0] for k, v in taps.items()},
                               {k: v[0] for k, v in counts.items()},
                               font=font)
    t_pic = time.perf_counter() - t0
    rows = -(-len(taps) // 4)
    require(pic.shape == (rows * 108 + 4 + 18, 500, 3),
            f"pass browser picture shape {pic.shape}")
    require(bool(torch.isfinite(torch.from_numpy(pic)).all()),
            "pass browser picture finite")
    cells = [float(pic[4 + 14 + 108 * (i // 4):4 + 14 + 108 * (i // 4) + 90,
                       4 + 124 * (i % 4):4 + 124 * (i % 4) + 120].std())
             for i in range(len(taps))]
    means = [round(float(pic[4 + 14 + 108 * (i // 4):4 + 14 + 108 * (i // 4)
                             + 90, 4 + 124 * (i % 4):
                             4 + 124 * (i % 4) + 120].mean()), 4)
             for i in range(len(taps))]
    require(len(set(means)) == len(taps),
            f"the {len(taps)} thumbnails differ from one another: {means}")
    require(torch.equal(img, r(st, parts, None, jm)),
            "render_frame_debug draws the Engine's frame")
    log(f"phase 17 pass browser (render_frame_debug -> compose_pass_browser,"
        f" 120x90 thumbnails and the counts line): {len(taps)} passes "
        f"{sorted(taps)}, picture {pic.shape[1]}x{pic.shape[0]}, finite, "
        f"thumbnail std {min(cells):.4f}..{max(cells):.4f}; counts "
        f"{ {k: int(v[0]) for k, v in counts.items()} }; font {font_name}; "
        f"render_frame_debug {t_debug * 1e3:.1f} ms, compose (host numpy, "
        f"labels through ui_compose on the CPU) {t_pic * 1e3:.1f} ms "
        f"({smi})")
    del taps, img
    lap("pass_browser")

    # -------------------------------------------------- (c) the flythrough
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fly_")
    try:
        reset_launches()
        t0 = time.perf_counter()
        fw, imgs = F.main(["--out", tmp, *fly_args])
        sync()
        t_fly = time.perf_counter() - t0
        fly_launches = read_launches()
        n_png = len([x for x in os.listdir(tmp) if x.endswith(".png")])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    nf = len(imgs)
    n_sim = int(fly_args[fly_args.index("--sim-frames") + 1]) \
        if "--sim-frames" in fly_args else 20
    fo = fw["opts"]
    require(n_png == nf and fly_launches == {"raster_tile": nf,
                                             "raster_depth": nf},
            f"flythrough: {nf} PNGs ({n_png}) and one K1 and one K2 per "
            f"frame: {fly_launches}")
    stds = []
    for i, im in enumerate(imgs):
        require(bool(torch.isfinite(im).all()), f"flythrough frame {i} "
                f"finite")
        stds.append(float(im.std()))
        require(stds[-1] > 0.01, f"flythrough frame {i} std > 0.01")
        if i:
            require(float((im - imgs[i - 1]).abs().max()) > 1e-3,
                    f"flythrough frame {i} differs from frame {i - 1}")
    fst = fw["st"]
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        fst = F.sim_step(fw, fst)
    sync()
    sim_ms = (time.perf_counter() - t0) * 100.0
    sim_busy = device_busy_ms(lambda: F.sim_step(fw, fst))
    yaw = 2 * math.pi * (nf - 1) / nf
    rwall, rbusy = frame_times(lambda: F.render(fw, fw["st"], yaw), reps)
    view, proj, eye = F.camera(fw, fw["st"], yaw)
    geom = F.geometry(fw, fw["st"], view, proj, eye)
    rec, binned = gather_records(fo, geom, clip_transform(
        geom.verts, view, proj))[:2]
    k1 = kernel_report("phase 17", f"flythrough surface {fo.width}x"
                       f"{fo.height} ({rec.shape[-1]} records)", check_tile,
                       rec, binned, (fo.width, fo.height), False, smi)
    casc, _ = cascade_subviews(view, proj, fw["lights"].direction[0], 0.1,
                               200.0)
    srec, sbin, dims = shadow_records(fo, geom, casc.view, casc.proj)
    k2 = kernel_report("phase 17", f"flythrough cascade atlas {dims[1]}x"
                       f"{dims[0]}", check_depth, srec, sbin, dims, True,
                       smi)
    cw = to_device(fw, "cpu")
    ref = F.render(cw, cw["st"], yaw)[0]
    mse = float(((imgs[-1].cpu() - ref) ** 2).mean())
    fly_psnr = 10 * math.log10(1.0 / max(mse, 1e-12))
    require(fly_psnr >= 35.0, "flythrough frame PSNR >= 35 dB vs the CPU")
    log(f"phase 17 flythrough (python -m clap_tpu_torch.demo.flythrough "
        f"{' '.join(fly_args) or 'at its defaults'}): {nf} frames x "
        f"{n_sim} sim frames at "
        f"{fo.width}x{fo.height} in {t_fly:.1f} s, every frame finite (std "
        f"{min(stds):.4f}..{max(stds):.4f}) and unlike the one before; "
        f"{sim_ms:.2f} ms wall / {sim_busy:.2f} ms device busy per sim "
        f"frame, the render {spread(rwall)} wall / {spread(rbusy)} device "
        f"busy; launches {fly_launches}; the last frame vs the port's CPU "
        f"path PSNR {fly_psnr:.1f} dB ({smi})")
    del fw, cw, imgs, rec, srec
    lap("flythrough")

    # --------------------------------------------------- (d) the platformer
    n_plat, sw = plat
    pw = P.build_world(dev)
    sync()
    t0 = time.perf_counter()
    got = P.run(pw, n_plat, sw)
    sync()
    plat_ms = (time.perf_counter() - t0) * 1e3 / n_plat
    t0 = time.perf_counter()
    ref = P.run(P.build_world("cpu"), n_plat, sw)
    ref_s = time.perf_counter() - t0
    perr = float((got["traj"].cpu() - ref["traj"]).abs().max())
    require(got["events"] == ref["events"],
            f"platformer events card == CPU: {got['events']} vs "
            f"{ref['events']}")
    require(got["control"] == ref["control"], "platformer control frames")
    require(perr <= 1e-3, f"platformer positions within 1e-3 ({perr:.3g})")
    require(got["footsteps"] == ref["footsteps"],
            "platformer footstep log card == CPU")
    log(f"phase 17 platformer (clap_tpu_torch.demo.platformer run, "
        f"{n_plat} frames, Tab at {sw}): {plat_ms:.1f} ms/frame (host-"
        f"paced, a host read of the control slot, the footsteps and the "
        f"switches each frame), so the demo's 900 default frames take about"
        f" {plat_ms * 0.9:.0f} s; events {got['events']}; "
        f"{len(got['footsteps'])} footsteps; against the port's CPU run: "
        f"the same events, control frames and footstep log, positions "
        f"within {perr:.3g}; the CPU run {ref_s:.1f} s, after the card's "
        f"({smi})")
    lap("platformer")
    log(f"phase 17 sub-steps, host seconds: {json.dumps(secs)}")
    del eng, w, pw, got
    torch.cuda.empty_cache()
    return dict(launches=launches, composite_wall=cwall,
                composite_busy=cbusy, frame_wall=fwall, frame_busy=fbusy,
                fly_launches=fly_launches, k1=k1, k2=k2, overlay_k1=ok1,
                overlay_particles=okp, overlay_k2=ok2, plat_ms=plat_ms)


def bake_records(rt, tb, lights):
    """The 1024² static shadow bake's records and bins: (rec, binned, (w,
    h, th, tw))."""
    from clap_tpu_torch.render.pipeline import RenderOptions, shadow_records
    from clap_tpu_torch.render.scenerender import static_shadow_geometry

    g, sv, _ = static_shadow_geometry(rt, tb.state0.mx, lights.direction[0])
    return shadow_records(RenderOptions(shadow_size=1024), g, sv.view[None],
                          sv.proj[None])


def walk_bound(R, plain, args, ncoef, planes, win_flop):
    """The least time of a K1 / K2 launch on ``args``, from the plain
    version's walk, instrumented, counting what these inputs need: the
    records each list walks up to its early-out. Bytes: the counts, the
    cluster ids walked (of the tiles' lists and of each env's big list),
    each distinct (env, cluster) row among the walked records read once (a
    cluster binned into several sub-tiles is counted once), and the output
    planes written once, at 3.35 TB/s. Flops: 16 per covered pixel-record
    pair (edges >= 0 and z in [-1, 1], the pairs any correct walk must
    depth-test) and ``win_flop`` per win, at 67 TFLOP/s (float32 outside
    the tensor cores). Also counts the brute-force tests (every pixel x
    every record walked) and the tests the kernel makes after its per-warp
    reject (``_warp_keep_ref``). Returns (ms, "bytes" | "operations",
    counts)."""
    import torch

    walk, gather = R._walk_ref, R._gather_lists
    crec, tile_list, big_idx, counts = args[:4]
    sub, cluster = args[8], args[10]
    Tc = crec.shape[1]
    n = {"records": 0, "tests": 0, "wins": 0, "covered": 0, "kept": 0,
         "warp_records": 0, "kernel_tests": 0}
    rows_seen = []                       # env * Tc + cluster id, per row

    def gather_tagged(crec, tile_list, big_idx, counts, nc):
        """The plain gather, each record carrying its env and cluster id
        in two trailing columns (exact in float32: ids < 2^24)."""
        trec, brec = gather(crec, tile_list, big_idx, counts, nc)
        B = crec.shape[0]
        env = torch.arange(B, device=crec.device, dtype=torch.float32)

        def tag(rec, ids):
            ids = ids.long().repeat_interleave(cluster, -1).reshape(
                rec.shape[:-1]).float()
            e = env.reshape((B,) + (1,) * (ids.dim() - 1)).expand_as(ids)
            return torch.cat([rec, e[..., None], ids[..., None]], -1)
        return (tag(trec, tile_list.reshape(B, trec.shape[1], -1)),
                tag(brec, big_idx))

    def counted(*a):
        step = a[-1]

        def step_counted(slab, nv, px, py, carry):
            slab, tags = slab[..., :ncoef], slab[..., ncoef:]
            new = step(slab, nv, px, py, carry)
            live = torch.arange(slab.shape[1], device=slab.device)[None] \
                < nv[:, None]
            rows = int(live.sum())
            rows_seen.append((tags[..., 0] * Tc + tags[..., 1])[live].long())
            n["records"] += rows
            n["tests"] += rows * px.shape[1] * px.shape[2]
            n["wins"] += int((new[0] < carry[0]).sum())
            n["covered"] += int(torch.isfinite(
                R._covered_z(slab, nv, px, py)).sum())
            keep = R._warp_keep_ref(slab, nv, px, py, carry[0])
            n["kept"] += int(keep.sum())
            n["warp_records"] += rows * keep.shape[-1]
            n["kernel_tests"] += int(keep.sum()) * 32 * (px.shape[1] // 2)
            return new
        return walk(*a[:-1], step_counted)

    R._walk_ref, R._gather_lists = counted, gather_tagged
    try:
        out = plain(*args)
    finally:
        R._walk_ref, R._gather_lists = walk, gather
    big = counts[..., sub]                       # per env and tile
    n["big"] = int(big[:, 0].sum())              # each env's list, once
    n["small"] = n["records"] - int(big.sum()) * sub
    n["unique"] = cluster * int(torch.unique(torch.cat(rows_seen)).numel()) \
        if rows_seen else 0             # records of the distinct rows
    hw = (out[0] if isinstance(out, tuple) else out).numel()
    n["bytes"] = counts.numel() * 4 + (n["small"] + n["big"]) // cluster \
        * 4 + n["unique"] * ncoef * 4 + planes * hw * 4
    n["flops"] = 16 * n["covered"] + win_flop * n["wins"]
    t_bytes, t_ops = n["bytes"] / 3.35e12 * 1e3, n["flops"] / 67e12 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations"), n


def run_ca_phase(dev, smi, require):
    """Phase 6: K3 against its plain version on every route (5 rules × 4
    shapes, 512² and 1,024² over a cluster, every schedulable cluster
    size, 2,048² on the device-memory route), the CA path driven and timed
    beside its bound, and cave_scene on the card vs the CPU."""
    import ctypes

    import torch

    from clap_tpu_torch.cuda_build import load_lib
    from clap_tpu_torch.ops import ca2d as CA
    from clap_tpu_torch.scene.voxel import cave_scene

    sync = torch.cuda.synchronize
    limit, cap, sms = CA.ca2d_card(dev)
    lib = load_lib("ca2d")
    act = {cs: lib.ca2d_active_clusters(0, cs, limit)
           for cs in (1, 2, 4, 8, 16)}
    log(f"phase 6 card: {limit} B shared memory per block, {sms} SMs; "
        f"largest cluster the card schedules {cap}; max active clusters "
        f"per size at {limit} B per CTA {act}")
    vn1 = CA.CARule("vn1 test", born_mask=0b0110, surv_mask=0b1100,
                    nr_states=3, decay=True, neigh="vn1")
    vnv = CA.CARule("vnv test", born_mask=0b0011, surv_mask=0b0101,
                    nr_states=7, decay=True, neigh="vnv")
    rules = (CA.CA_TEST, CA.CA_COOL_TREE, CA.CA_ASH_PINUS, vn1, vnv)
    gen = torch.Generator(device=dev).manual_seed(6)
    max_err = 0

    def check(name, shape, steps, plan=None):
        """Every rule on one shape: bit-exact, one line with the route."""
        nonlocal max_err
        exact = []
        for rule in rules:
            g = torch.randint(0, rule.nr_states + 1, shape, generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
            before = CA.ca2d_run_fused.launches
            k = CA.ca2d_run_fused(rule, g, steps, plan)
            sync()
            per_call = CA.ca2d_run_fused.launches - before
            r = CA.ca2d_run(rule, g, steps)
            max_err = max(max_err, int((k.int() - r.int()).abs().max()))
            exact.append(bool(torch.equal(k, r)))
        p = plan or CA.ca2d_plan(*shape, limit, cap, sms)
        log(f"phase 6 parity {name} {'x'.join(map(str, shape))} x {steps}: "
            f"{p.route} route, cluster {p.cluster}, {per_call} launch(es) "
            f"per call; K3 bit-exact against ca2d_run for "
            f"{[r.neigh for r in rules]}: {exact}")
        require(all(exact), f"K3 bit-exact on {name} {shape}")

    for shape, steps in (((1, 64, 64), 32), ((3, 96, 160), 17),
                         ((2, 37, 53), 9), ((1, 256, 256), 1000)):
        check("shape", shape, steps)
    for side, steps in ((512, 20), (1024, 5)):
        p = CA.ca2d_plan(1, side, side, limit, cap, sms)
        require(p.route == "cluster" and p.cluster > 1,
                f"{side}^2 splits over a cluster")
        check("past one block", (1, side, side), steps)
    for cs in (1, 2, 4, 8, 16):
        if cs <= cap:
            check(f"cluster {cs} forced", (1, 256, 256), 64, CA.ca2d_plan(
                1, 256, 256, limit, cap, sms, cluster=cs))
    check("in place", (132, 37, 53), 9)
    require(CA.ca2d_plan(1, 2048, 2048, limit, cap, sms).route == "global",
            "2048^2 takes the device-memory route")
    check("past the largest cluster", (1, 2048, 2048), 5)

    # the driven CA path: counts start here
    CA.ca2d_run_fused.launches = 0
    g1 = CA.ca2d_seed(CA.CA_TEST, (256, 256), generator=gen, device=dev)
    out1 = CA.ca2d_run_fused(CA.CA_TEST, g1, 1000)          # config #1
    gb = CA.ca2d_seed(CA.CA_TEST, (1024, 256, 256), generator=gen,
                      device=dev)
    outb = CA.ca2d_run_fused(CA.CA_TEST, gb, 100)
    sync()
    launches = CA.ca2d_run_fused.launches
    require(launches > 0, "K3 launched on the CA path")
    require(torch.equal(out1, CA.ca2d_run(CA.CA_TEST, g1, 1000)),
            "config #1 grid equals the plain version")
    require(torch.equal(outb[:4], CA.ca2d_run(CA.CA_TEST, gb[:4], 100)),
            "batched grids equal the plain version")
    live = float((outb != 0).float().mean())
    require(0.0 < live < 1.0, "the batched grids stay alive and not full")
    p1 = CA.ca2d_plan(1, 256, 256, limit, cap, sms)
    pb = CA.ca2d_plan(1024, 256, 256, limit, cap, sms)
    log(f"phase 6 CA path: config #1 on the {p1.route} route, cluster "
        f"{p1.cluster}, bands of {p1.bands[0]} rows; the batch on the "
        f"{pb.route} route, cluster {pb.cluster}; launches in the driven "
        f"run: ca2d_run_fused {launches}")

    # bounds: the input read and the output written once at 3.35 TB/s; 2.5
    # int32 operations per cell and generation (the separable count, four
    # cells to a word) at 132 SMs x 64 lanes x the max SM clock; config #1
    # also waits 1,000 cluster barriers, timed alone
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60)
        .stdout.split()[0]) * 1e6
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def probe():
        rc = lib.ca2d_barrier_probe(p1.cluster, 1000, stream)
        require(rc == 0, f"barrier probe launched (CUDA error {rc})")

    barrier_ms = time_ms(probe, (), 5)

    def bound(cells, steps):
        t_bytes = 2 * cells / 3.35e12 * 1e3
        t_ops = 2.5 * cells * steps / (132 * 64 * clock) * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops \
            else "operations"

    ms = time_ms(CA.ca2d_run_fused, (CA.CA_TEST, g1, 1000), 5)
    plain_ms = time_ms(CA.ca2d_run, (CA.CA_TEST, g1, 1000), 2)
    b1, by1 = bound(256 * 256, 1000)
    log(f"phase 6 CA config #1 (1 x 256^2 CA_TEST x 1000 generations): K3 "
        f"{ms:.3f} ms ({256 * 256 * 1000 / ms * 1e3:.4g} cell-steps/s) vs "
        f"plain {plain_ms:.3f} ms; bound {b1:.4f} ms ({by1}, at "
        f"{clock / 1e6:.0f} MHz), with 1,000 cluster barriers of cluster "
        f"{p1.cluster} ({barrier_ms:.3f} ms alone) {b1 + barrier_ms:.3f} ms "
        f"({smi})")
    cells = 1024 * 256 * 256 * 100
    before = CA.ca2d_run_fused.launches
    ms_b = time_ms(CA.ca2d_run_fused, (CA.CA_TEST, gb, 100), 5)
    per_call = (CA.ca2d_run_fused.launches - before) / 6
    plain_b = time_ms(CA.ca2d_run, (CA.CA_TEST, gb, 100), 1)
    bb, byb = bound(1024 * 256 * 256, 100)
    log(f"phase 6 CA batched (1024 x 256^2 = 64 MiB, 100 generations): K3 "
        f"{ms_b:.3f} ms ({cells / ms_b * 1e3:.4g} cell-steps/s, "
        f"{per_call:.0f} launch per call) vs plain {plain_b:.3f} ms "
        f"({cells / plain_b * 1e3:.4g} cell-steps/s); bound {bb:.3f} ms "
        f"({byb}); live cells {live:.3f} ({smi})")

    t0 = time.perf_counter()
    a = cave_scene(48, 48, 48, seed=5, ca_rule=2, ca_steps=8, device=dev)
    b = cave_scene(48, 48, 48, seed=5, ca_rule=2, ca_steps=8, device="cpu")
    same = all(x.shape == y.shape and bool((x == y).all())
               for x, y in zip(a, b))
    log(f"phase 6 cave_scene 48^3 rule 2 x 8: card == CPU {same}; "
        f"{int((a[0] != 0).sum())} solid cells, {a[3].shape[0]} faces "
        f"({time.perf_counter() - t0:.1f} s for both)")
    require(same and a[3].shape[0] > 0, "cave_scene on the card equals CPU")
    return {"launches": launches, "max_abs_err": float(max_err), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b1, "bound_by": by1,
            "barrier_bound_ms": b1 + barrier_ms}


def run_skinning_phase(dev, smi, require, n_inst=1024, n_joints=64,
                       n_verts=4096):
    """Phase 7: the JAX bench's config #3 (bench.py:75-136) on the card,
    its rig built as bench.py:88-115 builds it; four instances against the
    CPU path."""
    import numpy as np
    import torch

    from clap_tpu_torch.anim.clips import (PATH_ROTATION, PATH_TRANSLATION,
                                           build_library, sample_pose)
    from clap_tpu_torch.anim.joints import build_skeleton, joint_matrices
    from clap_tpu_torch.anim.skin import skin_verts_batch
    from clap_tpu_torch.bridge import tree_map

    rng = np.random.default_rng(0)
    parent = [-1] + [(i - 1) // 2 for i in range(1, n_joints)]
    invbind = np.tile(np.eye(4, dtype=np.float32), (n_joints, 1, 1))
    base_t = rng.standard_normal((n_joints, 3)).astype(np.float32) * 0.1
    base_r = np.tile(np.array([0, 0, 0, 1], np.float32), (n_joints, 1))
    base_s = np.ones((n_joints, 3), np.float32)
    sk = build_skeleton(parent, invbind, base_t, base_r, base_s,
                        device="cpu")
    keys = np.linspace(0, 2.0, 16)

    def qr():
        q = rng.standard_normal((16, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    clip = []
    for j in range(n_joints):
        clip.append((j, PATH_ROTATION, keys, qr()))
        clip.append((j, PATH_TRANSLATION, keys,
                     rng.standard_normal((16, 3)).astype(np.float32) * 0.05))
    lib = build_library([clip], n_joints, device="cpu")
    verts = torch.as_tensor(rng.standard_normal((n_verts, 3)),
                            dtype=torch.float32)
    normals = verts / torch.linalg.vector_norm(verts, dim=-1, keepdim=True)
    w = rng.random((n_verts, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    mesh = (verts, normals, torch.as_tensor(w),
            torch.as_tensor(rng.integers(0, n_joints, (n_verts, 4)),
                            dtype=torch.int32))

    def pose_and_skin(sk, lib, mesh, ts):
        clips = torch.zeros(ts.shape, dtype=torch.long, device=ts.device)
        jts = joint_matrices(sk, sample_pose(lib, sk.base, clips, ts))
        return skin_verts_batch(jts, *mesh)[0]

    def to_dev(t):
        return tree_map(lambda x: x.to(dev), t)

    dsk, dlib, dmesh = to_dev(sk), to_dev(lib), to_dev(mesh)
    ts = torch.linspace(0.0, 2.0, n_inst)
    dts = ts.to(dev)
    out = pose_and_skin(dsk, dlib, dmesh, dts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        out = pose_and_skin(dsk, dlib, dmesh, dts)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 10
    pick = torch.tensor([0, n_inst // 3, 2 * n_inst // 3, n_inst - 1])
    ref = pose_and_skin(sk, lib, mesh, ts[pick])
    err = float((out[pick.to(dev)].cpu() - ref).abs().max())
    log(f"phase 7 skinning: {n_inst} instances x {n_joints} joints x "
        f"{n_verts} verts, {dt * 1e3:.3f} ms/call, "
        f"{n_inst * n_verts / dt:.4g} skinned verts/s; instances "
        f"{pick.tolist()} vs the CPU path max abs err {err:.3g} ({smi})")
    require(bool(torch.isfinite(out).all()), "skinned verts finite")
    require(err <= 1e-4, "skinning within 1e-4 of the CPU path")


def run_sharding_phase(dev, smi, require, check_tile, check_depth, flag):
    """Phase 18: env-axis sharding on the card (clap_tpu_torch.parallel).
    (a) ``dryrun_multichip`` on a mesh of every card present and on a
    ``MESH_ENTRIES``-entry mesh of ``dev``, each against the same world
    stepped unsharded (state and frames bit-exact), with K1/K2 bit-exact on
    the last shard's records (and, over several cards, on the last card).
    (b) phase 5's world (``build_slice``) from ``flag``'s distinct per-env
    states (dict gs, static: on the host, frame) for ``SHARD_FRAMES`` frames
    (inputs ``ins_at(frame + j)``) unsharded, sharded over the
    ``MESH_ENTRIES``-entry mesh of ``dev``, and where there is more than one
    card over the cards: integer, boolean and float state and every env's
    image equal to the unsharded run's bit for bit, the cross-env mean
    (``env_mean``, from per-shard sums) within 1e-6 relative of the
    unsharded ``mean()``, one K1 and one K2 launch per shard per frame;
    wall and device busy ms per frame of each run (``frame_times``,
    ``SHARD_REPS`` each; over the cards the busy ms sum every card's),
    K1/K2 bit-exact on the last shard's records, timed and bounded.
    Returns a dict: launches (the one-card mesh run's), k1, k2 (the last
    shard's kernel reports), dryrun_launches (of the dryrun on the
    one-card mesh), dryrun_k1, dryrun_k2."""
    import torch

    from clap_tpu_torch.bridge import tree_leaves
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.parallel.multichip import (dryrun_multichip,
                                                   multichip_world)
    from clap_tpu_torch.parallel.sharding import (env_mean, env_mesh,
                                                  gather_envs, map_shards,
                                                  replicate, shard_envs)
    from clap_tpu_torch.render import raster as R

    cuda = torch.device(dev).type == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 0
    one = env_mesh(MESH_ENTRIES, devices=[dev] * MESH_ENTRIES)
    every = env_mesh() if cuda else None
    cards = every if n_cards > 1 else None

    def sync_all():
        if cuda:
            for i in range(n_cards):
                torch.cuda.synchronize(i)

    def same_tree(a, b):
        return all(torch.equal(x, y.to(x.device))
                   for x, y in zip(tree_leaves(a), tree_leaves(b)))

    # ------------------------------------------------------------ (a)
    res = {}
    for mesh in ([every] if every else []) + [one]:
        reset_launches()
        gs_d, mean, frames_ = dryrun_multichip(mesh.size,
                                               devices=mesh.devices)
        sync_all()
        launched = read_launches()
        w = multichip_world(frames_.shape[0], dev)
        gs_w, whole = step_and_render(w["gw"], w["renderer"], w["gs"],
                                      w["ins"])
        exact = bool(torch.equal(whole, frames_.to(dev))) and \
            same_tree(gs_w, gs_d)
        log(f"phase 18 dryrun_multichip: mesh {[str(d) for d in mesh.devices]}"
            f" ({mesh.size} entries, {frames_.shape[0]} envs x "
            f"{frames_.shape[2]}x{frames_.shape[1]}), mean luma "
            f"{float(mean):.6f}, launches {launched}, state and frames "
            f"bit-equal to the unsharded world {exact}")
        require(launched == {"raster_tile": mesh.size,
                             "raster_depth": mesh.size},
                f"the dryrun: one K1 and one K2 per shard ({launched})")
        require(exact, "dryrun_multichip's sharded state and frames equal "
                "the same world's unsharded ones bit for bit")
        if mesh is every and not cards:
            continue              # one card: the one-card mesh's shard below
        d = mesh.devices[-1]
        r = replicate(w["renderer"], mesh)[-1]
        last = shard_envs(gs_w, mesh)[-1]
        with torch.cuda.device(d) if cuda else contextlib.nullcontext():
            _, rec, binned, srec, sbin, dims = frame_records(
                r, last.engine, last.joint_mats)
            if mesh is cards:     # the kernels on the last card
                check_tile(f"dryrun last shard on {d}", R.kernel_inputs(
                    rec, binned, r.opts.width, r.opts.height))
                check_depth(f"dryrun last shard atlas on {d}",
                            R.kernel_inputs(srec, sbin, *dims,
                                            depth_only=True))
                continue
        res["dryrun_launches"] = launched
        name = f"dryrun last shard ({frames_.shape[0] // mesh.size} envs)"
        kind = "extras" if r.cluster_records else "barycentric"
        res["dryrun_k1"] = kernel_report(
            "phase 18", f"{name} {kind} records", check_tile, rec, binned,
            (r.opts.width, r.opts.height), False, smi)
        res["dryrun_k2"] = kernel_report(
            "phase 18", f"{name} cascade atlas {dims[1]}x{dims[0]}",
            check_depth, srec, sbin, dims, True, smi)

    # ------------------------------------------------------------ (b)
    fw, k0 = flag["w"], flag["frame"]
    gs0 = to_device(flag["gs"], dev)
    gw, ins_at = fw["gw"], fw["ins_at"]
    renderer = make_renderer(fw, to_device(flag["static"], dev))
    n = gs0.engine.frame.shape[0]
    ins = [ins_at(k0 + j) for j in range(SHARD_FRAMES)]

    def sharded(mesh, gss, frame_ins):
        gws, rs = replicate(gw, mesh), replicate(renderer, mesh)
        imgs, means = [], []
        for i in frame_ins:
            out = map_shards(step_and_render, mesh, gws, rs, gss,
                             shard_envs(i, mesh))
            gss = [g for g, _ in out]
            imgs.append(gather_envs([im for _, im in out]))
            means.append(env_mean([im for _, im in out]))
        sync_all()
        return gather_envs(gss), imgs, means

    reset_launches()
    gs_u, imgs_u = gs0, []
    for i in ins:
        gs_u, img = step_and_render(gw, renderer, gs_u, i)
        imgs_u.append(img)
    sync_all()
    lu = read_launches()
    require(lu == {"raster_tile": SHARD_FRAMES, "raster_depth": SHARD_FRAMES},
            f"the unsharded run: one K1 and one K2 a frame ({lu})")
    runs = [("mesh " + "+".join(str(d) for d in one.devices), one)]
    if cards:
        runs.append((f"{n_cards} cards", cards))
    else:
        log(f"phase 18 over the cards: {n_cards} card here, the cards' run "
            "is the unsharded one")
    wall_u, busy_u = frame_times(
        lambda: step_and_render(gw, renderer, gs0, ins[0]), SHARD_REPS)
    log(f"phase 18 flagship unsharded: {n} envs x {RES}^2 from distinct "
        f"per-env states (frame {k0}), {spread(wall_u)} wall / "
        f"{spread(busy_u)} device busy per frame; launches over "
        f"{SHARD_FRAMES} frames {lu} ({smi})")
    mean_u = [float(im.mean()) for im in imgs_u]
    for name, mesh in runs:
        reset_launches()
        gs_s, imgs_s, means_s = sharded(mesh, shard_envs(gs0, mesh), ins)
        ls = read_launches()
        m = mesh.size
        require(ls == {"raster_tile": m * SHARD_FRAMES,
                       "raster_depth": m * SHARD_FRAMES},
                f"{name}: one K1 and one K2 per shard per frame ({ls})")
        same = [torch.equal(a, b.to(a.device)) for a, b in
                zip(tree_leaves(gs_u), tree_leaves(gs_s))]
        diff = max(float((a.double() - b.to(a.device).double()).abs().max())
                   for a, b in zip(tree_leaves(gs_u), tree_leaves(gs_s))
                   if a.is_floating_point() and a.numel())
        img_same = all(torch.equal(a, b.to(a.device))
                       for a, b in zip(imgs_u, imgs_s))
        rel = max(abs(float(b) - a) / abs(a) for a, b in zip(mean_u, means_s))
        first = shard_envs(gs0, mesh)
        wall_s, busy_s = frame_times(
            lambda: sharded(mesh, first, ins[:1]), SHARD_REPS)
        log(f"phase 18 flagship sharded over {name} ({m} shards of {n // m} "
            f"envs): {spread(wall_s)} wall / {spread(busy_s)} device busy "
            f"per frame; launches over {SHARD_FRAMES} frames {ls}; state "
            f"leaves bit-equal {sum(same)}/{len(same)} (float max abs diff "
            f"{diff:.3g}), every env's image bit-equal {img_same}, cross-env "
            f"mean rel diff {rel:.3g} ({smi})")
        require(all(same), f"{name}: the sharded state equals the "
                "unsharded bit for bit")
        require(img_same, f"{name}: every env's image equals the unsharded "
                "bit for bit")
        require(rel <= 1e-6, f"{name}: cross-env mean within 1e-6 relative")
        res.setdefault("launches", ls)
        del gs_s, imgs_s, first
    # K1/K2 on the last shard's inputs (frame k0 + SHARD_FRAMES' state)
    last = shard_envs(gs_u, one)[-1]
    _, rec, binned, srec, sbin, dims = frame_records(
        renderer, last.engine, last.joint_mats)
    res["k1"] = kernel_report("phase 18", f"sharded flagship last shard "
                              f"({n // one.size} envs) extras records",
                              check_tile, rec, binned, (RES, RES), False, smi)
    res["k2"] = kernel_report("phase 18", f"sharded flagship last shard "
                              f"cascade atlas {dims[1]}x{dims[0]}",
                              check_depth, srec, sbin, dims, True, smi)
    return res


if __name__ == "__main__":
    sys.exit(main())
