"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here is marked ``cuda`` and skips without a CUDA
device.

This file imports no JAX (the card's machine has none), and
tests/conftest.py does, so on the card run it without the conftest:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Bar for K1/K2, as for the reference's own kernel check: tid agreement
>= 99.5 % and depth within 1e-4 where ids agree (K2: the same finite
pixels, depth within 1e-4); they are bit-exact in practice. K3 (the CA
kernel) is integer arithmetic and must be bit-exact."""
import math

import numpy as np
import pytest
import torch

from clap_tpu_torch import mathx as mx
from clap_tpu_torch.bench import parity_scene
from clap_tpu_torch.ops import ca2d as CA
from clap_tpu_torch.render import raster as R

# one rule of each neighbourhood the content rules lack (vn1, vnv); the
# CPU parity tests import them too
CA_VN1_TEST = CA.CARule("vn1 test", born_mask=0b0110, surv_mask=0b1100,
                        nr_states=3, decay=True, neigh="vn1")
CA_VNV_TEST = CA.CARule("vnv test", born_mask=0b0011, surv_mask=0b0101,
                        nr_states=7, decay=True, neigh="vnv")
CA_RULES = [CA.CA_TEST, CA.CA_COOL_TREE, CA.CA_ASH_PINUS, CA_VN1_TEST,
            CA_VNV_TEST]
# (B, H, W) × generations: kernel_parity_check's shape, odd widths that
# are no multiple of 32, and the bench's 256² × 1,000
CA_SHAPES = [((1, 64, 64), 32), ((3, 96, 160), 17), ((2, 37, 53), 9),
             ((1, 256, 256), 1000)]


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_build_on_card(cuda_device):
    from clap_tpu_torch import cuda_build

    cuda_build.build_all()
    lib = cuda_build.load_lib("raster")
    assert lib.raster_tile_launch and lib.raster_depth_launch
    assert cuda_build.load_lib("ca2d").ca2d_launch


@pytest.mark.cuda
@pytest.mark.parametrize("W,H,chunk", [(128, 128, 32), (256, 128, 8),
                                       (256, 128, 32)])
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_matches_plain_version_on_card(cuda_device, depth_only, W, H,
                                              chunk):
    rec, ok = parity_scene(W, H, cuda_device)
    args = R.kernel_inputs(rec, R.bin_triangles(rec, ok, W, H), W, H,
                           chunk=chunk, depth_only=depth_only)
    kernel, plain = (R.raster_depth, R.raster_depth_ref) if depth_only \
        else (R.raster_tile, R.raster_tile_ref)
    before = kernel.launches
    k = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    r = plain(*args)
    if depth_only:
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(k), fin)
        assert fin.any()
        assert float((k - r).abs()[fin].max()) <= 1e-4
    else:
        same = k[1] == r[1]
        assert float(same.float().mean()) >= 0.995
        hit = same & (r[1] >= 0)
        assert hit.any()
        assert float((k[0] - r[0]).abs()[hit].max()) <= 1e-4


def _lattice_records(W, H, dev, step=8):
    """Triangles with every vertex on a pixel centre (edges run through
    centres), in one z = 0.25 plane, each one twice: equal-z ties on every
    shared edge and on every pixel of a duplicate."""
    xs = torch.arange(0, W + step, step, dtype=torch.float32) + 0.5
    ys = torch.arange(0, H + step, step, dtype=torch.float32) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    p = torch.stack([gx, gy], -1)
    a, b, c, d = p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]
    tris = torch.cat([torch.stack([a, c, b], -2).reshape(-1, 3, 2),
                      torch.stack([b, c, d], -2).reshape(-1, 3, 2)])
    tris = torch.cat([tris, tris])
    zw = torch.tensor([0.25, 1.0]).expand(*tris.shape[:2], 2)
    corners = torch.cat([tris, zw], -1).to(dev)          # (T, 3, 4)
    return R.corner_records(corners[None, :, 0], corners[None, :, 1],
                            corners[None, :, 2], two_sided=True)


def _bit_exact(rec, ok, W, H, depth_only):
    args = R.kernel_inputs(rec, R.bin_triangles(rec, ok, W, H), W, H,
                           depth_only=depth_only)
    kernel, plain = (R.raster_depth, R.raster_depth_ref) if depth_only \
        else (R.raster_tile, R.raster_tile_ref)
    k = kernel(*args)
    if k[0].is_cuda:
        torch.cuda.synchronize()
    r = plain(*args)
    if depth_only:
        k, r = (k,), (r,)
    for a, b in zip(k, r):
        assert torch.equal(a, b)
    return args, r


# (W, H): 8×128 tiles (4 rows a thread), 16×256 (8), 32×256 (16)
PPT_TARGETS = [(128, 128), (256, 128), (256, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("W,H", PPT_TARGETS)
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_bit_exact_scene_on_card(cuda_device, depth_only, W, H):
    rec, ok = parity_scene(W, H, cuda_device)
    _bit_exact(rec, ok, W, H, depth_only)


@pytest.mark.cuda
@pytest.mark.parametrize("W,H", PPT_TARGETS)
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_bit_exact_pixel_centre_edges_and_ties_on_card(
        cuda_device, depth_only, W, H):
    rec, ok = _lattice_records(W, H, cuda_device)
    _, r = _bit_exact(rec, ok, W, H, depth_only)
    assert bool(torch.isfinite(r[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_all_lists_empty_on_card(cuda_device, depth_only):
    rec, ok = parity_scene(256, 128, cuda_device)
    ok = torch.zeros_like(ok)
    args, r = _bit_exact(rec, ok, 256, 128, depth_only)
    assert int(args[3].sum()) == 0
    assert bool(torch.isinf(r[0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_big_list_only_on_card(cuda_device, depth_only):
    """Two screen-wide triangles span more tiles than the span cap: the
    big list holds them and every small list is empty."""
    W, H = 256, 1024
    corners = torch.tensor([[[-10.0, -10.0, 0.5, 1.0], [-10.0, 2000.0, 0.5, 1.0],
                             [600.0, -10.0, 0.5, 1.0]],
                            [[600.0, -10.0, 0.2, 1.0], [-10.0, 2000.0, 0.2, 1.0],
                             [600.0, 2000.0, 0.2, 1.0]]],
                           device=cuda_device)
    rec, ok = R.corner_records(corners[None, :, 0], corners[None, :, 1],
                               corners[None, :, 2], two_sided=True)
    args, r = _bit_exact(rec, ok, W, H, depth_only)
    counts, sub = args[3], args[8]
    assert int(counts[..., :sub].sum()) == 0 and int(counts[..., sub].min()) > 0
    assert bool(torch.isfinite(r[0]).all())


@pytest.mark.cuda
def test_kernel_rejects_cpu_inputs_mixed_with_cuda(cuda_device):
    """A CUDA launch takes CUDA tensors only; it never falls back."""
    rec, ok = parity_scene(128, 128, cuda_device)
    args = list(R.kernel_inputs(rec, R.bin_triangles(rec, ok, 128, 128),
                                128, 128))
    args[0] = args[0].cpu()
    with pytest.raises(ValueError):
        R.raster_tile(*args)


@pytest.fixture(scope="module")
def frame_inputs():
    """K1/K2 inputs of the composed frames at 2 envs × 256² after 3 frames
    (chip_smoke.py's worlds): the skinned flagship (22-column extras
    records) and the textured frame (19-column barycentric records, the
    gather path). Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    import chip_smoke as CS
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = torch.device("cuda", 0)
    out = {}
    for textured in (False, True):
        w = CS.build_slice(dev, n_envs=2, textured=textured)
        static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
        renderer = CS.make_renderer(w, static)
        gs = w["gs"]
        for _ in range(3):
            gs, _img = step_and_render(w["gw"], renderer, gs, w["ins"])
        out["textured" if textured else "skinned_flagship"] = \
            CS.frame_records(renderer, gs.engine, gs.joint_mats)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path,ncol", [("skinned_flagship", 22),
                                       ("textured", 19)])
@pytest.mark.parametrize("depth_only", [False, True])
def test_kernel_bit_exact_on_frame_inputs_on_card(frame_inputs, path, ncol,
                                                  depth_only):
    """K1 on the main pass's records (extras mode for the skinned
    flagship, barycentric mode for the textured frame) and K2 on the
    cascade atlas, each bit-exact against its plain version."""
    _geom, rec, binned, srec, sbin, dims = frame_inputs[path]
    assert rec.shape[1] == ncol and rec.is_cuda
    if depth_only:
        args = R.kernel_inputs(srec, sbin, *dims, depth_only=True)
        kernel, plain = R.raster_depth, R.raster_depth_ref
    else:
        args = R.kernel_inputs(rec, binned, 256, 256)
        kernel, plain = R.raster_tile, R.raster_tile_ref
    before = kernel.launches
    k = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    r = plain(*args)
    k, r = (k, r) if isinstance(k, tuple) else ((k,), (r,))
    assert bool(torch.isfinite(r[0]).any())
    for a, b in zip(k, r):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def bench_scene_inputs():
    """K1/K2 inputs of the JAX bench's single-frame and shared-scene
    configurations (chip_smoke.py's builders): the dense 720p frame's
    19-column records built from its corner stream, the 22-column extras
    records of the batched terrain built from faces and normals
    (``vextra``, 4 views × 256²), and the production scene's 2,048² static
    bake. Skips without a CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    import chip_smoke as CS
    from clap_tpu_torch.render import pipeline as P
    from clap_tpu_torch.render.scenerender import static_shadow_geometry

    dev = torch.device("cuda", 0)
    w = CS.build_full_frame(dev, nr_v=240, n_cubes=256, raster_cap=4096)
    g = w["geom"]
    clip = P.clip_transform(g.corner_verts, w["view"], w["proj"])
    rec, binned = P.gather_records(w["opts"], g, clip)[:2]
    out = {"full_frame_dense": R.kernel_inputs(rec, binned, 1280, 720)}
    b = CS.build_batched(dev, n_envs=4, res=256)
    gb = P.per_env(b["geom"], 4)
    rec, binned, _ = P.surface_records(
        b["opts"], gb, P.clip_transform(gb.verts, b["views"], b["proj"]))
    out["batched_vextra"] = R.kernel_inputs(rec, binned, 256, 256)
    p = CS.build_production(dev, bake_size=256)
    sg, sv, _ = static_shadow_geometry(p["rt"], p["mx0"],
                                       p["lights"].direction[0])
    srec, sbin, dims = P.shadow_records(P.RenderOptions(shadow_size=2048),
                                        sg, sv.view[None], sv.proj[None])
    out["bake_2048"] = R.kernel_inputs(srec, sbin, *dims, depth_only=True)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path,ncol", [("full_frame_dense", 24),
                                       ("batched_vextra", 24),
                                       ("bake_2048", 16)])
def test_kernel_bit_exact_on_bench_scenes_on_card(bench_scene_inputs, path,
                                                  ncol):
    """K1 on the corner-stream 720p frame and on member-geometry extras
    records, K2 on a 2,048² bake: bit-exact against the plain versions."""
    args = bench_scene_inputs[path]
    assert args[0].shape[-1] == 8 * ncol and args[0].is_cuda
    kernel, plain = (R.raster_depth, R.raster_depth_ref) if ncol == 16 \
        else (R.raster_tile, R.raster_tile_ref)
    before = kernel.launches
    k = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    r = plain(*args)
    k, r = (k, r) if isinstance(k, tuple) else ((k,), (r,))
    assert bool(torch.isfinite(r[0]).any())
    for a, b in zip(k, r):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_engine_step_no_host_sync_on_card(cuda_device):
    """engine_step at 64 envs (two characters, camera occlusion) makes no
    synchronizing CUDA call after its first: the body flags and character
    slots are host facts of the scene (SceneConfig.host)."""
    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.step import engine_step, inputs_zero
    from clap_tpu_torch.scene import testbed as tbm

    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=96, n_chars=2, terrain_chunks=4,
                           device=cuda_device)
    st = tbm.replicate_state(tb.state0, 64)
    ins = tree_map(lambda x: x.expand(64, *x.shape).clone(),
                   inputs_zero(2, device=cuda_device))
    ins.motion[:, 0, 0] = 1.0
    st = engine_step(tb.cfg, st, ins, camera_occlusion=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st = engine_step(tb.cfg, st, ins, camera_occlusion=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool((st.frame == 4).all())
    assert bool(torch.isfinite(st.phys.pos).all())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["full_frame", "production", "batched",
                                  "flagship_render", "flagship_half_res"])
def test_render_no_host_sync_on_card(cuda_device, path):
    """A frame of each render path makes no synchronizing CUDA call after
    its first (sync-debug "error"): fixed values are cached constants, the
    inverses skip their singularity check."""
    import dataclasses

    import chip_smoke as CS
    from clap_tpu_torch.render.pipeline import (render_frame,
                                                render_frame_batch)
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = cuda_device
    if path == "full_frame":
        w = CS.build_full_frame(dev)

        def frame():
            return render_frame(w["opts"], w["geom"], w["view"], w["proj"],
                                w["lights"], w["eye"])
    elif path == "production":
        w = CS.build_production(dev, bake_size=512)

        def frame():
            return CS.production_frame(w, w["eye"])
    elif path == "batched":
        w = CS.build_batched(dev, 8, 256)

        def frame():
            return render_frame_batch(w["opts"], w["geom"], w["views"],
                                      w["proj"], w["lights"], w["eyes"],
                                      far=100.0)
    else:
        w = CS.build_slice(dev, 4)
        if path == "flagship_half_res":
            w["opts"] = dataclasses.replace(w["opts"], internal_scale=2)
        static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
        renderer = CS.make_renderer(w, static)

        def frame():
            return renderer(w["gs"].engine, w["gs"].joint_mats)
    img = frame()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img2 = frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(img, img2)


@pytest.fixture(scope="module")
def option_inputs():
    """K1/K2 inputs of the game's own frame and of two render options
    (chip_smoke.py's worlds): the demo's 640 × 360 frame after 2 frames of
    game_frame_step (its particle billboard records, behind-camera quads
    included, and its gather-path surface records), the skinned flagship
    at 2 envs under ``model_msaa`` 2 (the 512² extras records) and under
    ``shadow_msaa`` 2 (the (2, 2,048, 512) cascade atlas). Skips without a
    CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "tests/test_torch_cuda.py -m cuda --noconftest)")
    import dataclasses

    import chip_smoke as CS
    from clap_tpu_torch.engine.frame import game_frame_step
    from clap_tpu_torch.render import pipeline as P
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = torch.device("cuda", 0)
    g = CS.build_game_frame(dev)
    r, gs = g["renderer"], g["gs"]
    for _ in range(2):
        gs, _img = game_frame_step(g["gw"], r, gs, g["ins"])
    st = gs.engine
    view = r.view(st)
    pos = gs.particles.pos.reshape(1, -1, 3).clone()
    cam = st.camera.pos[0]
    pos[0, :8] = cam + 0.5 * (cam - st.pos[0, 1])   # behind the camera
    rec, binned = P.particle_records(r.opts, pos, 0.1,
                                     r.particle_active[None], view, r.proj)
    out = {"particles": R.kernel_inputs(rec, binned, 640, 360)}
    geom = r.geometry(st, view, gs.joint_mats)
    clip = P.clip_transform(geom.verts, view, r.proj)
    rec, binned = P.gather_records(r.opts, geom, clip)[:2]
    out["game_surface"] = R.kernel_inputs(rec, binned, 640, 360)
    w = CS.build_slice(dev, n_envs=2)
    static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                w["lights"].direction[0], shadow_size=1024,
                                far=200.0)
    fr = CS.make_renderer(w, static)
    gs = w["gs"]
    msaa = dataclasses.replace(fr.opts, width=512, height=512)
    _, rec, binned, _, _, _ = CS.frame_records(fr, gs.engine, gs.joint_mats,
                                               msaa)
    out["msaa_512"] = R.kernel_inputs(rec, binned, 512, 512)
    smsaa = dataclasses.replace(fr.opts, shadow_msaa=2)
    *_, srec, sbin, dims = CS.frame_records(fr, gs.engine, gs.joint_mats,
                                            smsaa)
    assert dims[:2] == (512, 2048)
    out["shadow_msaa_atlas"] = R.kernel_inputs(srec, sbin, *dims,
                                               depth_only=True)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["particles", "game_surface", "msaa_512",
                                  "shadow_msaa_atlas"])
def test_kernel_bit_exact_on_option_inputs_on_card(option_inputs, path):
    """K1 on the game frame's particle billboards and surface records and
    on the model_msaa 2 records, K2 on the shadow_msaa 2 atlas: bit-exact
    against the plain versions."""
    args = option_inputs[path]
    depth_only = path == "shadow_msaa_atlas"
    kernel, plain = (R.raster_depth, R.raster_depth_ref) if depth_only \
        else (R.raster_tile, R.raster_tile_ref)
    before = kernel.launches
    k = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    r = plain(*args)
    k, r = (k, r) if isinstance(k, tuple) else ((k,), (r,))
    assert bool(torch.isfinite(r[0]).any())
    for a, b in zip(k, r):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["game_step", "textured_render",
                                  "game_frame_render", "level_step",
                                  "level_follow_step"])
def test_step_and_render_no_host_sync_on_card(cuda_device, path):
    """game_step (the flagship's wiring at 4 envs, camera occlusion), the
    textured render (the gather path at 4 envs) and the game's own frame
    (GameFrameRenderer: particles, grain, single-env assembly, 640 × 360)
    make no synchronizing CUDA call after their first (sync-debug
    "error")."""
    import chip_smoke as CS
    from clap_tpu_torch.engine.game import game_step
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = cuda_device
    if path == "game_step":
        w = CS.build_slice(dev, 4)

        def call():
            return game_step(w["gw"], w["gs"], w["ins"]).engine.pos
    elif path == "textured_render":
        w = CS.build_slice(dev, 4, textured=True)
        static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
        renderer = CS.make_renderer(w, static)

        def call():
            return renderer(w["gs"].engine, w["gs"].joint_mats)
    elif path in ("level_step", "level_follow_step"):
        # the authored level (camera bank, 84 triangles) and the beam
        # (per-env triangles following the entity's full transform)
        from clap_tpu_torch.bridge import tree_map
        from clap_tpu_torch.engine.step import inputs_zero

        w = CS.build_level(dev, 4, "level57" if path == "level_step"
                           else "beam")
        C = w["gs"].engine.chars.state.shape[1]
        ins = tree_map(lambda x: x.expand(4, *x.shape).clone(),
                       inputs_zero(C, device=dev))
        ins.motion[:, 0, 0] = 1.0

        def call():
            return game_step(w["gw"], w["gs"], ins,
                             camera_occlusion=True).engine.pos
    else:
        g = CS.build_game_frame(dev)
        gs = g["gs"]

        def call():
            return g["renderer"](gs.engine, gs.particles, None,
                                 gs.joint_mats)
    out = call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out2 = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out2).all())
    assert torch.equal(out, out2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,steps", CA_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
@pytest.mark.parametrize("rule", CA_RULES, ids=lambda r: r.name)
def test_ca2d_kernel_matches_plain_version_on_card(cuda_device, rule, shape,
                                                   steps):
    gen = torch.Generator(device=cuda_device).manual_seed(steps)
    g = torch.randint(0, rule.nr_states + 1, shape, generator=gen,
                      device=cuda_device, dtype=torch.int32).to(torch.uint8)
    before = CA.ca2d_run_fused.launches
    k = CA.ca2d_run_fused(rule, g, steps)
    torch.cuda.synchronize()
    assert CA.ca2d_run_fused.launches == before + 1
    assert torch.equal(k, CA.ca2d_run(rule, g, steps))


@pytest.mark.cuda
def test_ca2d_kernel_edges_on_card(cuda_device):
    g = torch.randint(0, 5, (64, 64), device=cuda_device,
                      dtype=torch.int32).to(torch.uint8)
    same = CA.ca2d_run_fused(CA.CA_TEST, g, 0)          # a copy, (H, W)
    assert same.shape == (64, 64) and torch.equal(same, g)
    before = CA.ca2d_run_fused.launches
    empty = CA.ca2d_run_fused(CA.CA_TEST, g[None, :0], 5)   # launches nothing
    assert empty.shape == (1, 0, 64)
    none = CA.ca2d_run_fused(CA.CA_TEST, g[None][:0], 5)
    assert none.shape == (0, 64, 64)
    assert CA.ca2d_run_fused.launches == before


def _ca_check(rule, shape, steps, dev, plan=None, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randint(0, rule.nr_states + 1, shape, generator=gen,
                      device=dev, dtype=torch.int32).to(torch.uint8)
    k = CA.ca2d_run_fused(rule, g, steps, plan)
    torch.cuda.synchronize()
    assert torch.equal(k, CA.ca2d_run(rule, g, steps)), (rule.name, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("side,steps", [(512, 20), (1024, 5)])
def test_ca2d_kernel_grids_beyond_one_block(cuda_device, side, steps):
    """512² and 1,024² exceed one CTA's shared memory: the planner splits
    each over a cluster, bit-exact for every neighbourhood."""
    plan = CA.ca2d_plan(1, side, side, *CA.ca2d_card(cuda_device))
    assert plan.route == "cluster" and plan.cluster > 1
    for rule in CA_RULES:
        _ca_check(rule, (1, side, side), steps, cuda_device, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_ca2d_kernel_every_cluster_size(cuda_device, cs):
    """Each cluster size up to the card's cap, forced, at 256² × 64."""
    limit, cap, sms = CA.ca2d_card(cuda_device)
    if cs > cap:
        pytest.skip(f"the card schedules clusters of at most {cap}")
    plan = CA.ca2d_plan(1, 256, 256, limit, cap, sms, cluster=cs)
    for rule in CA_RULES:
        _ca_check(rule, (1, 256, 256), 64, cuda_device, plan, cs)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,steps", [((132, 37, 53), 9),
                                         ((132, 96, 160), 17)])
def test_ca2d_kernel_in_place_route(cuda_device, shape, steps):
    """A batch of one CTA per grid steps in place (one buffer and a saved
    row); odd widths leave pad bytes in each row's last word."""
    plan = CA.ca2d_plan(*shape, *CA.ca2d_card(cuda_device))
    assert plan.route == "inplace"
    for rule in CA_RULES:
        _ca_check(rule, shape, steps, cuda_device, plan)


@pytest.mark.cuda
def test_ca2d_kernel_device_memory_route(cuda_device):
    """A grid no cluster holds: one launch per generation over device
    memory, plus pack and unpack, each counted."""
    plan = CA.ca2d_plan(1, 2048, 2048, *CA.ca2d_card(cuda_device))
    assert plan.route == "global"
    before = CA.ca2d_run_fused.launches
    _ca_check(CA.CA_TEST, (1, 2048, 2048), 5, cuda_device, plan)
    assert CA.ca2d_run_fused.launches == before + 7
    for rule in CA_RULES[1:]:
        _ca_check(rule, (1, 2048, 2048), 3, cuda_device, plan)


def _per_env_world(dev, B=3, T=24, seed=0):
    """A flat heightfield and a per-env triangle soup (B, T, 3, 3): random
    upward-facing triangles above the ground, each env's set shifted and
    some masked, plus queries (B, Q, 3)."""
    from clap_tpu_torch.physics.heightfield import make_heightfield
    from clap_tpu_torch.physics.narrowphase import make_world

    rng = np.random.default_rng(seed)
    n = 9
    hs = np.zeros((n, n), np.float32)
    nrm = np.zeros((n, n, 3), np.float32)
    nrm[..., 1] = 1.0
    base = rng.uniform(-4, 4, (T, 1, 3)) * np.array([1, 0, 1]) \
        + np.array([0, 1, 0]) * rng.uniform(0.2, 2.0, (T, 1, 1))
    tri = base + rng.uniform(-1.0, 1.0, (T, 3, 3)) * np.array([1, 0.1, 1])
    tri = tri[:, [0, 2, 1]].astype(np.float32)
    per_env = np.stack([tri + rng.uniform(-0.5, 0.5, (1, 1, 3))
                        for _ in range(B)]).astype(np.float32)
    valid = rng.uniform(size=(B, T)) > 0.2
    q = np.concatenate([rng.uniform(-4, 4, (B, 32, 1)),
                        rng.uniform(0.5, 3.0, (B, 32, 1)),
                        rng.uniform(-4, 4, (B, 32, 1))], -1).astype(
                            np.float32)
    world = make_world(make_heightfield(hs, nrm, [-8.0, -8.0], 16.0,
                                        device=dev), tri,
                       tri_entity=np.arange(T, dtype=np.int32))
    world = world._replace(tris=torch.as_tensor(per_env, device=dev),
                           tri_valid=torch.as_tensor(valid, device=dev))
    return world, torch.as_tensor(q, device=dev)


@pytest.mark.cuda
def test_per_env_triangles_on_card(cuda_device):
    """raycast_down, raycast and capsule_world_contacts on per-env
    triangles (B, T, 3, 3) on CUDA tensors against the same calls on CPU
    tensors: hits, entities and validity exact, distances, normals, points
    and depths within 1e-5."""
    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.physics.narrowphase import (capsule_world_contacts,
                                                    raycast, raycast_down)

    world, q = _per_env_world(cuda_device)
    cw, cq = tree_map(lambda x: x.cpu(), world), q.cpu()
    d = torch.tensor([0.3, -1.0, 0.2])
    d = d / d.norm()

    def calls(w, q):
        dirs = d.to(q.device).expand_as(q)
        return (raycast_down(w, q, 3.0),
                raycast(w, q, dirs, torch.full(q.shape[:-1], 4.0,
                                               device=q.device)),
                capsule_world_contacts(w, q - torch.tensor(
                    [0.0, 0.4, 0.0], device=q.device), q, torch.full(
                        q.shape[:-1], 0.3, device=q.device)))

    got = calls(world, q)
    torch.cuda.synchronize()
    ref = calls(cw, cq)
    for a, b in zip(tree_map(lambda x: x.cpu(), got), ref):
        for x, y in zip(a, b):
            if x.dtype in (torch.bool, torch.int32, torch.int64):
                assert torch.equal(x, y)
            else:
                fin = torch.isfinite(y)
                assert torch.equal(torch.isfinite(x), fin)
                assert torch.allclose(x[fin], y[fin], atol=1e-5)
    hit, ent = ref[0][2], ref[0][3]
    assert bool(hit.any()) and bool((ent >= 0).any())


@pytest.mark.cuda
def test_level_step_matches_cpu_on_card(cuda_device):
    """5 frames of the authored level's scripted walk (camera bank, 84
    triangles) and of the 4-character roster on the card against the same
    frames on the CPU: positions within 1e-4, latch frames equal."""
    import chip_smoke as CS

    for variant in ("level57", "roster4"):
        got = CS.drive_level(CS.build_level(cuda_device, 2, variant), 5)
        ref = CS.drive_level(CS.build_level("cpu", 2, variant), 5)
        assert torch.allclose(got["traj"].cpu(), ref["traj"], atol=1e-4)
        assert torch.equal(got["latch"].cpu(), ref["latch"])
        cams = got["gs"].engine.cameras
        assert torch.equal(got["gs"].engine.camera.pos, cams.pos[:, 0])


# ---------------------------------------------------------------------------
# the engine shell
# ---------------------------------------------------------------------------

def _demo_engine(dev, seed=5, fuzzer=False):
    """The demo's graphics Engine (clap_tpu_torch.demo.testbed --render,
    1 env × 640 × 360) on ``dev`` and its world."""
    from clap_tpu_torch.demo.testbed import build_world
    from clap_tpu_torch.engine.core import ClapConfig, Engine

    w = build_world(dev)
    eng = Engine(ClapConfig(title="testbed", fuzzer=fuzzer, width=640,
                            height=360, settings=False),
                 w["tb"].cfg, w["tb"].state0, game_world=w["gw"],
                 session0=w["session0"], device=dev, seed=seed)
    eng.attach_graphics(**w["graphics"])
    return w, eng


@pytest.mark.cuda
def test_engine_frame_equals_game_frame_step_on_card(cuda_device):
    """3 frames of the graphics Engine and of game_frame_step from the
    same session, inputs and generator seed: sessions and images equal
    bit for bit on the card."""
    from clap_tpu_torch.bridge import tree_leaves, tree_map
    from clap_tpu_torch.engine.core import graphics_renderer
    from clap_tpu_torch.engine.frame import game_frame_step
    from clap_tpu_torch.engine.step import inputs_zero
    from clap_tpu_torch.scene.testbed import replicate_state

    w, eng = _demo_engine(cuda_device)
    r = graphics_renderer(w["tb"].state0.mx, **w["graphics"])
    gs = replicate_state(w["session0"], 1)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ins = inputs_zero(2, device=cuda_device)
    ins.motion[0, 0] = 1.0
    ins.motion[1, 1] = -0.6
    for _ in range(3):
        eng.frame(ins)
        gs, img = game_frame_step(w["gw"], r, gs,
                                  tree_map(lambda x: x[None], ins),
                                  generator=gen)
        assert torch.equal(eng.last_frame, img[0])
        a, b = tree_leaves(eng.session), tree_leaves(gs)
        assert len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))
    assert float(eng.last_frame.std()) > 0.01


@pytest.mark.cuda
def test_engine_resets_a_nan_that_reaches_the_render_on_card(cuda_device):
    """A NaN in the live body positions before frame 59: that frame's
    step and render run over it on the card with no out-of-range index
    (a device-side assert would leave the context unusable), the watchdog
    at 60 resets the session to the initial one, and frame 60 is
    finite."""
    from clap_tpu_torch.bridge import tree_leaves

    _, eng = _demo_engine(cuda_device)
    eng.frame_no = 59
    eng.state.phys.pos[0, 0, 1] = float("nan")
    eng.frame()
    torch.cuda.synchronize()
    assert eng.frame_no == 60
    assert not bool(torch.isfinite(eng.last_frame).all())
    a, b = tree_leaves(eng.session), tree_leaves(eng._session0)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    eng.frame()
    assert bool(torch.isfinite(eng.last_frame).all())


@pytest.mark.cuda
def test_engine_frames_make_no_host_sync_on_card(cuda_device):
    """With no sound, dump or display attached, the graphics Engine's
    frames after the first (the fuzzer on) make no synchronizing CUDA
    call until the watchdog's frame (sync-debug "error"); the watchdog
    then reads the state once."""
    _, eng = _demo_engine(cuda_device, fuzzer=True)
    eng.frame()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        while eng.frame_no < 59:
            eng.frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.frame_no == 59
    eng.frame()                                   # the 1 Hz tick
    assert eng.frame_no == 60
    assert bool(torch.isfinite(eng.last_frame).all())


@pytest.mark.cuda
def test_fuzzer_draws_card_equal_cpu(cuda_device):
    """The soak's fuzzer (envs 0 and 4,095, frames 0-59): draws bit for
    bit, inputs within 1e-6, jumps equal."""
    from clap_tpu_torch.engine.fuzzer import fuzz_batch, fuzz_draws

    envs = torch.tensor([0, 4095])
    for f in range(60):
        a = fuzz_draws(0, f, envs.to(cuda_device), 1, cuda_device)
        assert torch.equal(a.cpu(), fuzz_draws(0, f, envs, 1, "cpu"))
    got = fuzz_batch(3, 17, 4096, device=cuda_device)
    ref = fuzz_batch(3, 17, 4096, device="cpu")
    assert torch.equal(got.jump.cpu(), ref.jump)
    for x, y in ((got.motion, ref.motion), (got.cam_delta, ref.cam_delta)):
        assert float((x.cpu() - y).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_assert_finite_reads_back_once_on_card(cuda_device):
    """One synchronizing call for a finite tree of many leaves
    (sync-debug "warn" counts them)."""
    import warnings

    from clap_tpu_torch.utils.guards import assert_finite

    tree = {f"x{i}": torch.randn(64, 3, device=cuda_device)
            for i in range(16)}
    tree["n"] = torch.arange(4, device=cuda_device)
    assert_finite(tree)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert_finite(tree)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert sum("synchroniz" in str(w.message) for w in caught) == 1


# ---------------------------------------------------------------------------
# the UI layer, the debug overlay and the flythrough
# ---------------------------------------------------------------------------

def _random_lines(dev, n=400, seed=0):
    """``n`` seeded lines, boxes and crosses around the origin, many
    crossing one another (pixels hit by several lines), some partly off
    screen or behind the camera, with unused slots after them."""
    from clap_tpu_torch.render.debug_draw import (add_aabb, add_cross,
                                                  add_line, lines_empty)

    g = torch.Generator().manual_seed(seed)
    dl, idx = lines_empty(n + 64, device=dev), 0
    while idx < n - 12:
        a, b = (torch.rand(3, generator=g) * 16 - 8 for _ in range(2))
        col = tuple(torch.rand(3, generator=g).tolist())
        kind = idx % 3
        if kind == 0:
            dl, idx = add_line(dl, idx, a.to(dev), b.to(dev), col)
        elif kind == 1:
            dl, idx = add_aabb(dl, idx, a.to(dev) - 0.5, a.to(dev) + 0.5, col)
        else:
            dl, idx = add_cross(dl, idx, a.to(dev), 0.6, col)
    return dl


def _overlay_camera(dev, W=640, H=360):
    view = mx.mat4_look_at(torch.tensor([3.0, 4.0, 12.0], device=dev),
                           torch.zeros(3, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], device=dev))
    proj = mx.mat4_perspective(math.pi / 3, W / H, 0.1, 100.0, device=dev)
    return view, proj


@pytest.mark.cuda
def test_draw_lines_deterministic_on_card(cuda_device):
    """400 overlapping lines over a 640 × 360 frame: two card runs are bit
    for bit the same and equal to the CPU's."""
    from clap_tpu_torch.render.debug_draw import draw_lines

    dl = _random_lines(cuda_device)
    view, proj = _overlay_camera(cuda_device)
    frame = torch.rand(360, 640, 3, generator=torch.Generator().manual_seed(
        1)).to(cuda_device)
    a = draw_lines(frame, dl, view, proj)
    b = draw_lines(frame, dl, view, proj)
    ref = draw_lines(frame.cpu(), type(dl)(*(x.cpu() for x in dl)),
                     view.cpu(), proj.cpu())
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), ref)
    assert int((a != frame).any(-1).sum()) > 1000


@pytest.mark.cuda
def test_ui_compose_and_draw_lines_make_no_host_sync_on_card(cuda_device):
    """The composite of a menu, an osd and text quads (ui_compose: one
    upload of the call's bitmaps from pinned memory) and of 400 debug
    lines makes no synchronizing CUDA call (sync-debug "error")."""
    from clap_tpu_torch.render.debug_draw import draw_lines
    from clap_tpu_torch.render.ui import (Menu, MenuItem, UiElement,
                                          osd, ui_compose, ui_layout)

    menu = Menu([MenuItem("RESUME"), MenuItem("SETTINGS", items=[]),
                 MenuItem("QUIT")], 640, 360)
    quads = menu.quads + ui_layout([osd("HELLO 42"), UiElement(
        x=600, y=340, w=120, h=40, text="CLIPPED", text_scale=1)], 640, 360)
    dl = _random_lines(cuda_device)
    view, proj = _overlay_camera(cuda_device)
    frame = torch.rand(360, 640, 3, device=cuda_device)
    ui_compose(frame, quads)
    draw_lines(frame, dl, view, proj)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = draw_lines(ui_compose(frame, quads), dl, view, proj)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = draw_lines(ui_compose(frame.cpu(), quads),
                     type(dl)(*(x.cpu() for x in dl)), view.cpu(),
                     proj.cpu())
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
def test_overlay_over_the_engine_frame_on_card(cuda_device):
    """chip_smoke.py phase 17 (a)'s overlay over 3 frames of the graphics
    Engine (1 env × 640 × 360): the card's composite equals the CPU
    composite of the same frame, quads and lines bit for bit, and the UI
    draws only inside its quads."""
    import chip_smoke as CS
    from clap_tpu_torch.render.ui import ui_compose

    _, eng = _demo_engine(cuda_device)
    ui = CS.overlay_ui(eng)
    boxes = CS.overlay_boxes(eng)
    for f in range(3):
        eng.frame()
        frame = eng.last_frame
        quads, dl, view, proj = CS.overlay_layout(ui, eng, f, boxes)
        out = CS.overlay(frame, quads, dl, view, proj)
        ref = CS.overlay(frame.cpu(), quads, CS.to_device(dl, "cpu"),
                         view.cpu(), proj.cpu())
        assert torch.equal(out.cpu(), ref)
        changed = (ui_compose(frame, quads) != frame).any(-1)
        inside = CS.quad_mask(quads, 360, 640, cuda_device)
        assert bool(changed.any()) and not bool((changed & ~inside).any())


@pytest.mark.cuda
def test_flythrough_frame_matches_cpu_on_card(cuda_device):
    """The flythrough demo's frame after 20 sim frames at 640 × 360 on the
    card against the same state rendered on the CPU: PSNR >= 35 dB, as
    the other frame paths."""
    import chip_smoke as CS
    from clap_tpu_torch.demo import flythrough as F

    w = F.build_world(cuda_device)
    for _ in range(20):
        w["st"] = F.sim_step(w, w["st"])
    img = F.render(w, w["st"], 1.0)[0]
    cw = CS.to_device(w, "cpu")
    ref = F.render(cw, cw["st"], 1.0)[0]
    mse = float(((img.cpu() - ref) ** 2).mean())
    assert 10 * math.log10(1.0 / max(mse, 1e-12)) >= 35.0
    assert float(img.std()) > 0.01


@pytest.mark.cuda
def test_sharded_composed_frame_equals_unsharded_on_card(cuda_device):
    """dryrun_multichip on a 4-entry mesh of one card (the small testbed,
    2 envs a shard): state and frames bit-equal to the same world stepped
    unsharded, one K1 and one K2 launch per shard."""
    from clap_tpu_torch.bridge import tree_leaves
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.parallel.multichip import (dryrun_multichip,
                                                   multichip_world)

    before = (R.raster_tile.launches, R.raster_depth.launches)
    gs, mean, frames = dryrun_multichip(4, devices=[cuda_device] * 4)
    torch.cuda.synchronize()
    assert (R.raster_tile.launches - before[0],
            R.raster_depth.launches - before[1]) == (4, 4)
    w = multichip_world(8, cuda_device)
    gs_u, frames_u = step_and_render(w["gw"], w["renderer"], w["gs"],
                                     w["ins"])
    assert frames.is_cuda and torch.equal(frames, frames_u)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(gs),
                                                  tree_leaves(gs_u)))
    assert abs(float(mean) - float(frames_u.double().mean())) \
        <= 1e-6 * abs(float(mean))


@pytest.mark.cuda
def test_distinct_envs_match_cpu_on_card(cuda_device):
    """chip_smoke.py phase 5's inputs (each env its own walk, jump and
    camera turn) at 4 envs × 256² for 4 frames on the card: every env's
    walker elsewhere, the first and last env's images differ, and each
    env's last frame against the same state on the plain CPU path (PSNR
    >= 35 dB)."""
    import chip_smoke as CS

    w = CS.build_slice(cuda_device, 4)
    d = CS.drive_frames(w, torch.cuda.synchronize, CS.require, frames=3)
    psnr = CS.cpu_psnr(w, d)
    assert len(psnr) == 4 and min(psnr) >= 35.0
    assert not torch.equal(d["imgs"][0], d["imgs"][-1])


@pytest.mark.cuda
def test_normal_maps_and_material_fbm_match_cpu_on_card(cuda_device):
    """chip_smoke.py phase 8b at 2 envs: the textured frame with normal-map
    layers (tangent-space TBN) and material fBm through the gather path on
    the card against the CPU (PSNR >= 35 dB per env). On the pixels each
    feature moves by chip_smoke.FEATURE_RMS RMS in the CPU's frame, the
    card's frame is >= 35 dB from the CPU's and the card's frame without
    that feature < 35 dB."""
    import chip_smoke as CS

    t = CS.tbn_fbm_frames(cuda_device, 2)
    assert t["launches"]["raster_tile"] == 1
    img, cpu = t["img"].cpu(), t["cpu"]
    assert bool(torch.isfinite(img).all())
    assert min(CS.env_psnr(img, cpu)) >= 35.0
    for off in ("no_normals", "no_fbm"):
        moved = ((cpu - t["cpu_" + off]) ** 2).mean(-1).sqrt() \
            >= CS.FEATURE_RMS
        assert bool(moved.reshape(2, -1).any(1).all())
        assert min(CS.env_psnr(img, cpu, moved)) >= 35.0
        assert max(CS.env_psnr(t[off].cpu(), cpu, moved)) < 35.0


@pytest.mark.cuda
def test_bench_kernel_parity_on_card(cuda_device):
    """chip_smoke.py phase 19 (a): ``bench_torch.py --config kernel_parity``
    in its own process is true (K3, K1, K2 bit-exact against their plain
    versions; K1 against raster_brute at bench.py's bar) and launched each
    kernel."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    from clap_tpu_torch.bench import _CHILD_MARK

    repo = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, str(repo / "bench_torch.py"),
                        "--config", "kernel_parity"], cwd=repo,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    marked = [json.loads(ln[len(_CHILD_MARK):]) for ln in
              r.stdout.splitlines() if ln.startswith(_CHILD_MARK)]
    assert len(marked) == 1 and marked[0]["result"] is True
    assert all(v > 0 for v in marked[0]["launches"].values())
