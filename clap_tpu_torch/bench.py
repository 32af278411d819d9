"""The JAX bench (bench.py) on the port: its twelve configurations, their
metric names, its JSON line and its survivable harness, on one CUDA card.

    python3 bench_torch.py                  # every config, on the card
    python3 bench_torch.py --device cpu     # bench.py's non-TPU rows, CPU
    python3 bench_torch.py --config KEY     # one config: one marked line

Each ``bench_*`` function is its bench.py namesake: the same scene, sizes,
warm-up, repetitions and metric names, the nudged-camera
``input_dependent`` guard, the ``clusters_at_cap`` / ``bin_stats`` honesty
fields, the luma reduce that keeps the render live and the environment
switches ``KERNEL_ATTRS``, ``CLUSTER_REC``, ``SKIN``, ``STATIC_SHADOW`` and
``LOD_SCALE`` (defaults as bench.py's). A wall is a host clock around
synchronised work (``torch.cuda.synchronize`` where bench.py blocks). Beside
each wall sits ``device_busy_ms``: the median (and range) of ``BUSY_REPS``
profiled calls made after the timed ones, the summed time of the call's
kernels, copies and fills (``device_busy_ms``); walls move with the host
between runs, device busy does not. On the CPU it is null: not measured.

The harness is bench.py:807-1011's: one subprocess per config
(``bench_torch.py --config KEY`` prints one ``BENCHCFG `` line); a deadline
of twice the config's estimate, clipped to the budget; a governor
(``BENCH_BUDGET_S``, default 1,500 s) that skips a config whose estimate
exceeds what is left, the headline exempt; the merged JSON line printed
after every config and mirrored to ``bench_out/BENCH_TORCH_PARTIAL.json``;
SIGTERM, SIGINT and atexit handlers that print it once more. The line keeps
bench.py's keys and adds ``device`` (name, power limit, count). There is no
fallback: with no card and no ``--device cpu`` the run prints its line with
the error and exits 2, and a kernel that fails to build or launch fails its
config.

The scene builders and the device busy reader here are also
chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import atexit
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "bench_torch.py"
MIRROR = REPO / "bench_out" / "BENCH_TORCH_PARTIAL.json"
BUDGET_S = 1500.0     # BENCH_r05 was killed by SIGTERM near 1,800 s
BUSY_REPS = 3         # profiled calls after the timed ones
N_SLICE = 64          # the flagship's envs on the card
RES = 256             # and its square frame
TARGET = 4096 * 60.0  # north star: 4,096 envs at 60 Hz (BASELINE.json)
_CHILD_MARK = "BENCHCFG "


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the card and the device busy reader
# ---------------------------------------------------------------------------

def smi_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()


def setup_card():
    """Card 0 made current, float32 products at full precision (TF32 off):
    (device, the nvidia-smi line of the card's name and power limit)."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision")
    require(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul off")
    return dev, smi


def device_busy_ops(fn):
    """The card's busy ms in one call of ``fn()`` and its number of device
    operations (kernels, copies, fills): (ms, ops). The ms are the summed
    time of the call's kernels, copies and fills under torch.profiler
    (CUDA activity), read from its raw events (the same sum as
    ``key_averages()``, which takes 10-20 s to build for the 54,000 kernels
    of a level frame; chip_smoke.py's ``check_device_busy`` holds the two
    equal). A frame queues more kernels than the launch queue
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


def median(ms):
    return sorted(ms)[len(ms) // 2]


def busy_fields(fn, dev, prefix=""):
    """``device_busy_ms`` beside a wall: the median and range of
    ``BUSY_REPS`` profiled calls of ``fn()`` on the card, made after the
    timed ones; None on the CPU (not measured)."""
    if torch.device(dev).type != "cuda":
        return {f"{prefix}device_busy_ms": None}
    ms = [device_busy_ms(fn) for _ in range(BUSY_REPS)]
    return {f"{prefix}device_busy_ms": median(ms),
            f"{prefix}device_busy_ms_range": [min(ms), max(ms)]}


# ---------------------------------------------------------------------------
# the scenes (bench.py's, shared with chip_smoke.py)
# ---------------------------------------------------------------------------

def parity_scene(W, H, dev):
    """kernel_parity_check's terrain (bench.py:781-792) as records of one
    env at W × H: (rec, ok)."""
    from . import mathx as mx
    from .render import raster as R
    from .scene.terrain import terrain_init_square_landscape

    t = terrain_init_square_landscape(5, -8.0, 0.0, -8.0, 16.0, 24)
    verts = torch.as_tensor(t.vx, device=dev)
    faces = torch.as_tensor(t.idx.reshape(-1, 3).astype(np.int32),
                            device=dev)
    view = mx.mat4_look_at(torch.tensor([6.0, 6.0, 6.0], device=dev),
                           torch.zeros(3, device=dev),
                           torch.tensor([0.0, 1.0, 0.0], device=dev))
    proj = mx.mat4_perspective(math.pi / 3, W / H, 0.1, 50.0, device=dev)
    clip = torch.cat([verts, torch.ones_like(verts[:, :1])], -1) \
        @ (proj @ view).T
    return R.assemble_tri_records(
        *R.project_to_screen(clip[None], W, H), faces,
        torch.ones((1, faces.shape[0]), dtype=torch.bool, device=dev))


def headless_world(n_envs, device=None):
    """bench.py:144-156's headless scene: the testbed (seed 42, 64 m, 128²
    terrain verts, 8 dynamic bodies, 64 entities) at ``n_envs`` envs, the
    one character walking along +x: (scene config, state, inputs)."""
    from .scene import testbed as tbm

    dev = resolve_device(device)
    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=64, device=dev)
    return tb.cfg, tbm.replicate_state(tb.state0, n_envs), \
        bench_inputs(n_envs, dev, n_chars=1)


def skinning_rig(n_joints=64, n_verts=4096, device=None):
    """bench.py:88-115's synthetic rig from ``default_rng(0)``: a branching
    ``n_joints`` skeleton, one looping clip (rotation and translation keys
    per joint) and an ``n_verts`` mesh with 4 random bone weights:
    (skeleton, library, (verts, normals, weights, joint indices))."""
    from .anim.clips import PATH_ROTATION, PATH_TRANSLATION, build_library
    from .anim.joints import build_skeleton

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    parent = [-1] + [(i - 1) // 2 for i in range(1, n_joints)]
    invbind = np.tile(np.eye(4, dtype=np.float32), (n_joints, 1, 1))
    base_t = rng.standard_normal((n_joints, 3)).astype(np.float32) * 0.1
    base_r = np.tile(np.array([0, 0, 0, 1], np.float32), (n_joints, 1))
    base_s = np.ones((n_joints, 3), np.float32)
    sk = build_skeleton(parent, invbind, base_t, base_r, base_s, device=dev)
    keys = np.linspace(0, 2.0, 16)

    def qr():
        q = rng.standard_normal((16, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    clip = []
    for j in range(n_joints):
        clip.append((j, PATH_ROTATION, keys, qr()))
        clip.append((j, PATH_TRANSLATION, keys,
                     rng.standard_normal((16, 3)).astype(np.float32) * 0.05))
    lib = build_library([clip], n_joints, device=dev)
    verts = torch.as_tensor(rng.standard_normal((n_verts, 3)),
                            dtype=torch.float32, device=dev)
    normals = verts / torch.linalg.vector_norm(verts, dim=-1, keepdim=True)
    w = rng.random((n_verts, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    ji = rng.integers(0, n_joints, (n_verts, 4))
    return sk, lib, (verts, normals, torch.as_tensor(w, device=dev),
                     torch.as_tensor(ji, dtype=torch.int32, device=dev))


def pose_and_skin(sk, lib, mesh, ts):
    """bench.py:117-125: clip 0 sampled at each instance's time ``ts``
    (B,), its joint matrices, batched LBS of ``mesh``: verts (B, V, 3)."""
    from .anim.clips import sample_pose
    from .anim.joints import joint_matrices
    from .anim.skin import skin_verts_batch

    clips = torch.zeros(ts.shape, dtype=torch.long, device=ts.device)
    jts = joint_matrices(sk, sample_pose(lib, sk.base, clips, ts))
    return skin_verts_batch(jts, *mesh)[0]


def build_slice(dev, n_envs=N_SLICE, textured=False, fbm=False, res=RES,
                skin=True, static=True, kernel_attrs=True):
    """The flagship's world on ``dev``: the composed testbed of
    bench.py:544-625 (2 chars, 4 terrain chunks, 96 entities, record_compact
    8192, raster_cap 2048, one directional light, ``res``² frames) with
    skinned characters (bench.py:565-588) and the game wiring of
    bench.py:546-559 (the terrain a permanent switch, the demo rig on both
    characters), ``n_envs`` envs at their first state, each with its own
    inputs (``slice_inputs``). ``textured``: the textured models and
    textures of the ``step_and_render_textured`` config (bench.py:566-575);
    ``fbm``: material fBm (tests/test_torch_texture.py's parameters) on the
    sphere and terrain models; kernel_attrs holds where the tables allow it,
    as bench.py:620-621 sets it. ``skin``, ``static`` and ``kernel_attrs``
    False are bench.py's ``SKIN=0`` (rigid proxies), ``STATIC_SHADOW=0`` (no
    static split) and ``KERNEL_ATTRS=0``. Returns a dict: tb, ent, rt, cs,
    textures, lights, opts, gw, gs, ins_at (frame -> Inputs), ins (frame
    0's)."""
    from .anim.system import anim_instances_init
    from .engine.game import GameSessionState, GameWorld
    from .engine.gamelogic import game_config_empty, game_state_init
    from .render.pipeline import RenderOptions
    from .render.scenerender import (build_render_tables, default_edge_ids,
                                     kernel_attrs_ok, shadow_static_mask)
    from .scene import testbed as tbm

    tb = tbm.build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                           max_entities=96, n_chars=2, terrain_chunks=4,
                           device=dev)
    ent = tb.cfg.entities
    models = tbm.testbed_models(tb, skinned_chars=skin, textured=textured)
    if fbm:       # the spheres and the terrain chunks (always in view)
        models = [m._replace(mat_fbm=(0.5, 2.0, 0.2, 0.9, 0.0, 0.6))
                  if i == 2 or i >= 4 else m for i, m in enumerate(models)]
    rt = build_render_tables(
        models, ent.model_id, ent.active,
        entity_edge_id=default_edge_ids(ent.active, ent.body_is_char),
        entity_shadow_static=shadow_static_mask(ent) if static else None,
        device=dev)
    cs = tbm.build_testbed_char_skin(tb, models, rt, device=dev) \
        if skin else None
    textures = tbm.testbed_textures(device=dev) if textured else None
    opts = RenderOptions(width=res, height=res, shadow_size=256,
                         film_grain=0.0, record_compact=8192,
                         raster_cap=2048,
                         kernel_attrs=kernel_attrs_ok(rt) and kernel_attrs)
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
                lights=sun_lights(dev), opts=opts, gw=gw, gs=gs,
                ins_at=ins_at, ins=ins_at(0))


def slice_inputs(n_envs, dev):
    """Each env its own inputs, as tests/test_engine.py:46-60 walks its
    envs in different directions: env e's first character walks along
    angle 2 pi e / n_envs and jumps at frame 2 + e % 8, and its camera
    turns at its own yaw rate (-0.03 to 0.03 rad a frame over the envs);
    the second character stands. Returns ``ins_at(frame)`` -> Inputs
    (B, ...): the tensors are made once on ``dev``, and a frame's jump is
    one comparison on the card."""
    from .engine.step import Inputs

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


def make_renderer(w, static, to=None, lod_scale=None, cluster_records=True):
    """The SceneRenderer of a ``build_slice`` world with the baked static
    shadow; ``to="cpu"`` makes a copy of it on the CPU. ``lod_scale``
    defaults to bench.py's ``max(res, 64) / 720`` (``LOD_SCALE``);
    ``cluster_records=False`` is bench.py's ``CLUSTER_REC=0``."""
    from .bridge import tree_map
    from .engine.frame import SceneRenderer

    def mv(t):
        return tree_map(lambda x: x.to(to) if to is not None
                        and torch.is_tensor(x) else x, t)

    if lod_scale is None:
        lod_scale = max(w["opts"].width, 64) / 720.0
    return SceneRenderer(mv(w["rt"]), mv(w["lights"]), w["opts"],
                         skip_culling=mv(w["ent"].skip_culling),
                         static_shadow=mv(static), lod_scale=lod_scale,
                         char_skin=mv(w["cs"]), textures=mv(w["textures"]),
                         cluster_records=cluster_records)


def sun_lights(dev, n=1, color=(1.0, 0.95, 0.9)):
    """``n`` light slots, slot 0 the one directional light of the JAX
    bench's scenes (direction (-0.4, -0.8, -0.4), bench.py:237-244)."""
    from .render.lights import lights_empty

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
    from .scene.primitives import cube

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
    from . import mathx as mx

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
    from . import mathx as mx
    from .render.pipeline import RenderOptions, SceneGeometry
    from .render.raster import (cluster_faces, expand_corners_major,
                                expand_corners_record)
    from .scene.terrain import terrain_init_square_landscape

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
                     bake_size=2048, cap=10240 * 8, cluster_rec=True):
    """The JAX bench's ``full_frame_production`` scene (bench.py:281-366):
    the dense scene as render tables (static terrain entity 0, dynamic
    cube-field entity 1), kernel_attrs where eligible, raster_cap 4096,
    cluster records with ``cap`` records where the tables allow them and
    ``cluster_rec`` (bench.py's ``CLUSTER_REC``; else member geometry), and
    the terrain's static shadow baked at ``bake_size``². Returns a dict: rt,
    lights, opts, cap, cluster_rec, mxs (1, 2, 4, 4), eye (1, 3), proj,
    mx0, bake (s), static_shadow."""
    from . import mathx as mx
    from .render.pipeline import RenderOptions
    from .render.scenerender import (bake_static_shadow, build_render_tables,
                                     kernel_attrs_ok, model_from_mesh)
    from .scene.terrain import terrain_init_square_landscape

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
    _sync(static[0].device)
    bake = time.perf_counter() - t0
    ka = kernel_attrs_ok(rt)
    opts = RenderOptions(width=width, height=height, shadow_size=512,
                         film_grain=0.0, raster_cap=4096, kernel_attrs=ka)
    return dict(rt=rt, lights=lights, opts=opts, cap=cap,
                cluster_rec=bool(ka and rt.cl_rest is not None
                                 and cluster_rec),
                mxs=torch.eye(4, device=dev).repeat(1, 2, 1, 1),
                eye=torch.tensor([[0.0, 18.0, 28.0]], device=dev),
                proj=mx.mat4_perspective(math.pi / 3, width / height, 0.1,
                                         200.0, device=dev),
                mx0=mx0, bake=bake, static_shadow=static)


def production_geometry(w, eyes):
    """bench.py:372-384: the views of ``eyes`` (B, 3) and the production
    tables' cluster records (member geometry without ``cluster_rec``, the
    terrain skipping culling): (geom, views)."""
    from .render.scenerender import (assemble_cluster_records_batch,
                                     assemble_scene_geometry_batch)
    from .render.view import make_subview

    dev = eyes.device
    views = look_at(eyes, [0.0, 2.0, 0.0], dev)
    planes = make_subview(views, w["proj"]).planes
    mxs = w["mxs"].expand(eyes.shape[0], -1, -1, -1)
    vis = torch.ones((eyes.shape[0], 2), dtype=torch.bool, device=dev)
    if w["cluster_rec"]:
        geom = assemble_cluster_records_batch(
            w["rt"], mxs, vis, planes, eyes, views, w["proj"], cap=w["cap"])
    else:
        geom = assemble_scene_geometry_batch(
            w["rt"], mxs, vis, planes, eyes,
            skip_culling=torch.tensor([True, False], device=dev))
    return geom, views


def production_frame(w, eyes):
    """One ``full_frame_production`` frame of ``eyes`` (B, 3)."""
    from .render.pipeline import render_frame_dynamic_batch

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
    from . import mathx as mx
    from .render.pipeline import PER_ENV, RenderOptions
    from .render.scenerender import (assemble_scene_geometry_batch,
                                     build_render_tables, kernel_attrs_ok,
                                     model_from_mesh)
    from .render.view import make_subview
    from .scene.terrain import terrain_init_square_landscape

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


def _switch(name):
    """bench.py's environment switches: on unless set to 0."""
    return bool(int(os.environ.get(name, "1")))


# ---------------------------------------------------------------------------
# the configurations (bench.py:57-804)
# ---------------------------------------------------------------------------

def bench_ca2d(device=None, grid=None, return_grid=False):
    """Config #1: ca2d 256², CA_TEST, 1000 generations (one grid) through
    K3 (``ca2d_run_fused``). ``grid``: the (256, 256) uint8 grid to run
    (numpy or tensor; default seeded from torch's generator 0);
    ``return_grid``: the grid after the warm-up call, untimed."""
    from .ops import ca2d as CA

    dev = resolve_device(device)
    if grid is None:
        grid = CA.ca2d_seed(CA.CA_TEST, (256, 256), device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
    grid = torch.as_tensor(grid, device=dev)

    def run(g):
        return CA.ca2d_run_fused(CA.CA_TEST, g, 1000)

    out = run(grid)
    _sync(dev)
    if return_grid:
        return out.cpu().numpy()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        out = run(grid)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"metric": "ca2d_256_1000steps_ms", "value": dt * 1e3,
            "cell_steps_per_s": 256 * 256 * 1000 / dt,
            **busy_fields(lambda: run(grid), dev)}


def bench_skinning(n_inst: int = 1024, n_joints: int = 64,
                   n_verts: int = 4096, device=None):
    """Config #3: pose sampling + blend + skinning, ``n_inst`` instances
    of bench.py's synthetic rig (``skinning_rig``)."""
    dev = resolve_device(device)
    sk, lib, mesh = skinning_rig(n_joints, n_verts, dev)
    ts = torch.linspace(0.0, 2.0, n_inst, device=dev)
    pose_and_skin(sk, lib, mesh, ts)
    _sync(dev)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        pose_and_skin(sk, lib, mesh, ts)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"metric": "skinning_1024inst_ms", "value": dt * 1e3,
            "skinned_verts_per_s": n_inst * n_verts / dt,
            **busy_fields(lambda: pose_and_skin(sk, lib, mesh, ts), dev)}


def bench_headless(n_envs: int, frames: int = 30, device=None):
    """Configs #2/#4: the headless testbed step (``engine_step``) at
    ``n_envs`` envs: (seconds per frame, busy fields of one frame)."""
    from .engine.step import engine_step

    dev = resolve_device(device)
    cfg, st, ins = headless_world(n_envs, dev)
    st = engine_step(cfg, st, ins)     # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(frames):
        st = engine_step(cfg, st, ins)
    _sync(dev)
    dt = (time.perf_counter() - t0) / frames
    return dt, busy_fields(lambda: engine_step(cfg, st, ins), dev)


def bench_full_frame(width=1280, height=720, nr_v=96, n_cubes=0,
                     raster_cap=0, name="full_frame_720p_ms", device=None):
    """Config #5: full frame — culling + rasterizer + shadow/SSAO/bloom/
    SMAA chain at 720p on a procedural scene (terrain + cubes), the
    hand-built geometry with corner streams (``build_full_frame``); the
    dense variant is nr_v=240, n_cubes=256, raster_cap 4096."""
    from .render import raster as R
    from .render.pipeline import clip_transform, render_frame

    dev = resolve_device(device)
    w = build_full_frame(dev, nr_v, n_cubes, raster_cap, width, height)
    geom, opts, proj, lights = w["geom"], w["opts"], w["proj"], w["lights"]

    def frame(eye, view):
        return render_frame(opts, geom, view, proj, lights, eye)

    img0 = frame(w["eye"], w["view"])
    _sync(dev)
    # the timed frame must depend on its arguments: a nudged camera must
    # change the image (bench.py:250-257)
    eye2 = w["eye"] + torch.tensor([[0.5, 0.0, 0.0]], device=dev)
    img1 = frame(eye2, look_at(eye2, [0.0, 2.0, 0.0], dev))
    depends = bool(((img0 - img1).abs() > 1e-6).any())
    # binning saturation: dropped geometry would flatter the timing
    rec, ok, _, _ = R.clip_near_records(
        clip_transform(geom.verts, w["view"], proj), geom.faces, width,
        height, geom.face_valid)
    bs = R.bin_stats(R.bin_triangles(rec, ok, width, height,
                                     cap=raster_cap or None))
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        frame(w["eye"], w["view"])
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"metric": name, "value": dt * 1e3,
            "fps": 1.0 / dt, "tris": int(geom.faces.shape[0]),
            "input_dependent": depends,
            "tiles_at_cap": bs["tiles_at_cap"],
            "max_per_tile": bs["max_per_tile"],
            **busy_fields(lambda: frame(w["eye"], w["view"]), dev)}


def bench_full_frame_production(width=1280, height=720, nr_v=240,
                                n_cubes=256, device=None):
    """The dense 720p frame through the production content path
    (bench.py:281-420): render tables, kernel_attrs, cluster records
    (``CLUSTER_REC``), the terrain baked once into a 2,048² atlas (cold
    and warm ms) and only the cubes in the per-frame cascades."""
    from .render import raster as R
    from .render.scenerender import bake_static_shadow

    dev = resolve_device(device)
    w = build_production(dev, width, height, nr_v, n_cubes,
                         cluster_rec=_switch("CLUSTER_REC"))
    rt, lights = w["rt"], w["lights"]

    def bake():
        return bake_static_shadow(rt, w["mx0"], lights.direction[0],
                                  shadow_size=2048)

    t_bake = time.perf_counter()
    bake()
    _sync(dev)
    bake_ms = (time.perf_counter() - t_bake) * 1e3
    eye = w["eye"]
    img0 = production_frame(w, eye)
    _sync(dev)
    img1 = production_frame(w, eye + torch.tensor([[0.5, 0.0, 0.0]],
                                                  device=dev))
    depends = bool(((img0 - img1).abs() > 1e-6).any())
    clusters_at_cap = None
    if w["cluster_rec"]:
        g1, _ = production_geometry(w, eye)
        nval = int(g1.comp_valid.sum()) // R.CLUSTER
        clusters_at_cap = bool(nval >= w["cap"] // R.CLUSTER)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        production_frame(w, eye)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    out = {"metric": "full_frame_720p_production_ms", "value": dt * 1e3,
           "fps": 1.0 / dt, "tris": int(rt.faces.shape[0]),
           "kernel_attrs": bool(w["opts"].kernel_attrs),
           "bake_warm_ms": bake_ms, "bake_cold_ms": w["bake"] * 1e3,
           "dyn_shadow_tris": int(rt.shadow_faces.shape[0]),
           "cluster_rec": w["cluster_rec"],
           "clusters_at_cap": clusters_at_cap,
           "input_dependent": depends}
    out.update(busy_fields(lambda: production_frame(w, eye), dev))
    out.update(busy_fields(bake, dev, prefix="bake_"))
    return out


def bench_batched_render(n_envs: int = 64, res: int = 256, device=None):
    """North-star rendering half: ``n_envs`` views × ``res``² of one shared
    scene (``render_frame_batch``, one light atlas)."""
    from .render.pipeline import render_frame_batch

    dev = resolve_device(device)
    w = build_batched(dev, n_envs, res)
    opts = dataclasses.replace(
        w["opts"], kernel_attrs=w["opts"].kernel_attrs
        and _switch("KERNEL_ATTRS"))

    def frame():
        return render_frame_batch(opts, w["geom"], w["views"], w["proj"],
                                  w["lights"], w["eyes"], far=100.0)

    img = frame()
    _sync(dev)
    # content sanity: a blank batch would mean the squeeze broke
    img_std = float(img.std(correction=0))
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        frame()
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return {"metric": f"batched_render_{n_envs}x{res}_ms",
            "value": dt * 1e3, "frames_per_s": n_envs / dt,
            "kernel_attrs": bool(opts.kernel_attrs), "img_std": img_std,
            **busy_fields(frame, dev)}


def bench_inputs(n_envs, dev, n_chars=2):
    """bench.py's inputs (bench.py:146-147, 688-691): every env's first
    character walks along +x, the others stand."""
    from .bridge import tree_map
    from .engine.step import inputs_zero

    ins = tree_map(lambda x: x.expand(n_envs, *x.shape).clone(),
                   inputs_zero(n_chars, device=dev))
    ins.motion[:, 0, 0] = 1.0
    return ins


def bench_step_and_render(n_envs: int = 64, res: int = 256,
                          frames: int = 10, chunk: int = 64,
                          internal_scale: int = 1,
                          return_images: bool = False,
                          textured: bool = False, device=None):
    """THE north-star composition (bench.py:500-736): the batched
    ``game_step`` (sim, rules, rig animation), then every env's skinned
    cluster records and composed frame (per-env CSM shadows over the baked
    static atlas, SSAO on) at ``res``², through ``step_and_render``; envs
    beyond ``chunk`` render ``chunk`` at a time (each chunk's G-buffers
    freed before the next). Returns the frames (numpy) after the warm-up
    with ``return_images``, else bench.py's dict."""
    from .bridge import tree_map
    from .engine.frame import step_and_render
    from .engine.game import game_step
    from .render import raster as R
    from .render.scenerender import (assemble_cluster_records_batch,
                                     bake_static_shadow)
    from .render.view import make_subview

    dev = resolve_device(device)
    static_on = _switch("STATIC_SHADOW")
    w = build_slice(dev, n_envs, textured=textured, res=res,
                    skin=_switch("SKIN"), static=static_on,
                    kernel_attrs=_switch("KERNEL_ATTRS"))
    w["opts"] = dataclasses.replace(w["opts"], internal_scale=internal_scale)
    rt, gw = w["rt"], w["gw"]
    static = None
    if static_on and rt.static_shadow_faces is not None \
            and rt.static_shadow_faces.shape[0] > 0:
        static = bake_static_shadow(rt, w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
    # constant screen-space-error LOD, keyed on the output resolution
    lod_scale = float(os.environ.get("LOD_SCALE", max(res, 64) / 720.0))
    renderer = make_renderer(w, static, lod_scale=lod_scale,
                             cluster_records=_switch("CLUSTER_REC"))
    ins = bench_inputs(n_envs, dev)

    def reduce(imgs):
        # luma mean per env: the reduce keeps all render work live
        return imgs if return_images else imgs.mean(dim=(1, 2, 3))

    def frame(gs):
        if n_envs <= chunk:
            gs, imgs = step_and_render(gw, renderer, gs, ins)
            return gs, reduce(imgs)
        gs = game_step(gw, gs, ins)
        out = [reduce(renderer(tree_map(lambda x: x[c:c + chunk],
                                        gs.engine),
                               gs.joint_mats[c:c + chunk]))
               for c in range(0, n_envs, chunk)]
        return gs, torch.cat(out)

    gs, out = frame(w["gs"])
    _sync(dev)
    clusters_at_cap = None
    if renderer.cluster_records:
        # compaction-cap honesty: saturated validity would mean valid
        # clusters were dropped (env 0, the rigid records)
        st1 = tree_map(lambda x: x[:1], gs.engine)
        v1 = renderer.views(st1)
        g1 = assemble_cluster_records_batch(
            renderer.rt, st1.mx, st1.visible,
            make_subview(v1, renderer.proj).planes, st1.camera.pos, v1,
            renderer.proj, cap=renderer.opts.record_compact,
            skip_culling=renderer.skip_culling, lod_scale=lod_scale)
        nval = int(g1.comp_valid.sum()) // R.CLUSTER
        clusters_at_cap = bool(nval >= renderer.opts.record_compact
                               // R.CLUSTER)
    if return_images:
        return out.cpu().numpy()
    luma = out
    t0 = time.perf_counter()
    for _ in range(frames):
        gs, luma = frame(gs)
    _sync(dev)
    dt = (time.perf_counter() - t0) / frames
    tag = f"_s{internal_scale}" if internal_scale > 1 else ""
    if textured:
        tag += "_tex"
    res_d = {"metric": f"step_and_render_{n_envs}x{res}{tag}_ms",
             "value": dt * 1e3, "env_fps": n_envs / dt,
             "kernel_attrs": bool(renderer.opts.kernel_attrs),
             "lod_scale": round(lod_scale, 4),
             "mean_luma": float(luma[0])}
    if clusters_at_cap is not None:
        res_d["clusters_at_cap"] = clusters_at_cap
    res_d.update(busy_fields(lambda: frame(gs), dev))
    return res_d


def bench_shading_rate(res: int = 256, scales=(2,), device=None):
    """The internal-resolution lever's quality cost: PSNR of the composed
    frame at each internal scale against the full-resolution frame (8
    envs, the same state after one step)."""
    ref = bench_step_and_render(n_envs=8, res=res, return_images=True,
                                device=device)
    out = {}
    for s in scales:
        img = bench_step_and_render(n_envs=8, res=res, internal_scale=s,
                                    return_images=True, device=device)
        mse = float(np.mean((img - ref) ** 2))
        out[str(s)] = {"psnr_db": 10.0 * float(np.log10(
            1.0 / max(mse, 1e-12)))}
    return out


def kernel_parity_check(device=None):
    """The kernels against their plain versions on the card (the CPU
    tests run the plain versions only): K3 ``ca2d_run_fused`` equals
    ``ca2d_run`` bit for bit on a 64² grid for 32 generations; on
    bench.py's 128² terrain scene K1 ``raster_tile`` and K2 ``raster_depth``
    are each bit-exact against their plain versions, and K1 meets bench.py's
    bar against ``raster_brute``: tid agreement above 0.995, depth within
    1e-4 where the ids agree. True only if all of it holds."""
    from .ops import ca2d as CA
    from .render import raster as R

    dev = resolve_device(device)
    g = CA.ca2d_seed(CA.CA_TEST, (64, 64), device=dev,
                     generator=torch.Generator(dev).manual_seed(3))
    ok = torch.equal(CA.ca2d_run_fused(CA.CA_TEST, g, 32),
                     CA.ca2d_run(CA.CA_TEST, g, 32))
    W = H = 128
    rec, okm = parity_scene(W, H, dev)
    binned = R.bin_triangles(rec, okm, W, H)
    args = R.kernel_inputs(rec, binned, W, H)
    k = R.raster_tile(*args)
    ok &= all(torch.equal(a, b) for a, b in zip(k, R.raster_tile_ref(*args)))
    dargs = R.kernel_inputs(rec, binned, W, H, depth_only=True)
    ok &= torch.equal(R.raster_depth(*dargs), R.raster_depth_ref(*dargs))
    brute = R.raster_brute(rec[0], okm[0], W, H)
    tid = k[1][0, :H, :W].long()
    same = tid == brute.tri_id.long()
    # a sliver of edge pixels may disagree (coefficients vs direct
    # evaluation)
    ok &= float(same.float().mean()) > 0.995
    hit = same & (tid >= 0)
    ok &= torch.allclose(k[0][0, :H, :W][hit], brute.depth[hit], atol=1e-4)
    return bool(ok)


# ---------------------------------------------------------------------------
# the survivable harness (bench.py:807-1011)
# ---------------------------------------------------------------------------

def run_headless(backend):
    """Headline: headless single + batched env-steps/s. Returns the
    config's result with its ``headline`` (the line's top-level fields
    and the sub keys of bench.py)."""
    device = _device_of(backend)
    sub = {}
    dt1, busy1 = bench_headless(1, device=device)
    sub["headless_single_ms"] = dt1 * 1e3
    sub.update({f"headless_single_{k}": v for k, v in busy1.items()})
    n_envs = 4096 if backend == "gpu" else 64
    dtN, busyN = bench_headless(n_envs, device=device)
    env_steps_per_s = n_envs / dtN
    sub[f"headless_{n_envs}_ms_per_frame"] = dtN * 1e3
    sub.update({f"headless_{n_envs}_{k}": v for k, v in busyN.items()})
    return {"env_steps_per_s": round(env_steps_per_s, 1),
            "headline": {"value": round(env_steps_per_s, 1),
                         "vs_baseline": round(env_steps_per_s / TARGET, 4),
                         "n_envs": n_envs, "sub": sub}}


def run_shading_rate(device=None):
    rate = bench_shading_rate(device=device)
    for s in (2,):
        r = bench_step_and_render(n_envs=64, internal_scale=s, device=device)
        rate[str(s)].update({k: r[k] for k in ("value", "env_fps")
                             + tuple(k for k in r if "busy" in k)})
    return rate


def _device_of(backend):
    return None if backend == "gpu" else "cpu"


def _configs(backend):
    """(key, cost estimate s, thunk), bench.py's keys in its order: the
    card ("gpu") runs the rows of bench.py's TPU branch at its sizes, the
    CPU its other rows. Each estimate is the card's own seconds: the
    config's ``took_s`` (its child process from start to result) in the
    slowest of the whole ``bench_torch.py`` runs on an NVIDIA H100 80GB HBM3
    at 700 W, rounded up; the hosts' pace moved it up to 1.8 times between
    runs (headless 23.7-48.8 s, ca2d 14.1-26.2), and the deadline is twice
    it."""
    on_card = backend == "gpu"
    dev = _device_of(backend)
    n_sr = 64 if on_card else 8
    configs = [
        ("headless", 49, lambda: run_headless(backend)),
        ("ca2d", 27, lambda: bench_ca2d(device=dev)),
        ("skinning", 26, lambda: bench_skinning(device=dev)),
        ("step_and_render", 41, lambda: {
            str(n_sr): bench_step_and_render(n_envs=n_sr, device=dev)}),
        ("full_frame_dense", 28, lambda: bench_full_frame(
            nr_v=240, n_cubes=256, raster_cap=4096,
            name="full_frame_720p_dense_ms", device=dev)),
        ("full_frame_production", 29,
         lambda: bench_full_frame_production(device=dev)),
        ("kernel_parity", 21, lambda: kernel_parity_check(device=dev)),
        ("batched_render", 26, lambda: bench_batched_render(device=dev)),
        ("full_frame", 26, lambda: bench_full_frame(device=dev)),
    ]
    if on_card:
        configs += [
            ("step_and_render_textured", 36, lambda: {
                "64tex": bench_step_and_render(n_envs=64, textured=True)}),
            ("shading_rate", 40, run_shading_rate),
            ("step_and_render_256", 38,
             lambda: {"256": bench_step_and_render(n_envs=256)}),
        ]
    return configs


def _records(res):
    """The record dicts of a config's result: the dict itself, or each of
    its dict values for the keyed rows (step_and_render, shading_rate)."""
    if not isinstance(res, dict):
        return []
    inner = [v for v in res.values() if isinstance(v, dict)]
    return inner if inner and len(inner) == len(res) else [res]


def child_main(key, device=None):
    """``--config KEY``: run one config and print its result as a marked
    JSON line, with the kernel launches counted from 0 over the run and,
    on the card, its peak device memory (also in each record)."""
    from .ops.ca2d import ca2d_run_fused
    from .render import raster as R

    backend = "cpu" if device == "cpu" else "gpu"
    for k, _est, thunk in _configs(backend):
        if k != key:
            continue
        if backend == "gpu":
            from . import cuda_build

            setup_card()
            cuda_build.build_all()
            log(f"{key}: kernels " + ", ".join(
                f"{n} {'found built' if i['seconds'] == 0 else 'built'}"
                for n, i in cuda_build.build_info.items()))
            torch.cuda.reset_peak_memory_stats()
        kernels = (R.raster_tile, R.raster_depth, ca2d_run_fused)
        for fn in kernels:
            fn.launches = 0
        try:
            res = thunk()
        except Exception as e:     # the config fails; the line says how
            traceback.print_exc()
            res = {"error": f"{type(e).__name__}: {e}"[:300]}
        headline = res.pop("headline", None) if isinstance(res, dict) \
            else None
        extra = {"launches": {fn.__name__: fn.launches for fn in kernels}}
        if backend == "gpu":
            extra["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            log(f"{key}: peak device memory {extra['peak_mem_gib']:.3f} GiB")
        for r in _records(res):
            r.update(extra)
        print(_CHILD_MARK + json.dumps(
            {"result": res, "headline": headline, **extra}), flush=True)
        return 0
    print(_CHILD_MARK + json.dumps(
        {"result": {"error": f"unknown config {key}"}}), flush=True)
    return 2


class Harness:
    """bench.py's survivable harness around child processes: the merged
    line (``results``), its emission and mirror, the signal and exit
    handlers, and the run over the configs."""

    def __init__(self, backend, budget, mirror=MIRROR):
        self.t0 = time.perf_counter()
        self.mirror = Path(mirror)
        self.proc = None          # the running child
        self.done = False
        self.results = {
            "metric": "batched env sim-steps/sec/chip (testbed scene, "
                      "headless)",
            "value": 0.0, "unit": "env-steps/s", "vs_baseline": 0.0,
            "backend": backend, "n_envs": 0, "final": False, "sub": {},
            "budget_s": budget, "device": None}

    def emit(self, final=False):
        """Print the merged snapshot as one JSON line and mirror it: the
        last parseable line of stdout is always the freshest snapshot."""
        self.results["final"] = bool(final)
        self.results["elapsed_s"] = round(time.perf_counter() - self.t0, 1)
        line = json.dumps(self.results)
        print(line, flush=True)
        try:
            self.mirror.parent.mkdir(parents=True, exist_ok=True)
            self.mirror.write_text(line + "\n")
        except OSError:
            pass

    def finish(self, final=True):
        self.emit(final)
        self.done = True

    def _on_signal(self, signum, frame):  # pragma: no cover - signal path
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.results["killed_by_signal"] = int(signum)
        self.emit(final=False)
        os._exit(1)

    def install(self):
        signal.signal(signal.SIGTERM, self._on_signal)
        signal.signal(signal.SIGINT, self._on_signal)
        atexit.register(lambda: None if self.done else self.emit(False))

    def _child(self, cmd, deadline):
        """Run one child to its deadline: (its envelope or None, its stdout
        lines other than the marked one, timed out)."""
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE)
        try:
            stdout, _ = self.proc.communicate(timeout=max(deadline, 0.0))
            timed_out = False
        except subprocess.TimeoutExpired:
            self.proc.kill()
            stdout, _ = self.proc.communicate()
            timed_out = True
        finally:
            rc, self.proc = self.proc.returncode, None
        out, lines = None, []
        for ln in stdout.decode(errors="replace").splitlines():
            if ln.startswith(_CHILD_MARK):
                out = json.loads(ln[len(_CHILD_MARK):])
            else:
                lines.append(ln)
        if out is None and not timed_out:
            out = {"result": {"error": f"child rc={rc}, no result"}}
        return out, lines, timed_out

    def run(self, configs, command):
        """Each config in its own child (``command(key)`` is its argv),
        governed by the budget, the line emitted after each."""
        budget = self.results["budget_s"]
        sub = self.results["sub"]
        for i, (key, est, _thunk) in enumerate(configs):
            remaining = budget - (time.perf_counter() - self.t0)
            # the headline config is exempt from the governor: a bench
            # artifact without the north-star number is not an artifact
            if i > 0 and est > remaining:
                sub[key] = {"skipped": "budget", "est_s": est,
                            "remaining_s": round(remaining, 1)}
                continue
            deadline = remaining if i == 0 else min(2.0 * est, remaining)
            t0 = time.perf_counter()
            try:
                out, lines, timed_out = self._child(command(key), deadline)
            except (OSError, ValueError) as e:
                out, lines, timed_out = {"result": {"error": str(e)[:300]}}, \
                    [], False
            for ln in lines:
                log(f"[{key}] {ln}")
            if timed_out:
                out = {"result": {"skipped": "config-timeout",
                                  "deadline_s": round(deadline, 1)}}
            took = round(time.perf_counter() - t0, 1)
            log(f"[{key}] took_s {took}")
            res = out.get("result")
            if out.get("headline"):
                for f in ("value", "vs_baseline", "n_envs"):
                    self.results[f] = out["headline"][f]
                sub.update(out["headline"]["sub"])
            if key.startswith("step_and_render") and isinstance(res, dict) \
                    and "error" not in res and "skipped" not in res:
                sub.setdefault("step_and_render", {}).update(res)
                sub["step_and_render"]["took_s"] = took
            else:
                sub[key] = res
                if isinstance(res, dict):
                    res["took_s"] = took
            self.emit(final=False)


def device_info():
    """The card the line names: (``{"name", "power_limit_w", "count"}``,
    the nvidia-smi line)."""
    smi = smi_line()
    watts = smi.rsplit(",", 1)[-1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(0),
            "power_limit_w": float(watts),
            "count": torch.cuda.device_count()}, smi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bench_torch.py", description="The JAX bench's configurations "
        "on the PyTorch port, one JSON line (on the card unless --device "
        "cpu).")
    ap.add_argument("--config", help="run one config in this process")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    device = "cpu" if a.device == "cpu" else None
    if a.config:
        return child_main(a.config, device)
    backend = "cpu" if device == "cpu" else "gpu"
    h = Harness(backend, float(os.environ.get("BENCH_BUDGET_S", BUDGET_S)))
    h.install()
    if backend == "gpu":
        if not torch.cuda.is_available():
            h.results["error"] = ("no CUDA card (torch.cuda.is_available() "
                                  "is false): the bench measures on the "
                                  "card; pass --device cpu for the CPU rows")
            h.finish(final=False)
            print(h.results["error"], file=sys.stderr)
            return 2
        from . import cuda_build

        h.results["device"], smi = device_info()
        log(smi)
        try:
            t0 = time.perf_counter()
            cuda_build.build_all()
            log(f"kernels built in {time.perf_counter() - t0:.1f} s")
        except (RuntimeError, OSError) as e:
            h.results["error"] = f"kernel build failed: {str(e)[:300]}"
            h.finish(final=False)
            return 1
    else:
        h.results["device"] = {"name": "cpu", "power_limit_w": None,
                               "count": 0}
    extra = ["--device", "cpu"] if backend == "cpu" else []
    h.run(_configs(backend), lambda key: [sys.executable, str(SCRIPT),
                                          "--config", key, *extra])
    h.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
