"""Testbed demo (counterpart of demo/testbed.py) — the ldjam56
"onehandclap" analogue (demo/ldjam56/onehandclap.c): full-feature config,
procedural terrain scene, fuzzer hookup, optional frame dump.

Usage:
  python -m clap_tpu_torch.demo.testbed [-e SECONDS] [--fuzzer] [--render]
      [--frames N] [--envs N] [--dump DIR] [--serve PORT] [--device DEV]

Runs on the CUDA card unless ``--device`` names another device.
``build_world`` makes the demo's scene, game and graphics wiring, once
for the demo and for every other caller (chip_smoke.py's game frame).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

# the demo's scene: the headline testbed (demo/testbed.py:42-43)
SCENE = dict(seed=42, side=64.0, nr_v=128, n_dynamic=8, max_entities=64)


def demo_textures():
    """The procedural texture set (the assets ship textures via glTF —
    scene/content.py — but the testbed is asset-less): layer 0 checker
    for characters, layer 1 bark for trees, layer 2 the terrain's 2×2
    atlas — grass quadrant at [0,.5)², rock at +0.5 — blended by slope in
    the shader (terrain.frag:39-46). Returns (diffuse (3, 32, 32, 3),
    slope_blend (3,)) as numpy arrays."""
    checker = np.zeros((32, 32, 3), np.float32) + 0.55
    checker[::2, ::2] = (0.95, 0.55, 0.35)
    checker[1::2, 1::2] = (0.95, 0.55, 0.35)
    bark = np.zeros((32, 32, 3), np.float32)
    bark[:] = (0.45, 0.33, 0.2)
    bark[:, ::4] = (0.3, 0.2, 0.12)
    rng = np.random.default_rng(7)
    atlas = np.zeros((32, 32, 3), np.float32)
    gnoise = rng.uniform(0.85, 1.15, (16, 16, 1)).astype(np.float32)
    atlas[:16, :16] = np.array([0.30, 0.52, 0.22]) * gnoise
    rnoise = rng.uniform(0.8, 1.2, (16, 16, 1)).astype(np.float32)
    atlas[16:, 16:] = np.array([0.45, 0.43, 0.40]) * rnoise
    # fill the two unused quadrants with each tile's tone so the
    # wrap-bilinear fetch at quadrant edges doesn't bleed black
    # gridlines into the tiled terrain
    atlas[:16, 16:] = atlas[:16, :16]
    atlas[16:, :16] = atlas[16:, 16:]
    return np.stack([checker, bark, atlas]), np.array([False, False, True])


def _cube_mesh(w, h):
    from ..scene.primitives import cube

    v, n, _uv, f = cube(1.0)
    v = v * np.array([w, h, w], np.float32) + np.array([0, h / 2, 0],
                                                       np.float32)
    return v, n, f


def build_world(device=None, render: bool = True, width: int = 640,
                height: int = 360, scene=None, seed: int = 3,
                footsteps: bool = False) -> dict:
    """The demo's world on ``device`` (the card unless named). ``scene``
    overrides build_testbed's arguments (SCENE). ``footsteps``: the rigs'
    motion clip fires footstep events (the per-clip SFX table of
    demo/platformer.py:56-67), for ``Engine.attach_sound``.

    ``render`` False: the headless testbed (one character); a dict of tb.

    ``render`` True (demo/testbed.py:62-191, ``--render``): the full
    composed game — 2 characters, each with the demo rig, the terrain a
    permanent switch, two spore systems of 256 live particles around the
    characters (radius 1.6, velocity 0.015; ``seed`` seeds their spawn) —
    and its graphics: the four models (the terrain one unchunked textured
    entity, skinned textured ring-column characters, cubes, textured
    trees), the three textures, the static shadow split, one sun, film
    grain on the default blue noise, particle size 0.1 and colour (0.95,
    0.9, 0.5), ``width`` × ``height`` with 256² cascades. A dict of tb,
    gw (GameWorld), session0 (unbatched GameSessionState), rt, cs,
    textures, lights, opts and graphics (Engine.attach_graphics's
    arguments but out_dir)."""
    from ..anim.system import anim_instances_init, anim_sfx_from_names
    from ..device import resolve_device
    from ..engine.game import GameSessionState, GameWorld
    from ..engine.gamelogic import game_config_empty, game_state_init
    from ..ops.noise import blue_noise2d
    from ..ops.particles import (PARTICLES_MAX, ParticleParams,
                                 particles_init)
    from ..render.lights import lights_empty
    from ..render.pipeline import RenderOptions, TextureSets
    from ..render.scenerender import (build_render_tables, default_edge_ids,
                                      model_from_mesh, shadow_static_mask)
    from ..scene import testbed as tbm
    from ..scene.primitives import cube

    dev = resolve_device(device)
    kw = dict(SCENE, **(scene or {}))
    if not render:
        return dict(tb=tbm.build_testbed(**kw, device=dev))
    # full composed game step: 2-character roster, each with its own
    # animated rig, live particle systems, rendered INSIDE Engine.frame
    tb = tbm.build_testbed(**kw, n_chars=2, device=dev)
    ent = tb.cfg.entities
    sk, lib, acfg = tbm.build_demo_rig(device=dev)
    gcfg = game_config_empty(1, ent.active.shape[0], device=dev)._replace(
        switch_entity=torch.tensor([0], dtype=torch.int32, device=dev),
        switch_valid=torch.tensor([True], device=dev),
        switch_permanent=torch.tensor([True], device=dev))

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype, device=dev)

    # spore particles around each character (ldjam57 main.c spores)
    pparams = ParticleParams(
        active=t([True, True], torch.bool), radius=t([1.6, 1.6]),
        min_radius=t([0.4, 0.4]), velocity=t([0.015, 0.015]),
        dist=t([1, 1], torch.int32),
        count=t([PARTICLES_MAX // 4] * 2, torch.int32))
    pentity = t([1, 2], torch.int32)           # character entities
    sfx = anim_sfx_from_names(["idle", "motion", "jump", "fall"],
                              motion_segments=4, device=dev) \
        if footsteps else None
    gw = GameWorld(scene=tb.cfg, game=gcfg, anim=acfg, anim_sk=sk,
                   anim_lib=lib, particles=pparams, particle_entity=pentity,
                   sfx=sfx)
    gen = torch.Generator(device=dev).manual_seed(seed)
    session0 = GameSessionState(
        engine=tb.state0, game=game_state_init(1, 2, device=dev),
        anim=anim_instances_init(2, with_sfx=footsteps, device=dev),
        particles=particles_init(pparams, tb.state0.pos[pentity.long()],
                                 gen),
        joint_mats=torch.eye(4, device=dev).repeat(2, 3, 1, 1),
        sfx_events=torch.zeros(2, 2, dtype=torch.bool, device=dev)
        if footsteps else None)

    diffuse, slope = demo_textures()
    textures = TextureSets(diffuse=torch.as_tensor(diffuse, device=dev),
                           slope_blend=torch.as_tensor(slope, device=dev))
    # SKINNED textured characters: the ring-column mesh deforms by the
    # rigs' LBS every frame (model.vert:34-48; charskin.py)
    ter = tb.terrain
    chv, chn, chuv, chf = tbm.char_column_mesh(0.6, 2.0)
    models = [
        model_from_mesh(ter.vx, ter.norm, ter.idx.reshape(-1, 3),
                        base_color=(1.0, 1.0, 1.0), with_lods=False,
                        uv=ter.uv, tex_id=2),
        model_from_mesh(chv, chn, chf, base_color=(0.8, 0.5, 0.4), uv=chuv,
                        tex_id=0),
        model_from_mesh(*_cube_mesh(0.8, 0.8), base_color=(0.6, 0.6, 0.7)),
        model_from_mesh(*_cube_mesh(0.8, 3.0), base_color=(0.4, 0.3, 0.2),
                        uv=cube(1.0)[2], tex_id=1),
    ]
    # terrain/trees bake their shadows once (static split); per-frame CSM
    # rasters only characters + dynamic cubes
    rt = build_render_tables(
        models, ent.model_id, ent.active,
        entity_edge_id=default_edge_ids(ent.active, ent.body_is_char),
        entity_shadow_static=shadow_static_mask(ent), device=dev)
    lights = lights_empty(1, device=dev)
    d = t([-0.4, -0.8, -0.4])
    lights.direction[0] = d / torch.linalg.vector_norm(d)
    lights.color[0] = t([1.0, 0.95, 0.9])
    lights.is_dir[0] = True
    lights.active[0] = True
    cs = tbm.build_testbed_char_skin(tb, models, rt, device=dev)
    opts = RenderOptions(width=width, height=height, shadow_size=256)
    graphics = dict(render_tables=rt, lights=lights, opts=opts,
                    skip_culling=ent.skip_culling, textures=textures,
                    grain_noise=blue_noise2d(64, device=dev),
                    particle_world=pparams, particle_size=0.1,
                    particle_color=(0.95, 0.9, 0.5), char_skin=cs)
    return dict(tb=tb, gw=gw, session0=session0, rt=rt, cs=cs,
                textures=textures, lights=lights, opts=opts,
                graphics=graphics)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def soak(w, n_envs: int, frames: int, dev, seed: int = 0):
    """The batched soak run (the 4096-scene configuration): ``fuzz_batch``
    + ``engine_step`` over ``n_envs`` replicas of the headless testbed for
    ``frames`` frames. Returns (final states, env-steps/s on the host
    clock, the card synchronised at both ends)."""
    from ..device import resolve_device
    from ..engine.fuzzer import fuzz_batch
    from ..engine.step import engine_step
    from ..scene.testbed import replicate_state

    dev = resolve_device(dev)
    tb = w["tb"]
    sts = replicate_state(tb.state0, n_envs)
    _sync(dev)
    t0 = time.perf_counter()
    for f in range(frames):
        ins = fuzz_batch(seed, f, n_envs, device=dev)
        sts = engine_step(tb.cfg, sts, ins)
    _sync(dev)
    return sts, n_envs * frames / (time.perf_counter() - t0)


def main(argv=None, scene=None, frame_size=(640, 360)):
    """The demo's command line (``argv``: sys.argv[1:] where None);
    ``scene`` (build_testbed's arguments) and ``frame_size`` cut it to
    size for a quick run. Returns the Engine (or, with ``--envs`` > 1,
    the soak's (states, env-steps/s))."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="clap_tpu_torch.demo.testbed")
    ap.add_argument("-e", "--exitafter", type=int, default=0)
    ap.add_argument("--fuzzer", action="store_true")
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--envs", type=int, default=1)
    ap.add_argument("--dump", default=None,
                    help="frame output directory (--render)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="live browser display on http://127.0.0.1:PORT "
                         "(implies --render; WASD/arrows/space drive it)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args, _ = ap.parse_known_args(argv)
    if args.serve:
        args.render = True

    from ..device import resolve_device
    from ..engine.core import ClapConfig, Engine

    dev = resolve_device(args.device)
    if args.envs > 1:
        w = build_world(dev, render=False, scene=scene)
        sts, rate = soak(w, args.envs, args.frames, dev)
        print(f"{args.envs} envs x {args.frames} frames: {rate:.0f} "
              f"env-steps/s ({dev})")
        return sts, rate

    cfg = ClapConfig(title="testbed", fuzzer=args.fuzzer,
                     exit_after=args.exitafter, graphics=args.render,
                     width=frame_size[0], height=frame_size[1])
    w = build_world(dev, render=args.render, width=frame_size[0],
                    height=frame_size[1], scene=scene)
    tb = w["tb"]
    eng = Engine(cfg, tb.cfg, tb.state0, argv=argv, game_world=w.get("gw"),
                 session0=w.get("session0"), device=dev)
    if args.render:
        out_dir = args.dump or os.path.join(tempfile.gettempdir(),
                                            "testbed_frames")
        eng.attach_graphics(**w["graphics"], out_dir=out_dir)
    if args.serve:
        d = eng.attach_display(port=args.serve)
        print(f"display: http://{d.host}:{d.port}/  (ctrl-c to stop)")

    eng.run(max_frames=args.frames)
    print("frames:", eng.frame_no, "profiler (host dispatch):",
          eng.profiler.report())
    if args.render and eng.last_frame is not None:
        print("last frame:", tuple(eng.last_frame.shape),
              "mean", round(float(eng.last_frame.mean()), 3))
        jm = eng.session.joint_mats[0].cpu().numpy()
        print("rigs animating:", jm.shape[0],
              "poses differ from bind:",
              bool((np.abs(jm - np.eye(4)) > 1e-3).any()))
    cpos = eng.state.phys.pos[0, 0].cpu().numpy()
    print("character at", cpos.round(2))
    return eng


if __name__ == "__main__":
    main()
