#!/usr/bin/env python3
"""Where a composed frame's time goes on one CUDA card (torch.profiler):

    python3 tools/torch_profile_frame.py [--frames N] [--top K]
                                         [--only GROUP[,GROUP...]]

For each of chip_smoke.py's composed worlds at 64 envs × 256², the
skinned flagship (phase 5), the textured frame on the per-pixel gather
path (phase 8) and the flagship at internal_scale 2 (phase 12), after a
warm-up (the static shadow bake and 2 frames), three windows of N calls
each: ``step_and_render``, ``game_step`` alone, and the render alone
(``SceneRenderer`` on the last state); then one window of the render of
each of the JAX bench's single-frame and shared-scene configurations
(phases 9-11: ``full_frame`` and ``full_frame_dense`` at 720p,
``full_frame_production`` at 720p, ``batched_render`` 64 × 256²), after 2
warm-up calls; then the game's own frame (phase 13: 1 env × 640 × 360,
``game_frame_step``, ``game_step`` alone and the render alone) and the
flagship's render under the heaviest options (phase 14: ``model_msaa`` 2,
PCF, ``fog_noise``, ``material_fog``); then the authored level (phase 15,
demo/level57.json): ``game_step`` of the scripted walk at 4,096 envs, the
level's frame at 1 env × 640 × 360 (``game_frame_step`` and the render
alone) and its 64-env × 256² batch (``step_and_render`` and the render
alone). ``--only`` picks groups: composed, single, game, options, level
(default all). Each window is timed unprofiled (host clock around
synchronised work), then run again under the profiler. Prints per window the wall ms per call, the device busy
ms per call (the summed time of every kernel, copy and fill on the card),
its share of the unprofiled wall time, the kernels per call, and the K
heaviest kernels by device time. Then the card (nvidia-smi name and power
limit) and, as the last line, a JSON object of every number.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def device_events(prof):
    """The profiler's device-side rows: (name, count, device µs)."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us))
    return rows


def window(name, fn, n, top, out):
    """Time ``fn`` (one call) n times unprofiled, then n times under the
    profiler; print and record the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        sync()
    rows = device_events(prof)
    busy = sum(us for _, _, us in rows) / n / 1e3
    launches = sum(c for _, c, _ in rows) / n
    if busy <= 0.0:
        raise RuntimeError(f"{name}: the profiler shows no device time")
    heavy = sorted(rows, key=lambda r: -r[2])[:top]
    print(f"{name}: wall {wall:.3f} ms/call unprofiled, device busy "
          f"{busy:.3f} ms/call ({100 * busy / wall:.1f} % of the wall), "
          f"{launches:.0f} kernels/call", flush=True)
    for k, c, us in heavy:
        print(f"  {us / n / 1e3:8.3f} ms/call {c / n:7.0f}x  {k[:90]}",
              flush=True)
    out[name] = {"wall_ms": wall, "busy_ms": busy, "kernels": launches,
                 "top": [[k[:90], c / n, us / n / 1e3] for k, c, us in heavy]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--only", default="composed,single,game,options,level")
    a = ap.parse_args()
    groups = set(a.only.split(","))

    import torch

    if not torch.cuda.is_available():
        print("torch_profile_frame: no CUDA device", file=sys.stderr)
        return 2
    import dataclasses

    import chip_smoke as CS
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.engine.game import game_step
    from clap_tpu_torch.render.pipeline import (render_frame,
                                                render_frame_batch)
    from clap_tpu_torch.render.scenerender import bake_static_shadow

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0].strip()
    print(f"card: {card}", flush=True)
    res = {"card": card, "frames": a.frames}
    composed = (("skinned flagship", False, 1), ("textured frame", True, 1),
                ("flagship at internal_scale 2", False, 2))
    for tag, textured, scale in composed if "composed" in groups else ():
        w = CS.build_slice(dev, textured=textured)
        w["opts"] = dataclasses.replace(w["opts"], internal_scale=scale)
        static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
        renderer = CS.make_renderer(w, static)
        box = {"gs": w["gs"]}

        def frame():
            box["gs"], _ = step_and_render(w["gw"], renderer, box["gs"],
                                           w["ins"])

        def step():
            box["gs"] = game_step(w["gw"], box["gs"], w["ins"])

        def render():
            renderer(box["gs"].engine, box["gs"].joint_mats)

        for _ in range(2):
            frame()
        torch.cuda.synchronize()
        path = "gather" if not renderer.cluster_records else "cluster records"
        print(f"{tag} ({CS.N_SLICE} envs x {CS.RES}^2, {path}):", flush=True)
        for name, fn in (("step_and_render", frame), ("game_step", step),
                         ("render", render)):
            window(f"{tag} {name}", fn, a.frames, a.top, res)
        del w, renderer, box, static
        torch.cuda.empty_cache()

    def full_frame(**kw):
        w = CS.build_full_frame(dev, **kw)
        return lambda: render_frame(w["opts"], w["geom"], w["view"],
                                    w["proj"], w["lights"], w["eye"])

    def production():
        w = CS.build_production(dev)
        return lambda: CS.production_frame(w, w["eye"])

    def batched():
        w = CS.build_batched(dev, CS.N_SLICE, CS.RES)
        return lambda: render_frame_batch(w["opts"], w["geom"], w["views"],
                                          w["proj"], w["lights"], w["eyes"],
                                          far=100.0)

    single = (("full_frame 720p", lambda: full_frame()),
              ("full_frame_dense 720p", lambda: full_frame(
                  nr_v=240, n_cubes=256, raster_cap=4096)),
              ("full_frame_production 720p", production),
              (f"batched_render {CS.N_SLICE} x {CS.RES}^2", batched))
    for tag, make in single if "single" in groups else ():
        fn = make()
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        window(tag, fn, a.frames, a.top, res)
        del fn
        torch.cuda.empty_cache()
    if "game" in groups:
        from clap_tpu_torch.engine.frame import game_frame_step

        g = CS.build_game_frame(dev)
        r, box = g["renderer"], {"gs": g["gs"]}

        def gframe():
            box["gs"], _ = game_frame_step(g["gw"], r, box["gs"], g["ins"])

        def gstep():
            box["gs"] = game_step(g["gw"], box["gs"], g["ins"],
                                  camera_occlusion=True)

        def grender():
            s = box["gs"]
            r(s.engine, s.particles, None, s.joint_mats)

        for _ in range(2):
            gframe()
        torch.cuda.synchronize()
        print("game frame (1 env x 640x360, demo/testbed.py --render):",
              flush=True)
        for name, fn in (("game_frame_step", gframe), ("game_step", gstep),
                         ("render", grender)):
            window(f"game frame {name}", fn, a.frames, a.top, res)
        del g, r, box
        torch.cuda.empty_cache()
    if "options" in groups:
        w = CS.build_slice(dev)
        static = bake_static_shadow(w["rt"], w["tb"].state0.mx,
                                    w["lights"].direction[0],
                                    shadow_size=1024, far=200.0)
        gs = game_step(w["gw"], w["gs"], w["ins"])
        for tag, kw in (("model_msaa 2", dict(model_msaa=2)),
                        ("pcf", dict(shadow_vsm=False)),
                        ("fog_noise", dict(fog_noise=True)),
                        ("material_fog", dict(material_fog=True))):
            rv = CS.make_renderer(dict(w, opts=dataclasses.replace(
                w["opts"], **kw)), static)

            def orender(rv=rv):
                rv(gs.engine, gs.joint_mats)

            for _ in range(2):
                orender()
            torch.cuda.synchronize()
            window(f"flagship render {tag} ({CS.N_SLICE} x {CS.RES}^2)",
                   orender, a.frames, a.top, res)
        del w, static, gs
        torch.cuda.empty_cache()
    if "level" in groups:
        from clap_tpu_torch.bridge import tree_map
        from clap_tpu_torch.engine.frame import game_frame_step
        from clap_tpu_torch.engine.step import inputs_zero

        def walk(n):
            ins = tree_map(lambda x: x.expand(n, *x.shape).clone(),
                           inputs_zero(2, device=dev))
            ins.motion[:, 0, 0] = 1.0
            return ins

        w = CS.build_level(dev, CS.N_HEADLESS)
        box, ins = {"gs": w["gs"]}, walk(CS.N_HEADLESS)

        def lstep():
            box["gs"] = game_step(w["gw"], box["gs"], ins,
                                  camera_occlusion=True)

        for _ in range(2):
            lstep()
        torch.cuda.synchronize()
        window(f"level game_step ({CS.N_HEADLESS} envs)", lstep, a.frames,
               a.top, res)
        del box, ins
        torch.cuda.empty_cache()
        fr, br = CS.level_renderers(w["scene"], dev)
        for tag, n in (("level frame (1 env x 640x360)", 1),
                       (f"level batch ({CS.N_SLICE} x {CS.RES}^2)",
                        CS.N_SLICE)):
            wl = CS.build_level(dev, n)
            box, ins = {"gs": wl["gs"]}, walk(n)
            if n == 1:
                def lframe():
                    box["gs"], _ = game_frame_step(wl["gw"], fr, box["gs"],
                                                   ins)

                def lrender():
                    fr(box["gs"].engine)
            else:
                def lframe():
                    box["gs"], _ = step_and_render(wl["gw"], br, box["gs"],
                                                   ins)

                def lrender():
                    br(box["gs"].engine)
            for _ in range(2):
                lframe()
            torch.cuda.synchronize()
            for name, fn in (("frame", lframe), ("render", lrender)):
                window(f"{tag} {name}", fn, a.frames, a.top, res)
            del wl, box, ins
            torch.cuda.empty_cache()
        del w, fr, br
    print(card, flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
