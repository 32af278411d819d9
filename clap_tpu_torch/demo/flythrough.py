"""Camera flythrough of the testbed to PNG frames (counterpart of
demo/flythrough.py) — the screenshot/video-capture role of the
reference's debug tooling.

Usage:
  python -m clap_tpu_torch.demo.flythrough [--frames 8] [--out DIR]
      [--width 640] [--height 360] [--sim-frames 20] [--device DEV]

Runs on the CUDA card unless ``--device`` names another device. The scene
is the JAX demo's: the headline testbed, four flat-coloured models (the
terrain and three cubes) and one sun; the character walks (0.7, 0.3)
while the camera orbits it once over the frames. ``build_world``,
``sim_step`` and ``render`` are the demo's pieces for other callers
(chip_smoke.py drives them on the card).
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import torch

# the demo's scene (demo/flythrough.py:40-41)
SCENE = dict(seed=42, side=64.0, nr_v=128, n_dynamic=8, max_entities=64)
PITCH, DIST = -0.35, 12.0      # the orbit camera (demo/flythrough.py:75-77)
WALK = (0.7, 0.3)              # the character's motion input


def build_world(device=None, width: int = 640, height: int = 360) -> dict:
    """The demo's world on ``device`` (the card unless named): the testbed,
    its render tables over the four models, one sun and RenderOptions at
    ``width`` × ``height`` with 256² cascades and no grain; the one-env
    state and the walk input. A dict of tb, rt, lights, opts, st, ins."""
    from ..bridge import tree_map
    from ..device import resolve_device
    from ..engine.step import inputs_zero
    from ..render.lights import lights_empty
    from ..render.pipeline import RenderOptions
    from ..render.scenerender import build_render_tables, model_from_mesh
    from ..scene.testbed import build_testbed, replicate_state
    from .testbed import _cube_mesh

    dev = resolve_device(device)
    tb = build_testbed(**SCENE, device=dev)
    t = tb.terrain
    models = [
        model_from_mesh(t.vx, t.norm, t.idx.reshape(-1, 3),
                        base_color=(0.35, 0.5, 0.3), with_lods=False),
        model_from_mesh(*_cube_mesh(0.6, 2.0), base_color=(0.8, 0.5, 0.4),
                        with_lods=False),
        model_from_mesh(*_cube_mesh(0.8, 0.8), base_color=(0.6, 0.6, 0.7),
                        with_lods=False),
        model_from_mesh(*_cube_mesh(0.8, 3.0), base_color=(0.4, 0.3, 0.2),
                        with_lods=False),
    ]
    ent = tb.cfg.entities
    rt = build_render_tables(models, ent.model_id, ent.active, device=dev)
    lights = lights_empty(1, device=dev)
    d = torch.tensor([-0.4, -0.8, -0.4], device=dev)
    lights.direction[0] = d / torch.linalg.vector_norm(d)
    lights.color[0] = torch.tensor([1.0, 0.95, 0.9], device=dev)
    lights.is_dir[0] = True
    lights.active[0] = True
    opts = RenderOptions(width=width, height=height, shadow_size=256,
                         film_grain=0.0)
    ins = tree_map(lambda x: x[None].clone(), inputs_zero(1, device=dev))
    ins.motion[0, 0, 0] = WALK[0]
    ins.motion[0, 0, 1] = WALK[1]
    return dict(tb=tb, rt=rt, lights=lights, opts=opts,
                st=replicate_state(tb.state0, 1), ins=ins)


def sim_step(w: dict, st):
    """One headless frame of the one-env state (engine_step, the walk)."""
    from ..engine.step import engine_step

    return engine_step(w["tb"].cfg, st, w["ins"])


def camera(w: dict, st, yaw: float):
    """The orbit camera around the first body at ``yaw`` (occlusion shrink
    against the scene): (view (1, 4, 4), proj (4, 4), eye (1, 3))."""
    from ..render.camera import camera_update, camera_view_proj

    dev = st.pos.device
    opts = w["opts"]
    eye, q, _ = camera_update(
        w["tb"].cfg.world, st.phys.pos[:, 0],
        torch.full((1,), PITCH, device=dev),
        torch.full((1,), yaw, device=dev), torch.full((1,), DIST, device=dev))
    view, proj = camera_view_proj(eye, q, math.pi / 3,
                                  opts.width / opts.height)
    return view, proj, eye


def geometry(w: dict, st, view, proj, eye):
    """The env's geometry under the camera (single-env assembly)."""
    from ..render.scenerender import assemble_scene_geometry
    from ..render.view import make_subview

    planes = make_subview(view, proj).planes
    return assemble_scene_geometry(
        w["rt"], st.mx[0], st.visible[0], planes[0], eye[0],
        skip_culling=w["tb"].cfg.entities.skip_culling)


def render(w: dict, st, yaw: float):
    """The frame (1, H, W, 3) of state ``st`` seen from ``yaw``."""
    from ..render.pipeline import render_frame

    view, proj, eye = camera(w, st, yaw)
    return render_frame(w["opts"], geometry(w, st, view, proj, eye), view,
                        proj, w["lights"], eye)


def run(w: dict, frames: int, sim_frames: int, out_dir=None):
    """The flythrough: ``frames`` renders, ``sim_frames`` steps before
    each, the camera at yaw 2π·f/frames. Writes frame_NNN.png to
    ``out_dir`` where given. Returns the images, each (H, W, 3) on the
    world's device."""
    from ..utils.png import save_png

    st = w["st"]
    imgs = []
    for f in range(frames):
        for _ in range(sim_frames):
            st = sim_step(w, st)
        img = render(w, st, 2 * math.pi * f / frames)[0]
        imgs.append(img)
        if out_dir is not None:
            p = os.path.join(out_dir, f"frame_{f:03d}.png")
            save_png(p, img.cpu().numpy())
            print("wrote", p)
    w["st"] = st
    return imgs


def main(argv=None):
    """The demo's command line (``argv``: sys.argv[1:] where None).
    Returns the world (its state the last frame's) and the images."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(prog="clap_tpu_torch.demo.flythrough")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "fly"))
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--sim-frames", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    w = build_world(args.device, args.width, args.height)
    os.makedirs(args.out, exist_ok=True)
    return w, run(w, args.frames, args.sim_frames, args.out)


if __name__ == "__main__":
    main()
