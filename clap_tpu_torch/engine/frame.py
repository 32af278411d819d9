"""The composed step-and-render frame (counterpart of the closure in
bench.py ``bench_step_and_render``, with the characters as rigid cube
proxies).

One frame, for every env of a batched GameSessionState:

1. ``game_step`` (engine step with the camera occlusion shrink, game
   rules, rig animation, particles);
2. per-env views (``camera_view_proj``) and frustum planes
   (``make_subview``);
3. ``assemble_cluster_records_batch`` (cull, LOD, compaction, clip
   transform at cluster granularity);
4. ``render_frame_dynamic_batch`` with the baked static shadow atlas.

``SceneRenderer`` is the nn.Module that holds the static render tables,
lights and the static shadow as buffers; ``step_and_render`` is the entry
point a caller drives once per frame.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .. import mathx as mx
from ..render.camera import camera_view_proj, orbit_quat
from ..render.lights import Lights
from ..render.pipeline import RenderOptions, render_frame_dynamic_batch
from ..render.scenerender import (RenderTables,
                                  assemble_cluster_records_batch,
                                  kernel_attrs_ok)
from ..render.view import make_subview
from .game import GameSessionState, GameWorld, game_step
from .state import EngineState
from .step import Inputs


class SceneRenderer(nn.Module):
    """Renders a batched EngineState (B envs) to LDR images (B, H, W, 3).

    Buffers: every tensor of the static RenderTables (``rt_<field>``), the
    lights (``light_<field>``), the static shadow triple and the camera
    projection; they follow the module across ``.to(device)``."""

    def __init__(self, rt: RenderTables, lights: Lights, opts: RenderOptions,
                 skip_culling=None, static_shadow=None,
                 lod_scale: float = 1.0, fovy: float = math.pi / 3,
                 far: float = 200.0):
        super().__init__()
        if not opts.kernel_attrs or not kernel_attrs_ok(rt):
            raise NotImplementedError(
                "the renderer drives the kernel_attrs cluster-record path")
        self.opts = opts
        self.lod_scale = float(lod_scale)
        self.fovy = float(fovy)
        self.far = float(far)
        self._rt_fields = RenderTables._fields
        self._rt_static = {}
        for f, v in zip(RenderTables._fields, rt):
            if isinstance(v, torch.Tensor):
                self.register_buffer(f"rt_{f}", v, persistent=False)
            else:
                self._rt_static[f] = v
        for f, v in zip(Lights._fields, lights):
            self.register_buffer(f"light_{f}", v, persistent=False)
        self.register_buffer("skip_culling", skip_culling, persistent=False)
        ss = static_shadow if static_shadow is not None else (None,) * 3
        for name, v in zip(("moments", "mvps", "dists"), ss):
            self.register_buffer(f"static_{name}", v, persistent=False)
        self.register_buffer(
            "proj", mx.mat4_perspective(self.fovy, 1.0, 0.1, far,
                                        device=rt.verts.device),
            persistent=False)

    @property
    def rt(self) -> RenderTables:
        return RenderTables(*(
            self._rt_static[f] if f in self._rt_static
            else getattr(self, f"rt_{f}") for f in self._rt_fields))

    @property
    def lights(self) -> Lights:
        return Lights(*(getattr(self, f"light_{f}") for f in Lights._fields))

    @property
    def static_shadow(self):
        if self.static_moments is None:
            return None
        return self.static_moments, self.static_mvps, self.static_dists

    def views(self, st: EngineState):
        """Per-env camera view matrices (B, 4, 4) from the orbit state."""
        cam = st.camera
        q = orbit_quat(cam.pitch, cam.yaw)
        return camera_view_proj(cam.pos, q, self.fovy, 1.0, far=self.far)[0]

    def geometry(self, st: EngineState, views=None):
        """The batched cluster-record geometry of every env."""
        views = self.views(st) if views is None else views
        planes = make_subview(views, self.proj).planes
        return assemble_cluster_records_batch(
            self.rt, st.mx, st.visible, planes, st.camera.pos, views,
            self.proj, cap=self.opts.record_compact or 24576,
            skip_culling=self.skip_culling, lod_scale=self.lod_scale)

    def forward(self, st: EngineState) -> torch.Tensor:
        views = self.views(st)
        geom = self.geometry(st, views)
        return render_frame_dynamic_batch(
            self.opts, geom, views, self.proj, self.lights, st.camera.pos,
            far=self.far, static_shadow=self.static_shadow)


def step_and_render(gw: GameWorld, renderer: SceneRenderer,
                    gs: GameSessionState, inputs: Inputs):
    """One composed frame: the batched game step (camera occlusion as
    ``gw`` sets it, on by default), then the render of every env's engine
    state. Returns (new state, images (B, H, W, 3))."""
    gs = game_step(gw, gs, inputs)
    return gs, renderer(gs.engine)
