"""The composed step-and-render frame (counterpart of the closure in
bench.py ``bench_step_and_render``, skinned characters and textured
tables included).

One frame, for every env of a batched GameSessionState:

1. ``game_step`` (engine step with the camera occlusion shrink, game
   rules, rig animation, particles);
2. per-env views (``camera_view_proj``) and frustum planes
   (``make_subview``);
3. the geometry: ``assemble_cluster_records_batch`` (cull, LOD,
   compaction, clip transform at cluster granularity) when the tables
   allow kernel-side attributes (``kernel_attrs_ok``), else the
   member-granularity ``assemble_scene_geometry_batch`` — the choice
   bench.py:620-624 makes; skinned characters enter either through the
   renderer's CharSkin and the step's joint matrices;
4. ``render_frame_dynamic_batch`` with the baked static shadow atlas (the
   kernel-attrs G-buffer, or the per-pixel gather with textures).

``SceneRenderer`` is the nn.Module that holds the static render tables,
lights, static shadow, CharSkin and textures as buffers; ``step_and_render``
is the entry point a caller drives once per frame.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import mathx as mx
from ..render.camera import camera_view_proj, orbit_quat
from ..render.charskin import CharSkin
from ..render.lights import Lights
from ..render.pipeline import (RenderOptions, TextureSets,
                               render_frame_dynamic_batch)
from ..render.scenerender import (RenderTables,
                                  assemble_cluster_records_batch,
                                  assemble_scene_geometry_batch,
                                  kernel_attrs_ok)
from ..render.view import make_subview
from .game import GameSessionState, GameWorld, game_step
from .state import EngineState
from .step import Inputs


class SceneRenderer(nn.Module):
    """Renders a batched EngineState (B envs) to LDR images (B, H, W, 3).

    Buffers: every tensor of the static RenderTables (``rt_<field>``), the
    lights (``light_<field>``), the static shadow triple, the camera
    projection, the CharSkin (``skin_<field>``) and the TextureSets
    (``tex_<field>``); they follow the module across ``.to(device)``.

    ``opts.kernel_attrs`` holds only where the tables allow it
    (``kernel_attrs_ok``); otherwise the renderer takes the gather path."""

    def __init__(self, rt: RenderTables, lights: Lights, opts: RenderOptions,
                 skip_culling=None, static_shadow=None,
                 lod_scale: float = 1.0, fovy: float = math.pi / 3,
                 far: float = 200.0, char_skin: CharSkin = None,
                 textures: TextureSets = None):
        super().__init__()
        ka = opts.kernel_attrs and kernel_attrs_ok(rt)
        self.opts = dataclasses.replace(opts, kernel_attrs=ka)
        self.cluster_records = ka and rt.cl_rest is not None
        self.lod_scale = float(lod_scale)
        self.fovy = float(fovy)
        self.far = float(far)
        self._static = {}
        self._add("rt", rt)
        self._add("light", lights)
        self._add("skin", char_skin)
        self._add("tex", textures)
        self.register_buffer("skip_culling", skip_culling, persistent=False)
        ss = static_shadow if static_shadow is not None else (None,) * 3
        for name, v in zip(("moments", "mvps", "dists"), ss):
            self.register_buffer(f"static_{name}", v, persistent=False)
        self.register_buffer(
            "proj", mx.mat4_perspective(self.fovy, 1.0, 0.1, far,
                                        device=rt.verts.device),
            persistent=False)

    def _add(self, prefix, tree):
        """Register a NamedTuple's tensors as buffers ``<prefix>_<field>``
        and keep its other fields (host ints, tuples, flags, None)."""
        self._static[prefix] = (type(tree), {}) if tree is not None else None
        if tree is None:
            return
        for f, v in zip(tree._fields, tree):
            if isinstance(v, torch.Tensor):
                self.register_buffer(f"{prefix}_{f}", v, persistent=False)
            else:
                self._static[prefix][1][f] = v

    def _get(self, prefix):
        if self._static[prefix] is None:
            return None
        cls, static = self._static[prefix]
        return cls(*(static[f] if f in static
                     else getattr(self, f"{prefix}_{f}")
                     for f in cls._fields))

    @property
    def rt(self) -> RenderTables:
        return self._get("rt")

    @property
    def lights(self) -> Lights:
        return self._get("light")

    @property
    def char_skin(self) -> CharSkin:
        return self._get("skin")

    @property
    def textures(self) -> TextureSets:
        return self._get("tex")

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

    def geometry(self, st: EngineState, views=None, joint_mats=None):
        """The batched geometry of every env: cluster records on the
        kernel-attrs path, member-granularity geometry on the gather path.
        ``joint_mats`` (B, C, J, 4, 4) skins the characters when the
        renderer has a CharSkin."""
        views = self.views(st) if views is None else views
        planes = make_subview(views, self.proj).planes
        cs = self.char_skin
        if cs is not None and joint_mats is None:
            raise ValueError("a renderer with a CharSkin needs joint_mats")
        jm = joint_mats if cs is not None else None
        if self.cluster_records:
            return assemble_cluster_records_batch(
                self.rt, st.mx, st.visible, planes, st.camera.pos, views,
                self.proj, cap=self.opts.record_compact or 24576,
                skip_culling=self.skip_culling, char_skin=cs, joint_mats=jm,
                lod_scale=self.lod_scale)
        return assemble_scene_geometry_batch(
            self.rt, st.mx, st.visible, planes, st.camera.pos,
            skip_culling=self.skip_culling, char_skin=cs, joint_mats=jm,
            lod_scale=self.lod_scale)

    def forward(self, st: EngineState, joint_mats=None) -> torch.Tensor:
        views = self.views(st)
        geom = self.geometry(st, views, joint_mats)
        return render_frame_dynamic_batch(
            self.opts, geom, views, self.proj, self.lights, st.camera.pos,
            far=self.far, static_shadow=self.static_shadow,
            textures=self.textures)


def step_and_render(gw: GameWorld, renderer: SceneRenderer,
                    gs: GameSessionState, inputs: Inputs):
    """One composed frame: the batched game step (camera occlusion as
    ``gw`` sets it, on by default), then the render of every env's engine
    state with the step's joint matrices. Returns (new state, images
    (B, H, W, 3))."""
    gs = game_step(gw, gs, inputs)
    return gs, renderer(gs.engine, gs.joint_mats)
