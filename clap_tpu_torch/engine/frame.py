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

The game's own frame (counterpart of ``Engine.attach_graphics``'s render
closure, clap_tpu/engine/core.py:141-232, and ``Engine.frame``,
core.py:403-408) is ``GameFrameRenderer``: one env, the orbit camera at the
frame's aspect, single-env ``assemble_scene_geometry`` (world normals,
skinned characters exact), the live particle systems, film grain and the
static atlas baked once; ``game_frame_step`` steps ``game_step`` with the
camera occlusion on and renders, as ``Engine.frame`` does.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from .. import mathx as mx
from ..ops.particles import PARTICLES_MAX, ParticleParams, ParticleState
from ..render.camera import camera_view_proj, orbit_quat
from ..render.charskin import CharSkin
from ..render.lights import Lights
from ..render.pipeline import (RenderOptions, TextureSets, render_frame,
                               render_frame_dynamic_batch)
from ..render.scenerender import (RenderTables,
                                  assemble_cluster_records_batch,
                                  assemble_scene_geometry,
                                  assemble_scene_geometry_batch,
                                  bake_static_shadow, kernel_attrs_ok)
from ..render.view import make_subview
from .game import GameSessionState, GameWorld, game_step
from .state import EngineState
from .step import Inputs


class _SceneBuffers(nn.Module):
    """The scene a renderer draws, as buffers that follow the module across
    ``.to(device)``: every tensor of the static RenderTables
    (``rt_<field>``), the lights (``light_<field>``), the static shadow
    triple, the CharSkin (``skin_<field>``), the TextureSets
    (``tex_<field>``) and the entities that skip culling."""

    def __init__(self, rt: RenderTables, lights: Lights, skip_culling=None,
                 static_shadow=None, char_skin: CharSkin = None,
                 textures: TextureSets = None):
        super().__init__()
        self._static = {}
        self._add("rt", rt)
        self._add("light", lights)
        self._add("skin", char_skin)
        self._add("tex", textures)
        self.register_buffer("skip_culling", skip_culling, persistent=False)
        ss = static_shadow if static_shadow is not None else (None,) * 3
        for name, v in zip(("moments", "mvps", "dists"), ss):
            self.register_buffer(f"static_{name}", v, persistent=False)

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


class SceneRenderer(_SceneBuffers):
    """Renders a batched EngineState (B envs) to LDR images (B, H, W, 3).
    Buffers: the scene (``_SceneBuffers``) and the camera projection.

    ``opts.kernel_attrs`` holds only where the tables allow it
    (``kernel_attrs_ok``); otherwise the renderer takes the gather path.
    ``cluster_records=False`` assembles member geometry on the kernel-attrs
    path too (bench.py's ``CLUSTER_REC=0``)."""

    def __init__(self, rt: RenderTables, lights: Lights, opts: RenderOptions,
                 skip_culling=None, static_shadow=None,
                 lod_scale: float = 1.0, fovy: float = math.pi / 3,
                 far: float = 200.0, char_skin: CharSkin = None,
                 textures: TextureSets = None, cluster_records: bool = True):
        super().__init__(rt, lights, skip_culling, static_shadow, char_skin,
                         textures)
        ka = opts.kernel_attrs and kernel_attrs_ok(rt)
        self.opts = dataclasses.replace(opts, kernel_attrs=ka)
        self.cluster_records = (ka and rt.cl_rest is not None
                                and cluster_records)
        self.lod_scale = float(lod_scale)
        self.fovy = float(fovy)
        self.far = float(far)
        self.register_buffer(
            "proj", mx.mat4_perspective(self.fovy, 1.0, 0.1, far,
                                        device=rt.verts.device),
            persistent=False)

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

    def forward(self, st: EngineState, joint_mats=None,
                **kw) -> torch.Tensor:
        """The LDR frames (B, H, W, 3); ``kw``: render_frame's per-frame
        inputs (lut_volume, grain_noise, particles, ssao_kernel_arr)."""
        views = self.views(st)
        geom = self.geometry(st, views, joint_mats)
        return render_frame_dynamic_batch(
            self.opts, geom, views, self.proj, self.lights, st.camera.pos,
            far=self.far, static_shadow=self.static_shadow,
            textures=self.textures, **kw)


def step_and_render(gw: GameWorld, renderer: SceneRenderer,
                    gs: GameSessionState, inputs: Inputs):
    """One composed frame: the batched game step (camera occlusion as
    ``gw`` sets it, on by default), then the render of every env's engine
    state with the step's joint matrices. Returns (new state, images
    (B, H, W, 3))."""
    gs = game_step(gw, gs, inputs)
    return gs, renderer(gs.engine, gs.joint_mats)


class GameFrameRenderer(_SceneBuffers):
    """The game's own rendered frame, one env (the render closure of
    ``Engine.attach_graphics``, clap_tpu/engine/core.py:141-232): the
    orbit camera at the frame's aspect, single-env
    ``assemble_scene_geometry`` (world normals, skinned characters exact,
    the gather path), the live particle systems, film grain, the LUT, and
    the static casters' atlas baked once here at max(shadow_size, 1024)²
    from the entity matrices ``entity_mx0`` (E, 4, 4) (the engine state's
    when graphics attach).

    ``opts`` None: RenderOptions at 1280 × 720 with film grain 0.03 where
    ``grain_noise`` is given, else 0. ``particle_params`` (ParticleParams
    of the GameWorld) with ``n_particles`` per system: the active mask of
    core.py:183-191 (a system's first ``count`` particles, where it is
    active); ``particle_size`` and ``particle_color`` as attach_graphics
    takes them. Buffers: the scene (``_SceneBuffers``), the projection,
    grain noise, LUT volume and particle mask."""

    def __init__(self, rt: RenderTables, lights: Lights,
                 opts: RenderOptions = None, skip_culling=None,
                 fov: float = math.pi / 3, textures: TextureSets = None,
                 lut_volume=None, grain_noise=None,
                 particle_params: ParticleParams = None,
                 n_particles: int = PARTICLES_MAX,
                 particle_size: float = 0.12,
                 particle_color=(0.9, 0.9, 0.6), char_skin: CharSkin = None,
                 entity_mx0=None, far: float = 200.0):
        if opts is None:
            opts = RenderOptions(film_grain=0.0 if grain_noise is None
                                 else 0.03)
        static = None
        if rt.static_shadow_faces is not None \
                and rt.static_shadow_faces.shape[0] > 0 \
                and lights.active.shape[0] > 0:
            if entity_mx0 is None:
                raise ValueError("tables with a static shadow stream need "
                                 "entity_mx0 to bake it")
            static = bake_static_shadow(rt, entity_mx0, lights.direction[0],
                                        shadow_size=max(opts.shadow_size,
                                                        1024), far=far)
        super().__init__(rt, lights, skip_culling, static, char_skin,
                         textures)
        self.opts = opts
        self.fov = float(fov)
        self.far = float(far)
        self.particle_size = float(particle_size)
        self.particle_color = tuple(particle_color)
        dev = rt.verts.device
        self.register_buffer(
            "proj", mx.mat4_perspective(self.fov, opts.width / opts.height,
                                        0.1, far, device=dev),
            persistent=False)
        self.register_buffer("grain_noise", grain_noise, persistent=False)
        self.register_buffer("lut_volume", lut_volume, persistent=False)
        pactive = None
        if particle_params is not None:
            idx = torch.arange(n_particles, device=dev)
            pactive = (particle_params.active[:, None]
                       & (idx[None, :] < particle_params.count[:, None])
                       ).reshape(-1)
        self.register_buffer("particle_active", pactive, persistent=False)

    def view(self, st: EngineState):
        """The camera's view matrix (1, 4, 4): yaw about +y, then pitch
        about +x, at the camera position (core.py:194-200)."""
        cam = st.camera
        return mx.transform_view_mat4(cam.pos, orbit_quat(cam.pitch,
                                                          cam.yaw))

    def geometry(self, st: EngineState, view, joint_mats=None):
        """The env's geometry (``assemble_scene_geometry``) under the
        frustum of ``view``; ``joint_mats`` (1, C, J, 4, 4) skins the
        characters when the renderer has a CharSkin."""
        if st.mx.shape[0] != 1:
            raise ValueError(f"the game frame renders one env, not "
                             f"{st.mx.shape[0]}")
        cs = self.char_skin
        if cs is not None and joint_mats is None:
            raise ValueError("a renderer with a CharSkin needs joint_mats")
        planes = make_subview(view, self.proj).planes
        return assemble_scene_geometry(
            self.rt, st.mx[0], st.visible[0], planes[0], st.camera.pos[0],
            skip_culling=self.skip_culling, char_skin=cs,
            joint_mats=joint_mats[0] if cs is not None else None)

    def particle_args(self, particles: ParticleState):
        """render_frame's ``particles`` tuple of a session's particle state
        ((1, S, P, 3) positions), None where there are none to draw."""
        if particles is None or self.particle_active is None:
            return None
        pos = particles.pos
        return (pos.reshape(pos.shape[0], -1, 3), self.particle_size,
                self.particle_active, self.particle_color)

    def forward(self, st: EngineState, particles: ParticleState = None,
                lut_volume=None, joint_mats=None) -> torch.Tensor:
        """The LDR frame (1, H, W, 3) of a one-env EngineState, its
        particles, a LUT volume (default the renderer's) and the rigs'
        joint matrices."""
        view = self.view(st)
        geom = self.geometry(st, view, joint_mats)
        return render_frame(
            self.opts, geom, view, self.proj, self.lights, st.camera.pos,
            far=self.far, static_shadow=self.static_shadow,
            textures=self.textures, grain_noise=self.grain_noise,
            lut_volume=self.lut_volume if lut_volume is None else lut_volume,
            particles=self.particle_args(particles))


def game_frame_step(gw: GameWorld, renderer: GameFrameRenderer,
                    gs: GameSessionState, inputs: Inputs, generator=None):
    """One frame of the game as ``Engine.frame`` runs it with graphics on
    (core.py:228-239, 395-408): ``game_step`` with the camera occlusion
    on, then the render of the new state with its particles and joint
    matrices. Returns (new state, image (1, H, W, 3))."""
    gs = game_step(gw, gs, inputs, camera_occlusion=True,
                   generator=generator)
    return gs, renderer(gs.engine, gs.particles, None, gs.joint_mats)
