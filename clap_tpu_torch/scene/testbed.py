"""Benchmark testbed scene builder (counterpart of
clap_tpu/scene/testbed.py; the ldjam56 "onehandclap" analogue).

The scene is built on the host in numpy — procedural terrain
(terrain.c:418-574), kinematic character capsules, dynamic spheres and
instantiator-placed trees — and then moved to ``device``. The numbers are
the JAX package's bit for bit, as are the render models (``testbed_models``:
rigid or skinnable characters, untextured or textured) and the testbed's
procedural textures.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bridge import tree_map
from ..char.controller import CharParams
from ..device import resolve_device
from ..engine.state import (EngineState, EntityParams, SceneConfig,
                            engine_state_init, scene_host)
from ..physics.heightfield import heightfield_from_terrain
from ..physics.narrowphase import make_world
from ..physics.world import BodyParams, capsule_auto_size, capsule_inertia_np
from ..utils.frand import Rand48
from .terrain import terrain_height_np, terrain_init_square_landscape


class Testbed(NamedTuple):
    cfg: SceneConfig
    state0: EngineState     # unbatched template (replicate_state adds B)
    terrain: object
    chunks: list = None     # [(verts, normals, faces)] terrain chunks


def chunk_terrain(t, grid: int = 4) -> list:
    """Split the terrain mesh into grid² chunks by face centroid, each its
    own entity so frustum culling and distance LOD apply per chunk."""
    v = np.asarray(t.vx, np.float32)
    n = np.asarray(t.norm, np.float32)
    f = np.asarray(t.idx, np.int64).reshape(-1, 3)
    cent = v[f].mean(axis=1)
    x0, x1 = v[:, 0].min(), v[:, 0].max()
    z0, z1 = v[:, 2].min(), v[:, 2].max()
    ix = np.clip(((cent[:, 0] - x0) / max(x1 - x0, 1e-6) * grid)
                 .astype(np.int64), 0, grid - 1)
    iz = np.clip(((cent[:, 2] - z0) / max(z1 - z0, 1e-6) * grid)
                 .astype(np.int64), 0, grid - 1)
    cid = ix * grid + iz
    out = []
    for c in range(grid * grid):
        fc = f[cid == c]
        if len(fc) == 0:
            continue
        un, inv = np.unique(fc.reshape(-1), return_inverse=True)
        out.append((v[un], n[un], inv.reshape(-1, 3).astype(np.uint32)))
    return out


def build_testbed(seed: int = 42, side: float = 64.0, nr_v: int = 128,
                  n_dynamic: int = 8, max_entities: int = 64,
                  char_aabb=(0.6, 2.0, 0.6), n_chars: int = 1,
                  terrain_chunks: int = 0, device=None) -> Testbed:
    """Build the scene on the host and move it to ``device``.

    Entities: 0 = terrain, [1, 1+n_chars) = characters, then n_dynamic
    spheres, then instantiator trees; ``terrain_chunks = G`` adds G×G
    chunk entities (model ids 4..) and leaves entity 0 render-empty."""
    device = resolve_device(device)
    f32 = np.float32
    t = terrain_init_square_landscape(seed, -side / 2, 0.0, -side / 2,
                                      side, nr_v)
    world = make_world(heightfield_from_terrain(t, device))

    n_bodies = n_chars + n_dynamic
    active = np.zeros(n_bodies, bool)
    kinematic = np.zeros(n_bodies, bool)
    radius = np.zeros(n_bodies, f32)
    half_len = np.zeros(n_bodies, f32)
    yoffset = np.zeros(n_bodies, f32)
    ray_off = np.zeros(n_bodies, f32)
    mass = np.ones(n_bodies, f32)
    bounce = np.zeros(n_bodies, f32)
    bounce_vel = np.zeros(n_bodies, f32)
    mu = np.ones(n_bodies, f32)

    r, hl, yoff, roff = capsule_auto_size(*char_aabb)
    for ci in range(n_chars):
        active[ci] = kinematic[ci] = True
        radius[ci], half_len[ci], yoffset[ci], ray_off[ci] = r, hl, yoff, roff
        mass[ci] = 70.0

    rng = Rand48(seed ^ 0x5EED)
    dyn_pos = []
    for i in range(n_dynamic):
        bi = n_chars + i
        br = 0.3 + 0.2 * rng.drand48()
        bx = (rng.drand48() - 0.5) * side * 0.8
        bz = (rng.drand48() - 0.5) * side * 0.8
        active[bi] = True
        radius[bi] = yoffset[bi] = ray_off[bi] = br
        mass[bi] = 1.0 + rng.drand48()
        bounce[bi] = 0.3
        bounce_vel[bi] = 0.1
        dyn_pos.append((bx, 4.0 + 3.0 * rng.drand48(), bz))

    def dev(a):
        return torch.as_tensor(a, device=device)

    host_bodies = BodyParams(
        active=active, kinematic=kinematic, radius=radius,
        half_len=half_len, yoffset=yoffset, ray_off=ray_off, mass=mass,
        bounce=bounce, bounce_vel=bounce_vel, mu=mu)
    bodies = BodyParams(
        active=dev(active), kinematic=dev(kinematic), radius=dev(radius),
        half_len=dev(half_len), yoffset=dev(yoffset), ray_off=dev(ray_off),
        mass=dev(mass), bounce=dev(bounce), bounce_vel=dev(bounce_vel),
        mu=dev(mu), inertia=dev(capsule_inertia_np(mass, radius, half_len)))

    char_params = CharParams(
        body=dev(np.arange(n_chars, dtype=np.int32)),
        lin_speed=dev(np.full(n_chars, char_aabb[1] * 1.2, f32)),
        jump_forward=dev(np.full(n_chars, 1.2, f32)),
        jump_upward=dev(np.full(n_chars, 5.0, f32)),
        can_dash=dev(np.ones(n_chars, bool)),
    )

    E = max_entities
    e_active = np.zeros(E, bool)
    model_id = np.zeros(E, np.int32)
    body = np.full(E, -1, np.int32)
    body_is_char = np.zeros(E, bool)
    skip = np.zeros(E, bool)
    e_active[0] = skip[0] = True                     # terrain
    for ci in range(n_chars):
        e_active[1 + ci] = True
        model_id[1 + ci] = 1
        body[1 + ci] = ci
        body_is_char[1 + ci] = True
    for i in range(n_dynamic):
        ei = 1 + n_chars + i
        e_active[ei] = True
        model_id[ei] = 2
        body[ei] = n_chars + i
    tree_pos = []
    next_ei = 1 + n_chars + n_dynamic
    # reserve entity slots for the terrain chunks
    tree_cap = E - terrain_chunks * terrain_chunks
    for _name, dx, dy, dz in t.instantiators:
        ei = next_ei
        if ei >= tree_cap:
            break
        e_active[ei] = True
        model_id[ei] = 3
        tree_pos.append((ei, (dx, dy, dz)))
        next_ei += 1

    aabb_rows = [
        [[-side / 2, -10, -side / 2], [side / 2, 10, side / 2]],  # terrain
        [[-0.3, 0.0, -0.3], [0.3, 2.0, 0.3]],                     # character
        [[-0.5, -0.5, -0.5], [0.5, 0.5, 0.5]],                    # sphere
        [[-0.5, 0.0, -0.5], [0.5, 3.0, 0.5]],                     # tree
    ]
    chunks = None
    if terrain_chunks:
        chunks = chunk_terrain(t, terrain_chunks)
        kept = []
        for c, (cv, _cn, _cf) in enumerate(chunks):
            ei = next_ei
            if ei >= E:
                break            # capacity bound: drop remaining chunks
            e_active[ei] = True
            model_id[ei] = 4 + c
            aabb_rows.append([cv.min(0).tolist(), cv.max(0).tolist()])
            kept.append(chunks[c])
            next_ei += 1
        chunks = kept

    ent = EntityParams(
        active=dev(e_active), model_id=dev(model_id), body=dev(body),
        body_is_char=dev(body_is_char), yoffset=dev(np.zeros(E, f32)),
        parent=dev(np.full(E, -1, np.int32)), skip_culling=dev(skip))
    cfg = SceneConfig(
        world=world, bodies=bodies, entities=ent, char_params=char_params,
        model_aabb=dev(np.array(aabb_rows, f32)),
        limbo_height=dev(np.float32(40.0)), gravity_y=dev(np.float32(-9.8)),
        host=scene_host(host_bodies, np.arange(n_chars)))

    st = engine_state_init(E, n_bodies, n_chars, device="cpu")  # then moved
    for ci in range(n_chars):
        cx = 3.0 * ci
        cy = float(terrain_height_np(t, cx, 0.0))
        st.phys.pos[ci] = torch.tensor(np.array([cx, cy + yoff, 0.0], f32))
    for i, p in enumerate(dyn_pos):
        st.phys.pos[n_chars + i] = torch.tensor(np.array(p, f32))
    st = st._replace(visible=torch.as_tensor(e_active.copy()))
    for ei, (dx, dy, dz) in tree_pos:
        st.pos[ei] = torch.tensor(np.array([dx, dy, dz], f32))
    st = tree_map(lambda x: x.to(device), st)
    return Testbed(cfg=cfg, state0=st, terrain=t, chunks=chunks)


def char_column_mesh(width: float = 0.6, height: float = 2.0,
                     rings: int = 13, segments: int = 10):
    """Skinnable character mesh: a ring column along +y (feet at 0, head at
    ``height``) with a waist/shoulder radius profile, capped by two fans.
    Returns (verts, normals, uvs, faces); uv is a cylindrical unwrap (u =
    angle/2π, v = y/height) whose seam is left as it falls."""
    ys = np.linspace(0.0, height, rings).astype(np.float32)
    tn = ys / height
    # radius profile: ankles → hips bulge → waist → shoulders → head
    prof = 0.22 + 0.16 * np.exp(-((tn - 0.35) / 0.25) ** 2) \
        + 0.10 * np.exp(-((tn - 0.8) / 0.18) ** 2) \
        - 0.06 * tn
    prof = (prof * (width / 0.6)).astype(np.float32)
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    ca, sa = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    verts, normals, uvs = [], [], []
    for yi, r in zip(ys, prof):
        for k, (c, s) in enumerate(zip(ca, sa)):
            verts.append((r * c, yi, r * s))
            normals.append((c, 0.0, s))
            uvs.append((k / segments, yi / height))
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    faces = []
    for k in range(rings - 1):
        for i in range(segments):
            j = (i + 1) % segments
            a, b = k * segments + i, k * segments + j
            c, d = a + segments, b + segments
            faces.extend([[a, c, b], [b, c, d]])
    base = len(verts)
    verts = np.concatenate([verts, np.array(
        [[0, 0, 0], [0, height, 0]], np.float32)])
    normals = np.concatenate([normals, np.array(
        [[0, -1, 0], [0, 1, 0]], np.float32)])
    top0 = (rings - 1) * segments
    for i in range(segments):
        j = (i + 1) % segments
        faces.append([base, i, j])                       # bottom
        faces.append([base + 1, top0 + j, top0 + i])     # top
    uvs = np.concatenate([np.asarray(uvs, np.float32),
                          np.array([[0.5, 0.0], [0.5, 1.0]], np.float32)])
    return verts, normals, uvs, np.asarray(faces, np.int32)


def build_testbed_char_skin(tb: Testbed, models, rt, device=None):
    """CharSkin for the testbed roster: smooth 1-D weights to the demo
    rig's 3-joint chain (joints at y = 0, 0.8, 1.6 — build_demo_rig),
    shared by every char entity (slots 1..n_chars)."""
    from ..render.charskin import build_char_skin, linear_joint_weights

    n_chars = tb.cfg.char_params.body.shape[0]
    w, ji = linear_joint_weights(models[1].verts, np.array([0.0, 0.8, 1.6]))
    return build_char_skin(rt, models[1], w, ji, 3,
                           np.arange(1, 1 + n_chars), device=device)


def testbed_models(tb: Testbed, with_lods: bool = True,
                   terrain_color=(0.35, 0.5, 0.3),
                   skinned_chars: bool = False, textured: bool = False):
    """ModelData list matching the testbed's model-id layout: 0 terrain
    (empty when chunked), 1 character, 2 sphere, 3 tree, then one model per
    terrain chunk with LOD chains.

    skinned_chars: the character is the ring column (char_column_mesh) in
    place of the rigid cube proxy; pair with build_testbed_char_skin.
    textured: uv and texture layers on the character (layer 0) and the
    tree (layer 1), for testbed_textures — the tables then carry
    materials, and the frame takes the per-pixel gather path."""
    from ..render.scenerender import ModelData, model_from_mesh
    from .primitives import cube

    t = tb.terrain
    cv, cn, cu, cf = cube(1.0)
    cv = np.asarray(cv, np.float32)
    cn = np.asarray(cn, np.float32)
    cu = np.asarray(cu, np.float32)
    cf = np.asarray(cf)

    def cube_model(w, h, color, tex_id: int = -1):
        v = cv * np.array([w, h, w], np.float32) \
            + np.array([0, h / 2, 0], np.float32)
        return model_from_mesh(v, cn, cf, base_color=color,
                               with_lods=with_lods,
                               uv=cu if tex_id >= 0 else None, tex_id=tex_id)

    if tb.chunks:
        z3 = np.zeros((0, 3), np.float32)
        terrain_model = ModelData(
            verts=z3, normals=z3, base_color=z3,
            rough_metal=np.zeros((0, 2), np.float32), emission=z3,
            lod_faces=[np.zeros((0, 3), np.uint32)])
    else:
        terrain_model = model_from_mesh(
            t.vx, t.norm, t.idx.reshape(-1, 3),
            base_color=terrain_color, with_lods=False)
    if skinned_chars:
        sv, sn, suv, sf = char_column_mesh(0.6, 2.0)
        char_model = model_from_mesh(
            sv, sn, sf, base_color=(0.8, 0.5, 0.4), with_lods=with_lods,
            uv=suv if textured else None, tex_id=0 if textured else -1)
    else:
        char_model = cube_model(0.6, 2.0, (0.8, 0.5, 0.4),
                                tex_id=0 if textured else -1)
    models = [
        terrain_model,
        char_model,
        cube_model(0.8, 0.8, (0.6, 0.6, 0.7)),
        cube_model(0.8, 3.0, (0.4, 0.3, 0.2), tex_id=1 if textured else -1),
    ]
    for cvv, cnn, cff in (tb.chunks or []):
        models.append(model_from_mesh(cvv, cnn, cff,
                                      base_color=terrain_color,
                                      with_lods=with_lods))
    return models


def testbed_textures(device=None):
    """Procedural TextureSets for testbed_models(textured=True) on
    ``device``: layer 0 a checker (characters), layer 1 bark stripes
    (trees)."""
    from ..render.pipeline import TextureSets

    checker = np.zeros((32, 32, 3), np.float32) + 0.55
    checker[::2, ::2] = (0.95, 0.55, 0.35)
    checker[1::2, 1::2] = (0.95, 0.55, 0.35)
    bark = np.zeros((32, 32, 3), np.float32)
    bark[:] = (0.45, 0.33, 0.2)
    bark[:, ::4] = (0.3, 0.2, 0.12)
    return TextureSets(diffuse=torch.as_tensor(
        np.stack([checker, bark]), device=resolve_device(device)))


def replicate_state(st, n_envs: int):
    """Broadcast one initial state (an EngineState, or any tree of
    tensors such as a GameSessionState) to an env batch (contiguous
    copies)."""
    return tree_map(
        lambda x: x.expand(n_envs, *x.shape).contiguous(), st)


def build_demo_rig(device=None):
    """Small procedural character rig + clips for asset-less demos (the
    reference ships glTF rigs in the absent asset submodules; this stands
    in so every character can animate: a 3-joint chain with looping
    idle/motion/jump/fall clips). Returns (skeleton, library,
    AnimConfig)."""
    device = resolve_device(device)
    from ..anim.clips import PATH_ROTATION, build_library
    from ..anim.joints import build_skeleton
    from ..anim.system import default_state_map

    parent = [-1, 0, 1]
    # inverse bind = inverse of each joint's rest GLOBAL transform, so the
    # rest pose skins to identity — joints sit at y = 0, 0.8, 1.6
    invbind = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for j, y in enumerate((0.0, 0.8, 1.6)):
        invbind[j, 1, 3] = -y
    base_t = np.array([[0, 0, 0], [0, 0.8, 0], [0, 0.8, 0]], np.float32)
    base_r = np.tile(np.array([0, 0, 0, 1], np.float32), (3, 1))
    base_s = np.ones((3, 3), np.float32)
    sk = build_skeleton(parent, invbind, base_t, base_r, base_s, device)

    keys = np.linspace(0.0, 1.0, 8).astype(np.float32)

    def swing(amp, phase=0.0):
        ang = amp * np.sin(2 * np.pi * keys + phase)
        q = np.stack([np.sin(ang / 2), np.zeros_like(ang),
                      np.zeros_like(ang), np.cos(ang / 2)], -1)
        return q.astype(np.float32)

    clips = []
    for amp in (0.1, 0.6, 0.9, 0.4):   # idle, motion, jump, fall
        clips.append([(1, PATH_ROTATION, keys, swing(amp)),
                      (2, PATH_ROTATION, keys, swing(amp, np.pi / 2))])
    lib = build_library(clips, 3, device)
    acfg = default_state_map(["idle", "motion", "jump", "fall"], device)
    return sk, lib, acfg
