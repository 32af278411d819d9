"""scene.json loader (counterpart of clap_tpu/scene/loader.py; reference:
scene.c:1318-1924 model_new_from_json / scene_onload / scene_load).

Host-side scene ingestion with the reference's schema:

- ``model[]``: {name, gltf, physics: {geom, mass, bounce, bounce_vel,
  yoffset, radius}, entity[]/character[]: {position [x,y,z], rotation,
  scale, attach, speed, jump_forward, jump_upward, switch, platform},
  armature semantic-joint mapping, animation renames}
- ``camera[]``: {pitch, yaw, dist, character} (≤4 slots)
- ``light[]``: {position, color, attenuation, direction, cutoff}
- scene-level: name, limbo_height, connect_radius,
  collision_follows_entities, collision_follows_rotation

The scene is built on the host in numpy (the JAX package's ``.at[].set``
chains are numpy writes here) and moved to ``device`` once, as
``scene/testbed.py`` does: the SceneConfig (with ``host`` filled), the
unbatched EngineState template (``testbed.replicate_state`` adds the env
axis), lights, the GameConfig of the level's gameplay blocks, and the
models' meshes and rigs. ``save_scene`` re-serializes the same schema
(scene.c:1891-1922).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import mathx as mx
from ..bridge import tree_map
from ..char.controller import CharParams
from ..device import resolve_device
from ..engine.gamelogic import GameConfig
from ..engine.state import (EngineState, EntityParams, SceneConfig,
                            engine_state_init, scene_host)
from ..physics.heightfield import make_heightfield
from ..physics.narrowphase import make_world
from ..physics.world import (body_params_empty, capsule_auto_size,
                             finalize_inertia)
from ..render.lights import Lights
from .gltf import build_rig, find_collision_mesh, load_gltf, resolve_armature

GEOM_CLASSES = {"sphere": 1, "capsule": 2, "trimesh": 3}


@dataclass
class LoadedModel:
    name: str
    mesh: object
    collision: object
    rig: tuple | None                # (Skeleton, AnimLibrary, names, remap)
    materials: list
    physics: dict = field(default_factory=dict)
    images: list = field(default_factory=list)       # raw PNG bytes
    tex_source: list = field(default_factory=list)   # texture→image idx
    joint_types: dict = field(default_factory=dict)  # semantic → joint idx
                                                     # (model.h:30-38, from
                                                     # the "armature" block)


@dataclass
class LoadedScene:
    name: str
    cfg: SceneConfig
    state0: EngineState            # unbatched template
    lights: Lights
    models: list
    doc: dict                      # retained JSON DOM for save_scene
    entity_names: list = field(default_factory=list)
    game: object = None            # GameConfig when the scene declares
                                   # switch/platform gameplay blocks
    char_entities: list = field(default_factory=list)  # entity per char
    char_models: list = field(default_factory=list)    # model per char
    char_heights: list = field(default_factory=list)   # AABB y per char

    def char_armature(self, device=None):
        """Per-character semantic joints for GameWorld, on ``device`` (the
        card unless named): each character's model "armature" block
        resolved to (C,) joint indices (camera head target
        camera.c:174-206, footstep hooks). A dict of head_joint /
        foot_left / foot_right / char_entity (int32) and char_height
        (float32); -1 where the model exposes no such joint."""
        device = resolve_device(device)
        C = max(len(self.char_entities), 1)

        def sem(which):
            vals = [self.models[m].joint_types.get(which, -1)
                    for m in self.char_models] or [-1]
            return vals + [-1] * (C - len(vals))

        def pad(vals, fill):
            return (vals or [fill]) + [fill] * (C - max(len(vals), 1))

        def t(x, dtype):
            return torch.tensor(x, dtype=dtype, device=device)

        return {
            "head_joint": t(sem("head"), torch.int32),
            "foot_left": t(sem("foot_left"), torch.int32),
            "foot_right": t(sem("foot_right"), torch.int32),
            "char_entity": t(pad(self.char_entities, 0), torch.int32),
            "char_height": t(np.asarray(pad(self.char_heights, 2.0),
                                        np.float32), torch.float32),
        }


def _mat4_from_trs(pos, rot, scale) -> np.ndarray:
    """The entity's world matrix T·R·S (model.c:1670-1676) as float32
    numpy, through the port's mathx on the CPU."""
    return mx.mat4_compose_trs(torch.as_tensor(np.asarray(pos, np.float32)),
                               torch.as_tensor(np.asarray(rot, np.float32)),
                               torch.tensor(scale, dtype=torch.float32)
                               ).numpy()


def _euler_quat(deg) -> np.ndarray:
    """scene.json's euler-degree rotation as a quaternion
    (quat_from_euler_xyz, float32 on the CPU)."""
    r = torch.as_tensor(np.deg2rad(np.array(deg, np.float32)))
    return mx.quat_from_euler_xyz(r[0], r[1], r[2]).numpy()


def _load_model(mentry, asset_loader, device) -> LoadedModel:
    mesh = coll = rig = None
    materials, images, tex_source = [], [], []
    joint_types = {}
    if asset_loader is not None and mentry.get("gltf"):
        gdoc = load_gltf(asset_loader(mentry["gltf"]))
        mesh, coll = find_collision_mesh(gdoc)
        materials = gdoc.materials
        images = gdoc.images
        tex_source = gdoc.textures
        if gdoc.skins:
            rig = build_rig(gdoc, device=device)
            # "armature": {"head": "<joint name>", ...} → semantic slots
            # (scene.c:1474-1492, model.h:30-38)
            joint_types = resolve_armature(
                gdoc, mentry.get("armature", {}), rig[3])
            # "animations": {"motion": "<gltf clip name>", ...} renames
            # exporter clips to the state machine's names
            # (scene.c:1662-1684)
            renames = mentry.get("animations", {})
            if renames:
                sk_r, lib_r, names_r, remap_r = rig
                names_r = list(names_r)
                for new_name, gltf_name in renames.items():
                    if gltf_name in names_r:
                        names_r[names_r.index(gltf_name)] = new_name
                rig = (sk_r, lib_r, names_r, remap_r)
    return LoadedModel(
        name=mentry.get("name", mentry.get("gltf", "model")),
        mesh=mesh, collision=coll, rig=rig, materials=materials,
        physics=mentry.get("physics", {}), images=images,
        tex_source=tex_source, joint_types=joint_types)


def load_scene(doc_json: str, asset_loader=None, heightfield=None,
               max_entities: int = 64, max_bodies: int = 16,
               max_lights: int = 8, device=None) -> LoadedScene:
    """Parse a scene.json document into the port's structures on
    ``device`` (the card unless named).

    asset_loader(name) → raw glTF bytes for ``gltf`` refs (the librarian
    analogue, librarian.h:39-43); ``heightfield`` (a Heightfield on
    ``device``) optionally supplies terrain, else a flat 1,024² field."""
    device = resolve_device(device)
    doc = json.loads(doc_json)
    f32 = np.float32

    models = []
    entities = []      # (model_idx, entity_dict, is_char)
    for mentry in doc.get("model", []):
        mi = len(models)
        models.append(_load_model(mentry, asset_loader, device))
        for e in mentry.get("entity", []):
            entities.append((mi, e, False))
        for c in mentry.get("character", []):
            entities.append((mi, c, True))
    n_chars = sum(1 for _, _, ic in entities if ic)

    # cameras (≤4 slots, scene.h:40 NR_CAMERAS_MAX): {pitch, yaw, dist,
    # character}; character -1 follows the controlled one
    cam_entries = doc.get("camera", [])[:4]
    n_cameras = len(cam_entries)

    E = max_entities
    bodies = body_params_empty(max_bodies)
    e_active = np.zeros(E, bool)
    model_id = np.zeros(E, np.int32)
    e_body = np.full(E, -1, np.int32)
    body_is_char = np.zeros(E, bool)
    e_yoffset = np.zeros(E, f32)
    parent = np.full(E, -1, np.int32)

    st = engine_state_init(E, max_bodies, max(n_chars, 1),
                           n_cameras=n_cameras, device="cpu")
    pos_e = st.pos.numpy()
    rot_e = st.rot.numpy()
    scale_e = st.scale.numpy()
    visible = st.visible.numpy()
    body_pos = st.phys.pos.numpy()
    if n_cameras:
        cams = st.cameras._replace(
            pitch=torch.tensor([float(c.get("pitch", -0.3))
                                for c in cam_entries], dtype=torch.float32),
            yaw=torch.tensor([float(c.get("yaw", 0.0))
                              for c in cam_entries], dtype=torch.float32),
            dist=torch.tensor([float(c.get("dist", 8.0))
                               for c in cam_entries], dtype=torch.float32))
        st = st._replace(cameras=cams, camera=type(cams)(
            *(x[0].clone() for x in cams)))

    char_bodies, char_speeds, char_jf, char_ju = [], [], [], []
    char_entities = []     # entity slot per char (for head-joint riding)
    char_models = []       # model idx per char (armature semantics)
    char_heights = []      # AABB height per char (camera_target ¾/0.2·h)
    entity_names = []
    name_to_idx = {}
    body_slot = 0
    tris_accum, tri_ent_accum = [], []
    # gameplay blocks (the ldjam57 wiring as data, main.c:82-138):
    #   entity: {"switch": {"group": g, "permanent": bool}}
    #   entity: {"platform": {"group": g, "on_pos": [x,y,z]}}
    switches = []                  # (entity_idx, group, permanent)
    platforms = []                 # (entity_idx, group, on_pos)

    for ei, (mi, e, is_char) in enumerate(entities):
        if ei >= E:
            break
        lm = models[mi]
        pos = np.array(e.get("position", [0, 0, 0]), f32)
        scale = float(e.get("scale", 1.0))
        rot = e.get("rotation", [0, 0, 0, 1])
        if len(rot) == 3:  # euler degrees (scene.json convention)
            rot = _euler_quat(rot)
        rot = np.array(rot, f32)

        ename = e.get("name", f"{lm.name}.{ei}")
        entity_names.append(ename)
        name_to_idx[ename] = ei
        e_active[ei] = True
        model_id[ei] = mi
        pos_e[ei] = pos
        rot_e[ei] = rot
        scale_e[ei] = scale
        visible[ei] = True

        sw = e.get("switch")
        if sw is not None:
            switches.append((ei, int(sw.get("group", 0)),
                             bool(sw.get("permanent", False))))
        pf = e.get("platform")
        if pf is not None:
            platforms.append((ei, int(pf.get("group", 0)),
                              pf.get("on_pos", [float(x) for x in pos])))

        phys = lm.physics
        geom = GEOM_CLASSES.get(phys.get("geom", ""), 0)
        if not ((geom or is_char) and body_slot < max_bodies):
            continue
        coll_mesh = lm.collision if lm.collision is not None else lm.mesh
        if geom == 3 and coll_mesh is not None:
            # static trimesh baked into world space; the named "collision"
            # mesh wins, else the render mesh serves (scene.c:1392-1421)
            m = _mat4_from_trs(pos, rot, scale)
            v = coll_mesh.verts @ m[:3, :3].T + m[:3, 3]
            tv = v[coll_mesh.indices.reshape(-1, 3)]
            tris_accum.append(tv)
            tri_ent_accum.append(np.full((tv.shape[0],), ei, np.int32))
            continue
        aabb = (1.0, 2.0, 1.0)
        if lm.mesh is not None:
            ext = lm.mesh.verts.max(0) - lm.mesh.verts.min(0)
            aabb = tuple(np.maximum(ext * scale, 1e-3))
        r, hl, yoff, ray_off = capsule_auto_size(
            *aabb, geom_radius=phys.get("radius", 0.0) * scale,
            geom_offset=phys.get("yoffset", 0.0) * scale)
        bi = body_slot
        bodies.active[bi] = True
        bodies.kinematic[bi] = is_char
        bodies.radius[bi] = r
        bodies.half_len[bi] = hl
        bodies.yoffset[bi] = yoff
        bodies.ray_off[bi] = ray_off
        bodies.mass[bi] = phys.get("mass", 1.0)
        bodies.bounce[bi] = phys.get("bounce", 0.0)
        bodies.bounce_vel[bi] = phys.get("bounce_vel", 0.0)
        e_body[ei] = bi
        body_is_char[ei] = is_char
        e_yoffset[ei] = yoff
        body_pos[bi] = pos + np.array([0, yoff, 0], f32)
        if is_char:
            char_bodies.append(bi)
            aabb_y = aabb[1]
            char_speeds.append(aabb_y * float(e.get("speed", 1.2)))
            char_jf.append(float(e.get("jump_forward", 1.2)))
            char_ju.append(float(e.get("jump_upward", 5.0)))
            char_entities.append(ei)
            char_models.append(mi)
            char_heights.append(float(aabb_y))
        body_slot += 1

    bodies = finalize_inertia(bodies)

    # attachments (second pass: parent by name, scene.c:1594-1641)
    for ei, (_mi, e, _) in enumerate(entities[:E]):
        att = e.get("attach")
        if att and att in name_to_idx:
            parent[ei] = name_to_idx[att]

    # lights (scene.c:1726-1815)
    L = max_lights
    lpos = np.zeros((L, 3), f32)
    lcolor = np.zeros((L, 3), f32)
    latt = np.tile(np.array([1.0, 0.0, 0.0], f32), (L, 1))
    ldir = np.zeros((L, 3), f32)
    lcut = np.full(L, -2.0, f32)
    lis_dir = np.zeros(L, bool)
    lactive = np.zeros(L, bool)
    for li, lt in enumerate(doc.get("light", [])[:L]):
        direc = np.array(lt.get("direction", [0, -1, 0]), f32)
        direc = direc / max(np.linalg.norm(direc), 1e-6)
        lpos[li] = np.array(lt.get("position", [0, 0, 0]), f32)
        lcolor[li] = np.array(lt.get("color", [1, 1, 1]), f32)
        latt[li] = np.array(lt.get("attenuation", [1, 0, 0]), f32)
        ldir[li] = direc
        lcut[li] = float(lt.get("cutoff", -2.0))
        lis_dir[li] = bool(lt.get("directional", False)) or "direction" in lt
        lactive[li] = True

    if heightfield is None:
        flat = np.zeros((9, 9), f32)
        nrm = np.zeros((9, 9, 3), f32)
        nrm[..., 1] = 1
        heightfield = make_heightfield(flat, nrm, [-512.0, -512.0], 1024.0,
                                       device=device)
    tris = np.concatenate(tris_accum) if tris_accum else None
    tri_ents = np.concatenate(tri_ent_accum) if tri_ent_accum else None
    # the terrain heightfield is not a scene.json entity: its ground id is
    # -1, not entity slot 0 (standing on the ground must not read as
    # standing on the first entity and trip its switch block)
    world = make_world(heightfield, tris, tri_entity=tri_ents, hf_entity=-1)

    cb = np.asarray(char_bodies or [0], np.int32)
    char_params = CharParams(
        body=cb, lin_speed=np.asarray(char_speeds or [2.0], f32),
        jump_forward=np.asarray(char_jf or [1.2], f32),
        jump_upward=np.asarray(char_ju or [5.0], f32),
        can_dash=np.ones(max(n_chars, 1), bool))

    model_aabb = np.tile(np.array([[[-1, -1, -1], [1, 1, 1]]], f32),
                         (max(len(models), 1), 1, 1))
    for mi, lm in enumerate(models):
        if lm.mesh is not None:
            model_aabb[mi, 0] = lm.mesh.verts.min(0)
            model_aabb[mi, 1] = lm.mesh.verts.max(0)

    # entity-following trimesh: only pay for per-env moved collision
    # triangles when some tri-owning entity can move — a platform whose
    # active position differs from its load pose (on_pos), or a scene
    # that opts in explicitly; the test reads host positions
    rest_pos = rest_rot = None
    if tri_ents is not None:
        tri_owner = set(int(x) for x in tri_ents.tolist())
        movable = bool(doc.get("collision_follows_entities", False))
        for ei, _grp, on_pos in platforms:
            if ei in tri_owner and not np.allclose(
                    np.asarray(on_pos, f32), pos_e[ei]):
                movable = True
        if movable:
            rest_pos = pos_e.copy()
            # "collision_follows_rotation": the full entity transform
            # (rotating platforms, physics.c:789-811)
            if bool(doc.get("collision_follows_rotation", False)):
                rest_rot = rot_e.copy()

    game = None
    if switches or platforms:
        K = max(len(switches), 1)
        sw_ent = np.zeros(K, np.int32)
        sw_perm = np.zeros(K, bool)
        sw_grp = np.zeros(K, np.int32)
        sw_valid = np.zeros(K, bool)
        pgroup = np.full(E, -1, np.int32)
        on_pos = np.zeros((E, 3), f32)
        for k, (ei, grp, perm) in enumerate(switches):
            sw_ent[k], sw_grp[k], sw_perm[k], sw_valid[k] = ei, grp, perm, \
                True
        for ei, grp, op in platforms:
            pgroup[ei] = grp
            on_pos[ei] = np.asarray(op, f32)
            # platform groups start OFF: invisible (and, through the
            # visibility→collision coupling, phantom) until a switch
            # turns the group on
            visible[ei] = False
        game = GameConfig(
            switch_entity=sw_ent, switch_permanent=sw_perm,
            switch_group=sw_grp, switch_valid=sw_valid,
            platform_group=pgroup, platform_on_pos=on_pos,
            connect_radius=np.float32(doc.get("connect_radius", 3.0)))

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)

    ent = EntityParams(
        active=e_active, model_id=model_id, body=e_body,
        body_is_char=body_is_char, yoffset=e_yoffset, parent=parent,
        skip_culling=np.zeros(E, bool))
    cfg = SceneConfig(
        world=world, bodies=tree_map(dev, bodies),
        entities=tree_map(dev, ent), char_params=tree_map(dev, char_params),
        model_aabb=dev(model_aabb),
        limbo_height=dev(f32(doc.get("limbo_height", 40.0))),
        gravity_y=dev(f32(-9.8)),
        camera_char=dev(np.asarray(
            [int(c.get("character", -1)) for c in cam_entries], np.int32))
        if n_cameras else None,
        ent_rest_pos=None if rest_pos is None else dev(rest_pos),
        ent_rest_rot=None if rest_rot is None else dev(rest_rot),
        host=scene_host(bodies, cb))
    lights = Lights(pos=lpos, color=lcolor, attenuation=latt,
                    direction=ldir, cutoff=lcut, is_dir=lis_dir,
                    active=lactive)
    return LoadedScene(
        name=doc.get("name", "scene"), cfg=cfg,
        state0=tree_map(lambda x: x.to(device), st),
        lights=tree_map(dev, lights), models=models, doc=doc,
        entity_names=entity_names,
        game=None if game is None else tree_map(dev, game),
        char_entities=char_entities, char_models=char_models,
        char_heights=char_heights)


def save_scene(scene: LoadedScene) -> str:
    """scene_save (scene.c:1891-1922): re-serialize the retained DOM with
    the template state's entity positions written back."""
    doc = json.loads(json.dumps(scene.doc))  # deep copy
    ei = 0
    pos = scene.state0.pos.detach().cpu().numpy()
    for mentry in doc.get("model", []):
        for key in ("entity", "character"):
            for e in mentry.get(key, []):
                if ei < pos.shape[0]:
                    e["position"] = [float(x) for x in pos[ei]]
                ei += 1
    return json.dumps(doc, indent=2)
