"""The port's scene.json loader, content wiring and scene editor against
the JAX package, on the documents the JAX package's tests load: the
authored level demo/level57.json, the two-camera scene
(tests/test_multicam.py), the rotating beam (tests/test_rotating_platform.py),
tests/test_scene_loader.py's scene, the armature scene
(tests/test_camera_wiring.py) and the textured content scene
(tests/test_content.py), plus a variant of the level with euler-rotated,
scaled trimesh entities.

Exact: every integer, bool and float output of load_scene (entity wiring,
body params, char params, camera_char and the camera bank, the rest pose,
the game config, lights, entity names, the baked triangles), save_scene's
JSON, char_armature, scene_render_setup's tables and texture layers, the
editor's selection and mode, and the bridge's copy of a LoadedScene. The
euler rotations (sin/cos in float32) and the triangles baked through
mat4_compose_trs agree bit for bit too, so no load output needs a
tolerance."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))

import assets57
import test_camera_wiring
import test_content
import test_multicam
import test_rotating_platform
import test_scene_loader
from clap_tpu.engine.input import InputRecord as JRecord
from clap_tpu.scene import content as jcontent
from clap_tpu.scene import editor as jeditor
from clap_tpu.scene import loader as jloader
from clap_tpu_torch.bridge import scene_parts_from_numpy, to_numpy
from clap_tpu_torch.engine.input import InputRecord as TRecord
from clap_tpu_torch.scene import assets57 as tassets
from clap_tpu_torch.scene import content as tcontent
from clap_tpu_torch.scene import editor as teditor
from clap_tpu_torch.scene import loader as tloader
from test_torch_common import assert_tree_equal, jnp_tree

LEVEL = Path(__file__).resolve().parents[1] / "demo" / "level57.json"


def _rotated_level():
    """level57 with the switches euler-rotated and scaled, a platform
    rotated by quaternion, and the collision following rotation."""
    doc = json.loads(LEVEL.read_text())
    doc["collision_follows_entities"] = True
    doc["collision_follows_rotation"] = True
    sw = doc["model"][0]["entity"]
    sw[0]["rotation"] = [0.0, 30.0, 10.0]
    sw[0]["scale"] = 1.5
    sw[1]["rotation"] = [-20.0, 75.0, 5.0]
    doc["model"][1]["entity"][2]["rotation"] = [0.0, 0.38268343, 0.0,
                                                0.92387953]
    return json.dumps(doc)


# name → (document, JAX asset loader, port asset loader, load kwargs)
SCENES = {
    "level57": (LEVEL.read_text(), assets57.asset_loader,
                tassets.asset_loader, dict(max_entities=16, max_bodies=4)),
    "level57_rotated": (_rotated_level(), assets57.asset_loader,
                        tassets.asset_loader,
                        dict(max_entities=16, max_bodies=4)),
    "multicam": (test_multicam.SCENE, test_multicam._loader,
                 test_multicam._loader, dict(max_entities=8, max_bodies=4)),
    "rotating_beam": (json.dumps(test_rotating_platform.SCENE),
                      test_rotating_platform._loader,
                      test_rotating_platform._loader,
                      dict(max_entities=8, max_bodies=2)),
    "scene_loader": (json.dumps(test_scene_loader.SCENE),
                     test_scene_loader._loader, test_scene_loader._loader,
                     {}),
    "armature": (json.dumps(test_camera_wiring.ARMATURE_SCENE),
                 test_scene_loader._loader, test_scene_loader._loader,
                 dict(max_entities=4, max_bodies=2)),
    "content": (test_content.SCENE, test_content._loader,
                test_content._loader, dict(max_entities=8, max_bodies=4)),
}
_CACHE = {}


def _load(name):
    if name not in _CACHE:
        doc, jl, tl, kw = SCENES[name]
        _CACHE[name] = (jloader.load_scene(doc, asset_loader=jl, **kw),
                        tloader.load_scene(doc, asset_loader=tl,
                                           device="cpu", **kw))
    return _CACHE[name]


@pytest.mark.parametrize("part", ["cfg", "state0", "lights", "game"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_scene_exact(name, part):
    J, T = _load(name)
    ref, got = jnp_tree(getattr(J, part)), getattr(T, part)
    if ref is None:
        assert got is None
        return
    assert_tree_equal(ref, to_numpy(got), f"{name}.{part}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_load_scene_host_facts_exact(name):
    J, T = _load(name)
    for f in ("name", "entity_names", "char_entities", "char_models",
              "char_heights", "doc"):
        assert getattr(J, f) == getattr(T, f), f
    assert len(J.models) == len(T.models)
    for mj, mt in zip(J.models, T.models):
        assert (mj.name, mj.physics, mj.images, mj.tex_source,
                mj.joint_types) == (mt.name, mt.physics, mt.images,
                                    mt.tex_source, mt.joint_types)
        assert (mj.rig is None) == (mt.rig is None)
        if mj.rig is not None:
            assert mj.rig[2] == mt.rig[2]
            np.testing.assert_array_equal(mt.rig[3], mj.rig[3])
    # the scene's host facts: what the step branches on, from the host
    host = T.cfg.host
    assert host.char_body == tuple(int(b) for b in
                                   np.asarray(J.cfg.char_params.body))
    arm_j = J.char_armature()
    arm_t = T.char_armature(device="cpu")
    assert sorted(arm_j) == sorted(arm_t)
    for k in arm_j:
        a, b = np.asarray(arm_j[k]), arm_t[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_level57_shape():
    """The authored level at its own scale: 16 entity slots, 4 bodies, 2
    characters, 2 cameras, 84 collision triangles, no rest pose (no
    platform moves from its load pose)."""
    _, T = _load("level57")
    cfg = T.cfg
    assert cfg.entities.active.shape == (16,)
    assert int(cfg.entities.active.sum()) == 10
    assert cfg.bodies.active.shape == (4,)
    assert cfg.char_params.body.tolist() == [0, 1]
    assert T.state0.cameras.pitch.shape == (2,)
    assert cfg.camera_char.tolist() == [-1, 1]
    assert cfg.world.tris.shape == (84, 3, 3)
    assert cfg.ent_rest_pos is None and cfg.ent_rest_rot is None
    assert T.game.switch_entity.tolist() == [0, 1]


@pytest.mark.parametrize("name", ["level57", "multicam", "scene_loader"])
def test_save_scene_exact(name):
    J, T = _load(name)
    assert tloader.save_scene(T) == jloader.save_scene(J)


def test_bridge_scene_parts_exact():
    """A JAX LoadedScene's pieces through the bridge equal the port's own
    load of the same document."""
    J, T = _load("level57")
    parts = scene_parts_from_numpy(
        {"cfg": jnp_tree(J.cfg), "state0": jnp_tree(J.state0),
         "lights": jnp_tree(J.lights), "game": jnp_tree(J.game),
         "armature": {k: np.asarray(v)
                      for k, v in J.char_armature().items()}}, "cpu")
    for k in ("cfg", "state0", "lights", "game"):
        assert_tree_equal(to_numpy(getattr(T, k)), to_numpy(parts[k]), k)
    assert parts["cfg"].host == T.cfg.host
    arm = T.char_armature(device="cpu")
    for k, v in parts["armature"].items():
        assert torch.equal(v, arm[k]), k


@pytest.mark.parametrize("name", ["level57", "content"])
def test_scene_render_setup_exact(name):
    """The render tables (every field) and the texture layers of the
    scene's glTF materials."""
    J, T = _load(name)
    rt_j, ts_j = jcontent.scene_render_setup(J, tex_size=16, with_lods=False)
    rt_t, ts_t = tcontent.scene_render_setup(T, tex_size=16, with_lods=False,
                                             device="cpu")
    assert_tree_equal(jnp_tree(rt_j), to_numpy(rt_t), "tables")
    assert_tree_equal(jnp_tree(ts_j), to_numpy(ts_t), "textures")


def test_vertex_normals_exact():
    rng = np.random.default_rng(5)
    v = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (60, 3)).astype(np.uint32)
    np.testing.assert_array_equal(tcontent.vertex_normals(v, f),
                                  jcontent.vertex_normals(v, f))


def _editor_pair():
    J, T = _load("level57")
    return (jeditor.SceneEditor(J), J.state0), (teditor.SceneEditor(T),
                                                T.state0)


# (record fields) sequences that walk every mode of the editor
SCRIPT = [dict(right=True), dict(edit_toggle=True), dict(tab=True),
          dict(right=True), dict(down=True, pitch_up=True),
          dict(tab=True, shift=True), dict(tab=True), dict(tab=True),
          dict(enter=True), dict(right=True), dict(left=True),
          dict(enter=True), dict(right=True), dict(left=True),
          dict(enter=True), dict(space=True), dict(right=True),
          dict(enter=True), dict(up=True), dict(edit_toggle=True),
          dict(left=True)]


def test_editor_routing_exact():
    """The editor's selection, mode, consumption and status after each
    record are the JAX package's; the edited state is held exact (an edit
    rebuilds one slot's matrix through mat4_compose_trs)."""
    (ej, sj), (et, stt) = _editor_pair()
    for rec in SCRIPT:
        sj, cj = ej.handle_input(JRecord(**rec), sj)
        stt, ct = et.handle_input(TRecord(**rec), stt)
        assert cj == ct, rec
        assert (ej.sel, ej.mode, ej.active, ej.status()) \
            == (et.sel, et.mode, et.active, et.status()), rec
    for f in ("pos", "rot", "scale", "visible", "mx"):
        np.testing.assert_array_equal(getattr(stt, f).numpy(),
                                      np.asarray(getattr(sj, f)), err_msg=f)
    assert et.save(stt) == ej.save(sj)


def test_edit_entity_matrices_exact():
    (_, sj), (_, stt) = _editor_pair()
    q = np.array([0.0, 0.6, 0.0, 0.8], np.float32)
    rj = jeditor.edit_entity(sj, 3, pos=[1.0, 2.0, 3.0], rot=q, scale=2.5,
                             visible=True)
    rt = teditor.edit_entity(stt, 3, pos=[1.0, 2.0, 3.0], rot=q, scale=2.5,
                             visible=True)
    for f in ("pos", "rot", "scale", "visible", "mx"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert not torch.equal(rt.mx, stt.mx)


def test_editor_edits_every_env_of_a_batch():
    """On a batched state an edit applies to every env, and each env's
    slot equals the unbatched edit."""
    from clap_tpu_torch.scene.testbed import replicate_state

    (_, _), (et, stt) = _editor_pair()
    et.active, et.sel = True, 4
    one = et.nudge(stt, 0.5, 0.0, -0.25)
    one = et.rotate_yaw(one, 0.3)
    one = et.rescale(one, 0.8)
    many = replicate_state(stt, 3)
    many = et.nudge(many, 0.5, 0.0, -0.25)
    many = et.rotate_yaw(many, 0.3)
    many = et.rescale(many, 0.8)
    many = et.toggle_visible(many)
    for f in ("pos", "rot", "scale", "mx"):
        for b in range(3):
            assert torch.equal(getattr(many, f)[b], getattr(one, f)), f
    assert (many.visible[:, 4] != stt.visible[4]).all()
    assert json.loads(et.save(many, env=2)) == json.loads(
        et.save(many, env=0))
