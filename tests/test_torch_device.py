"""The port's public builders make their tensors on the CUDA card unless
the caller names another device: with no card, a builder called without
a device raises where it makes its first tensor and builds nothing on the
CPU; with one, it builds on ``cuda``."""
import numpy as np
import pytest
import torch

from clap_tpu_torch.anim.clips import PATH_ROTATION, build_library
from clap_tpu_torch.anim.joints import build_skeleton
from clap_tpu_torch.anim.system import anim_instances_init
from clap_tpu_torch.bridge import from_numpy
from clap_tpu_torch.char.motion import camera_yaw_quat, motion_compute_ls
from clap_tpu_torch.device import resolve_device
from clap_tpu_torch.engine.gamelogic import game_config_empty, game_state_init
from clap_tpu_torch.engine.state import engine_state_init
from clap_tpu_torch.engine.step import Inputs, inputs_zero
from clap_tpu_torch.ops.ca2d import CA_TEST, ca2d_seed
from clap_tpu_torch.ops.noise import blue_noise2d
from clap_tpu_torch.render.lut import bake_lut, lut_find
from clap_tpu_torch.render.post import ssao_kernel
from clap_tpu_torch.render.lights import lights_empty
from clap_tpu_torch.render.raster import (expand_corners_major,
                                          expand_corners_record)
from clap_tpu_torch.render.scenerender import build_render_tables
from clap_tpu_torch.render.texture import upload_texture
from clap_tpu_torch.scene import testbed as ttb
from clap_tpu_torch.scene.voxel import cave_scene
from test_torch_common import ENTRY_SCENE


def test_resolve_device():
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def _one_tensor(out):
    """The first tensor of a builder's result (a tree or a tuple)."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        for x in out:
            t = _one_tensor(x)
            if t is not None:
                return t
    return None


def _char_skin_on_default_device():
    """build_testbed_char_skin without a device, over CPU tables."""
    tb = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    models = ttb.testbed_models(tb, skinned_chars=True)
    ent = tb.cfg.entities
    rt = build_render_tables(models, ent.model_id, ent.active, device="cpu")
    return ttb.build_testbed_char_skin(tb, models, rt)


def _chip_smoke():
    import chip_smoke

    return chip_smoke


def _level(device=None):
    """demo/level57.json through the port's loader."""
    from pathlib import Path

    from clap_tpu_torch.scene.assets57 import asset_loader
    from clap_tpu_torch.scene.loader import load_scene

    doc = (Path(__file__).resolve().parents[1] / "demo"
           / "level57.json").read_text()
    return load_scene(doc, asset_loader=asset_loader, max_entities=16,
                      max_bodies=4, device=device)


def _skinned_rig():
    from clap_tpu_torch.scene.gltf import build_rig, load_gltf
    from test_gltf import make_skinned_gltf

    return build_rig(load_gltf(make_skinned_gltf()))


def _record_to_inputs():
    from clap_tpu_torch.engine.input import InputRecord, record_to_inputs

    return record_to_inputs(InputRecord(right=True), 0.3, 2.0, 2)


def _level_render_setup():
    from clap_tpu_torch.scene.content import scene_render_setup

    return scene_render_setup(_level("cpu"), tex_size=8, with_lods=False)


def _scene_parts():
    from clap_tpu_torch.bridge import scene_parts_from_numpy

    return scene_parts_from_numpy(
        {"armature": {"head_joint": np.zeros(1, np.int32)}})


def _engine_state():
    """The Engine's state after one frame over a CPU scene, with no device
    named: the Engine moves the scene and its state to its device."""
    from clap_tpu_torch.engine.core import ClapConfig, Engine

    tb = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    eng = Engine(ClapConfig(settings=False), tb.cfg, tb.state0)
    eng.frame()
    return eng.state


def _fuzz_batch():
    from clap_tpu_torch.engine.fuzzer import fuzz_batch

    return fuzz_batch(0, 3, 4)


def _demo_world():
    from clap_tpu_torch.demo.testbed import build_world

    return build_world(render=False, scene=dict(nr_v=12, side=16.0))["tb"]


_KEYS = np.linspace(0.0, 1.0, 4).astype(np.float32)
_Q = np.tile(np.array([0, 0, 0, 1], np.float32), (4, 1))

# every public builder of the port, without a device argument
def _multichip_world():
    """The sharded dryrun's world (its state) without a device."""
    from clap_tpu_torch.parallel.multichip import multichip_world

    return multichip_world(2)["gs"]


BUILDERS = {
    "build_testbed": lambda: ttb.build_testbed(**ENTRY_SCENE),
    "build_demo_rig": ttb.build_demo_rig,
    "cave_scene": lambda: cave_scene(8, 8, 8, seed=5, ca_rule=2,
                                     ca_steps=1),
    "ca2d_seed": lambda: ca2d_seed(CA_TEST, (8, 8)),
    "build_render_tables": lambda: build_render_tables(
        [], np.zeros(2, np.int32), np.zeros(2, bool)),
    "lights_empty": lambda: lights_empty(2),
    "inputs_zero": lambda: inputs_zero(2),
    "game_config_empty": lambda: game_config_empty(1, 4),
    "game_state_init": lambda: game_state_init(1, 2),
    "engine_state_init": lambda: engine_state_init(4, 2, 1),
    "anim_instances_init": lambda: anim_instances_init(2),
    "build_library": lambda: build_library(
        [[(1, PATH_ROTATION, _KEYS, _Q)]], 2),
    "build_skeleton": lambda: build_skeleton(
        [-1, 0], np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
        np.zeros((2, 3), np.float32), _Q[:2], np.ones((2, 3), np.float32)),
    "testbed_textures": ttb.testbed_textures,
    "upload_texture": lambda: upload_texture(np.zeros((2, 2, 4), np.uint8)),
    "build_char_skin": _char_skin_on_default_device,
    "expand_corners_record": lambda: expand_corners_record(
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2]])),
    "expand_corners_major": lambda: expand_corners_major(
        np.zeros((3, 3), np.float32), np.array([[0, 1, 2]])),
    "build_full_frame": lambda: _chip_smoke().build_full_frame(
        None, nr_v=12, width=64, height=48),
    "build_batched": lambda: _chip_smoke().build_batched(None, 2, 32),
    "build_game_frame": lambda: _chip_smoke().build_game_frame(
        None, 64, 32, scene=dict(nr_v=12, side=16.0, max_entities=32)),
    "blue_noise2d": lambda: blue_noise2d(),
    "blue_noise2d_of_draws": lambda: blue_noise2d(
        4, np.zeros((3, 4, 4), np.float32)),
    "ssao_kernel": lambda: ssao_kernel(),
    "bake_lut": lambda: bake_lut(lut_find("identity"), 4),
    "load_scene": lambda: _level(),
    "char_armature": lambda: _level("cpu").char_armature(),
    "build_rig": _skinned_rig,
    "record_to_inputs": _record_to_inputs,
    "motion_compute_ls": lambda: motion_compute_ls(0, 1, 1, 0),
    "camera_yaw_quat": lambda: camera_yaw_quat(0.3),
    "scene_render_setup": _level_render_setup,
    "scene_parts_from_numpy": _scene_parts,
    "build_level": lambda: _chip_smoke().build_level(None, 2),
    "Engine": _engine_state,
    "fuzz_batch": _fuzz_batch,
    "demo_build_world": _demo_world,
    "multichip_world": lambda: _multichip_world(),
    "from_numpy": lambda: from_numpy(Inputs(
        motion=np.zeros((1, 2), np.float32), jump=np.zeros(1, bool),
        cam_delta=np.zeros(3, np.float32), dash=np.zeros(1, bool))),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_defaults_to_the_card(name):
    """With a card, the builder's tensors are on it; without one, the call
    raises (torch refuses the CUDA tensor) instead of building on the
    CPU."""
    if torch.cuda.is_available():
        out = BUILDERS[name]()
        if name == "cave_scene":            # numpy out; the CA ran on cuda
            assert out[0].shape == (8, 8, 8)
        else:
            assert _one_tensor(out).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError),
                           match="CUDA|cuda"):
            BUILDERS[name]()


def test_builder_on_the_cpu_when_asked():
    tb = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    assert tb.state0.phys.pos.device.type == "cpu"
    assert tb.cfg.world.hf.heights.device.type == "cpu"
