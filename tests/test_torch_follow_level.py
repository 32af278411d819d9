"""Static-trimesh collision that follows its entity by translation on the
authored level (tests/test_level57.py:117-149) on the port against the
JAX package: plat.1 given an ``on_pos`` a unit above its load pose, so the
loader sets the rest pose. Env 0 raises the platform to its active
position, env 1 leaves it at its load pose (both visible); character 0
drops onto it from a foot height of 2.5 (the JAX test's 4, cut with its
frame count to 40 frames of no input). The JAX package steps each env
with its unbatched jitted step (XLA takes about a minute to compile the
level's contact solve). Int and bool fields exact, floats within atol
1e-4 + rtol 1e-4."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))

import assets57
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu.scene.testbed import replicate_state as jreplicate
from clap_tpu_torch.scene import assets57 as tassets
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import replicate_state
from test_torch_common import assert_tree_close, engine_trajectories

LEVEL = Path(__file__).resolve().parents[1] / "demo" / "level57.json"
FRAMES = 40


@pytest.fixture(scope="module")
def run():
    doc = json.loads(LEVEL.read_text())
    doc["model"][1]["entity"][1]["platform"]["on_pos"] = [9.0, 1.2, 0.0]
    doc = json.dumps(doc)
    kw = dict(max_entities=16, max_bodies=4)
    J = jload(doc, asset_loader=assets57.asset_loader, **kw)
    T = load_scene(doc, asset_loader=tassets.asset_loader, device="cpu",
                   **kw)
    assert T.cfg.ent_rest_pos is not None and T.cfg.ent_rest_rot is None
    yoff = float(T.cfg.bodies.yoffset[0])
    body = np.array([9.0, 2.5 + yoff, 0.0], np.float32)
    plat = np.array([[9.0, 1.2, 0.0], [9.0, 0.2, 0.0]], np.float32)
    js = jreplicate(J.state0, 2)
    js = js._replace(
        pos=js.pos.at[:, 3].set(jnp.asarray(plat)),
        visible=js.visible.at[:, 3].set(True),
        phys=js.phys._replace(pos=js.phys.pos.at[:, 0].set(
            jnp.asarray(body))))
    ts = replicate_state(T.state0, 2)
    ts.pos[:, 3] = torch.as_tensor(plat)
    ts.visible[:, 3] = True
    ts.phys.pos[:, 0] = torch.as_tensor(body)
    zero = [(np.zeros((2, 2, 2), np.float32), np.zeros((2, 2), bool),
             np.zeros((2, 3), np.float32))] * FRAMES
    return T, engine_trajectories(J.cfg, T.cfg, js, ts, zero,
                                  camera_occlusion=False, per_env=True)


@pytest.mark.parametrize("part", ["phys", "chars", "cameras", "entities"])
@pytest.mark.parametrize("frame", [0, 20, 39])
def test_moved_platform_trajectory(run, frame, part):
    ref, got = run[1][frame]
    sel = {"phys": lambda s: s.phys, "chars": lambda s: s.chars,
           "cameras": lambda s: (s.camera, s.cameras),
           "entities": lambda s: (s.pos, s.rot, s.mx, s.visible)}[part]
    assert_tree_close(sel(ref), sel(got), path=part)


def test_character_stands_on_the_moved_platform(run):
    """Env 0 stands on the raised platform (top 1.6), env 1 on the one at
    its load pose (top 0.6); both report entity 3 as their ground."""
    T, traj = run
    st = traj[-1][1]
    foot = st.phys.pos[:, 0, 1] - T.cfg.bodies.yoffset[0]
    assert float(foot[0]) > 1.45 and 0.45 < float(foot[1]) < 0.75, foot
    assert st.chars.collision[:, 0].tolist() == [3, 3]
