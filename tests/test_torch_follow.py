"""Static-trimesh collision that follows its entity's full transform
(``collision_follows_rotation``, tests/test_rotating_platform.py) on the
port against the JAX package: the beam rotated 90° about y, one env with
the character above x = 2.5 (where the beam used to lie: it falls to the
ground) and one above z = 2.5 (where it now lies: it lands on the beam).
70 frames with no input, the camera occlusion on (the raycasts read the
per-env triangles too). Int and bool fields exact, floats within atol
1e-4 + rtol 1e-4."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_rotating_platform
from clap_tpu import mathx as jmx
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu.scene.testbed import replicate_state as jreplicate
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import replicate_state
from test_torch_common import assert_tree_close, engine_trajectories

FRAMES = 70
STARTS = np.array([[2.5, 4.0, 0.0], [0.0, 4.0, 2.5]], np.float32)


@pytest.fixture(scope="module")
def run():
    doc = json.dumps(test_rotating_platform.SCENE)
    kw = dict(asset_loader=test_rotating_platform._loader, max_entities=8,
              max_bodies=2)
    J = jload(doc, **kw)
    T = load_scene(doc, device="cpu", **kw)
    q90 = np.array(jmx.quat_from_axis_angle(
        jnp.array([0.0, 1.0, 0.0]), jnp.float32(np.pi / 2)))
    yoff = float(T.cfg.bodies.yoffset[0])
    body = STARTS + np.array([0.0, yoff, 0.0], np.float32)
    js = jreplicate(J.state0, 2)
    js = js._replace(rot=js.rot.at[:, 1].set(jnp.asarray(q90)),
                     phys=js.phys._replace(pos=js.phys.pos.at[:, 0].set(
                         jnp.asarray(body))))
    ts = replicate_state(T.state0, 2)
    ts.rot[:, 1] = torch.as_tensor(q90)
    ts.phys.pos[:, 0] = torch.as_tensor(body)
    zero = [(np.zeros((2, 1, 2), np.float32), np.zeros((2, 1), bool),
             np.zeros((2, 3), np.float32))] * FRAMES
    return T, engine_trajectories(J.cfg, T.cfg, js, ts, zero)


@pytest.mark.parametrize("part", ["phys", "chars", "camera", "entities"])
@pytest.mark.parametrize("frame", [0, 20, 40, 69])
def test_rotated_beam_trajectory(run, frame, part):
    ref, got = run[1][frame]
    sel = {"phys": lambda s: s.phys, "chars": lambda s: s.chars,
           "camera": lambda s: s.camera,
           "entities": lambda s: (s.pos, s.rot, s.mx, s.visible)}[part]
    assert_tree_close(sel(ref), sel(got), path=part)


def test_collision_follows_the_rotation(run):
    """The character over the beam's old span falls to the ground; the one
    over its new span stands on the beam (top 2.2), on entity 1."""
    T, traj = run
    st = traj[-1][1]
    foot = st.phys.pos[:, 0, 1] - T.cfg.bodies.yoffset[0]
    assert float(foot[0]) < 1.0, foot
    assert float(foot[1]) > 2.0, foot
    assert int(st.chars.collision[1, 0]) == 1
