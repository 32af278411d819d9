"""engine_step of the port against the JAX package: a 5-frame trajectory
on the entry() scene (__graft_entry__.py:17-37) over 3 envs with seeded
motion and jump inputs, camera occlusion on. Int and bool fields exact,
float fields within atol 1e-4 + rtol 1e-4 (float32 summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.engine.step import engine_step as jstep, inputs_zero
from clap_tpu.scene.testbed import build_testbed, replicate_state
from clap_tpu_torch.engine.step import Inputs, engine_step
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import ENTRY_SCENE, assert_tree_close, jnp_tree

B, FRAMES = 3, 5


@pytest.fixture(scope="module")
def trajectories():
    J = build_testbed(**ENTRY_SCENE)
    T = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    step = jax.jit(jax.vmap(
        lambda s, i: jstep(J.cfg, s, i, camera_occlusion=True)))
    rng = np.random.default_rng(0)
    js = replicate_state(J.state0, B)
    ts = ttb.replicate_state(T.state0, B)
    out = []
    for _ in range(FRAMES):
        mot = rng.uniform(-1, 1, (B, 1, 2)).astype(np.float32)
        jmp = rng.uniform(size=(B, 1)) < 0.3
        cam = rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
        jins = inputs_zero(1)._replace(
            motion=jnp.asarray(mot), jump=jnp.asarray(jmp),
            cam_delta=jnp.asarray(cam), dash=jnp.zeros((B, 1), bool))
        tins = Inputs(motion=torch.as_tensor(mot), jump=torch.as_tensor(jmp),
                      cam_delta=torch.as_tensor(cam),
                      dash=torch.zeros((B, 1), dtype=torch.bool))
        js = step(js, jins)
        ts = engine_step(T.cfg, ts, tins, camera_occlusion=True)
        out.append((jnp_tree(js), ts))
    return out


PARTS = {
    "phys": lambda s: s.phys,
    "chars": lambda s: s.chars,
    "entities_camera": lambda s: (s.pos, s.rot, s.mx, s.visible, s.camera,
                                  s.time, s.frame),
}


@pytest.mark.parametrize("part", sorted(PARTS))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_engine_step_trajectory(trajectories, frame, part):
    ref, got = trajectories[frame]
    sel = PARTS[part]
    r, g = sel(ref), sel(got)
    if isinstance(r, tuple) and not hasattr(r, "_fields"):
        for i, (a, b) in enumerate(zip(r, g)):
            assert_tree_close(a, b, path=f"{part}[{i}]")
    else:
        assert_tree_close(r, g, path=part)


def test_trajectory_moves(trajectories):
    """The inputs drive real motion: characters leave their spawn and the
    frame counter advances per env."""
    first, last = trajectories[0][1], trajectories[-1][1]
    assert (last.frame == FRAMES).all()
    moved = (last.phys.pos[:, 0] - first.phys.pos[:, 0]).norm(dim=-1)
    assert (moved > 1e-3).all()
