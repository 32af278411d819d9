"""The camera bank of the port's engine_step against the JAX package: 30
frames of the two-camera scene (tests/test_multicam.py) over 2 envs with
seeded motion, jumps and camera deltas, the camera occlusion on. Int and
bool fields exact, float fields within atol 1e-4 + rtol 1e-4 (float32
summation order), as tests/test_torch_step.py holds engine_step."""
import numpy as np
import pytest
import torch

import test_multicam
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu.scene.testbed import replicate_state as jreplicate
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import replicate_state
from test_torch_common import (assert_tree_close, engine_trajectories,
                               seeded_inputs)

B, FRAMES = 2, 30


@pytest.fixture(scope="module")
def trajectories():
    kw = dict(asset_loader=test_multicam._loader, max_entities=8,
              max_bodies=4)
    J = jload(test_multicam.SCENE, **kw)
    T = load_scene(test_multicam.SCENE, device="cpu", **kw)
    return engine_trajectories(
        J.cfg, T.cfg, jreplicate(J.state0, B), replicate_state(T.state0, B),
        seeded_inputs(11, B, 2, FRAMES))


PARTS = {
    "cameras": lambda s: s.cameras,
    "camera": lambda s: s.camera,
    "phys": lambda s: s.phys,
    "chars": lambda s: s.chars,
    "entities": lambda s: (s.pos, s.rot, s.mx, s.visible, s.time, s.frame),
}


@pytest.mark.parametrize("part", sorted(PARTS))
@pytest.mark.parametrize("frame", [0, 1, 9, 19, 29])
def test_camera_bank_trajectory(trajectories, frame, part):
    ref, got = trajectories[frame]
    assert_tree_close(PARTS[part](ref), PARTS[part](got), path=part)


def test_both_slots_track_their_targets(trajectories):
    """Slot 0 orbits the controlled character 0, slot 1 character 1: the
    eyes differ, slot 1 stays within its boom of character 1, and the
    active camera is slot 0 in every env."""
    _, st = trajectories[-1]
    eyes = st.cameras.pos                                  # (B, 2, 3)
    assert eyes.shape == (B, 2, 3)
    assert ((eyes[:, 0] - eyes[:, 1]).norm(dim=-1) > 1.0).all()
    c1 = st.phys.pos[:, 1]
    assert ((eyes[:, 1] - c1).norm(dim=-1) < 14.0).all()
    for a, b in zip(st.camera, st.cameras):
        assert torch.equal(a, b[:, 0])


def test_input_steers_slot_zero_only(trajectories):
    """The camera deltas move slot 0's pitch/yaw/dist; slot 1 keeps the
    values the scene loaded (its yaw re-wrapped into [-π, π) each frame,
    which float32 rounding moves by a few ulps)."""
    _, st = trajectories[-1]
    np.testing.assert_array_equal(st.cameras.dist[:, 1].numpy(),
                                  np.float32(12.0))
    np.testing.assert_array_equal(st.cameras.pitch[:, 1].numpy(),
                                  np.float32(-0.9))
    np.testing.assert_allclose(st.cameras.yaw[:, 1].numpy(), 1.5, atol=1e-5)
    assert (st.cameras.dist[:, 0] != 6.0).all()
