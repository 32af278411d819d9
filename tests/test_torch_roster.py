"""Rosters of more than two characters on the port against the JAX
package: engine_step on the testbed with 3 and 4 characters (the JAX
package's vmapped move, the port's per-slot move against the pre-move
body positions, written once), 6 frames over 2 envs, each character
walking a seeded direction (every frame's jumps and camera deltas
seeded). Int and bool fields exact, floats within atol 1e-4 + rtol
1e-4."""
import pytest

from clap_tpu.scene.testbed import build_testbed, replicate_state as jrep
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import (ENTRY_SCENE, assert_tree_close,
                               engine_trajectories, seeded_inputs)

B, FRAMES = 2, 6


@pytest.fixture(scope="module", params=[3, 4])
def run(request):
    n = request.param
    kw = dict(ENTRY_SCENE, n_dynamic=2, n_chars=n)
    J = build_testbed(**kw)
    T = ttb.build_testbed(**kw, device="cpu")
    inputs = seeded_inputs(5, B, n, FRAMES, jump_p=0.2)
    walk = inputs[0][0]
    inputs = [(walk, jmp, cam) for _, jmp, cam in inputs]
    return n, engine_trajectories(
        J.cfg, T.cfg, jrep(J.state0, B), ttb.replicate_state(T.state0, B),
        inputs, camera_occlusion=False)


@pytest.mark.parametrize("part", ["phys", "chars", "entities_camera"])
@pytest.mark.parametrize("frame", [0, 2, 5])
def test_roster_trajectory(run, frame, part):
    ref, got = run[1][frame]
    sel = {"phys": lambda s: s.phys, "chars": lambda s: s.chars,
           "entities_camera": lambda s: (s.pos, s.mx, s.camera)}[part]
    assert_tree_close(sel(ref), sel(got), path=part)


def test_every_character_moves(run):
    n, traj = run
    first, last = traj[0][1], traj[-1][1]
    moved = (last.phys.pos[:, :n] - first.phys.pos[:, :n]).norm(dim=-1)
    # a character in the air keeps its course: each moves in some env
    assert (moved.amax(0) > 0.02).all(), moved
