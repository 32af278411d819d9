"""engine_step of the port against the JAX package: a 5-frame trajectory
on the entry() scene (__graft_entry__.py:17-37) over 3 envs with seeded
motion and jump inputs, camera occlusion on. Int and bool fields exact,
float fields within atol 1e-4 + rtol 1e-4 (float32 summation order).

The body set's solver flags (two_ended, iso) equal the JAX package's
trace-time decision and are made once on the host: phys_step with them
copies nothing to the host, and a whole engine_step after its first
reads nothing back from the device (no scalar read, no tensor made from
host data)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.engine.step import engine_step as jstep, inputs_zero
from clap_tpu.scene.testbed import build_testbed, replicate_state
from clap_tpu_torch.bridge import from_numpy, tree_map
from clap_tpu_torch.engine.step import Inputs, engine_step
from clap_tpu_torch.engine.step import inputs_zero as t_inputs_zero
from clap_tpu_torch.physics import world as W
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import (COMPOSED_SCENE, ENTRY_SCENE,
                               assert_tree_close, jnp_tree)

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


def _reference_flags(half_len, kinematic):
    """The JAX package's trace-time decision (clap_tpu/physics/world.py:
    182-184 two_ended, 335-337 iso) on host arrays."""
    hl, kin = np.asarray(half_len), np.asarray(kinematic)
    return (bool(np.any(hl * ~kin > 0)), bool(np.all(hl * ~kin == 0)))


def _capsule_set(dynamic_capsule: bool):
    """Two kinematic character capsules, two spheres and a capsule that is
    dynamic or kinematic."""
    hl = np.array([0.4, 0.4, 0.0, 0.0, 0.3], np.float32)
    kin = np.array([True, True, False, False, not dynamic_capsule])
    return hl, kin


@pytest.mark.parametrize("bodies", ["testbed", "composed_testbed",
                                    "dynamic_capsule", "kinematic_capsule"])
def test_body_flags_match_reference(bodies):
    if bodies.endswith("testbed"):
        scene = ENTRY_SCENE if bodies == "testbed" else COMPOSED_SCENE
        J = build_testbed(**scene)
        T = ttb.build_testbed(**scene, device="cpu")
        hl, kin = np.asarray(J.cfg.bodies.half_len), \
            np.asarray(J.cfg.bodies.kinematic)
        flags = T.cfg.host.body_flags
        # the bridge fills the same host facts from the JAX package's tree
        assert from_numpy(jnp_tree(J.cfg), "cpu").host == T.cfg.host
        assert T.cfg.host.char_body == tuple(
            int(b) for b in np.asarray(J.cfg.char_params.body))
    else:
        hl, kin = _capsule_set(bodies == "dynamic_capsule")
        flags = W.body_flags(hl, kin)
        assert W.body_flags(torch.as_tensor(hl), torch.as_tensor(kin)) \
            == flags
    assert (flags.two_ended, flags.iso) == _reference_flags(hl, kin)
    if bodies == "dynamic_capsule":
        assert flags.two_ended and not flags.iso


def _no_host_copies(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("copied to the host")

    for name in ("cpu", "numpy", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_phys_step_copies_nothing_to_host(monkeypatch):
    T = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    st = ttb.replicate_state(T.state0, 2)
    flags = T.cfg.host.body_flags
    ref = W.phys_step(T.cfg.world, T.cfg.bodies, st.phys, 1.0 / 60.0,
                      flags=flags)
    _no_host_copies(monkeypatch)
    got = W.phys_step(T.cfg.world, T.cfg.bodies, st.phys, 1.0 / 60.0,
                      flags=flags)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))
    with pytest.raises(AssertionError, match="host"):   # the patch bites
        T.cfg.bodies.half_len.cpu()
    # the flags have no device fallback: a config without its host facts
    # is refused, not read back
    with pytest.raises(TypeError, match="flags"):
        W.phys_step(T.cfg.world, T.cfg.bodies, st.phys, 1.0 / 60.0)
    with pytest.raises(ValueError, match="SceneConfig.host"):
        engine_step(T.cfg._replace(host=None), st, tree_map(
            lambda x: x.expand(2, *x.shape).clone(),
            t_inputs_zero(1, device="cpu")))


def test_engine_step_reads_nothing_back():
    """After its first call, engine_step (two characters, camera
    occlusion) makes no scalar read of a tensor and no tensor from host
    data: on the card neither would block the host on the stream."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    def bool_index(args):
        idx = args[1] if len(args) > 1 else ()
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (idx if isinstance(idx, (list, tuple)) else ()))

    class Probe(TorchDispatchMode):
        """Records each op that needs the host to see device data: a
        scalar read, a tensor from host data, and the ops whose output
        size depends on the data (nonzero, boolean-mask indexing)."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            op = func.name().split("::")[-1].split(".")[0]
            if op in ("_local_scalar_dense", "lift_fresh", "nonzero",
                      "masked_select", "unique", "_unique2",
                      "repeat_interleave") or (
                    op in ("index", "index_put", "index_put_")
                    and bool_index(args)):
                seen.append(func.name())
            return func(*args, **(kwargs or {}))

    T = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    st = ttb.replicate_state(T.state0, 3)
    ins = tree_map(lambda x: x.expand(3, *x.shape).clone(),
                   t_inputs_zero(2, device="cpu"))
    ins.motion[:, 0, 0] = 1.0
    st = engine_step(T.cfg, st, ins, camera_occlusion=True)
    with Probe():
        st2 = engine_step(T.cfg, st, ins, camera_occlusion=True)
    assert seen == []
    assert bool((st2.frame == 2).all())
