"""Env-axis sharding on the port (clap_tpu_torch.parallel) against the JAX
package's (clap_tpu/parallel/sharding.py) on the 8-device virtual CPU mesh
of tests/conftest.py; the port's mesh names the CPU 8 times.

- ``shard_envs`` / ``replicate`` place what JAX places: each shard's data
  equals JAX's ``addressable_shards`` in device order, replicated leaves
  are equal everywhere, and an env axis the mesh does not divide raises
  ValueError as JAX's ``NamedSharding`` does;
- ``engine_step`` over 16 envs with distinct inputs, sharded, against the
  JAX package's jitted vmapped step over ``shard_envs``: floats within
  atol 1e-4 + rtol 1e-4, integers and booleans exact (the bars of
  tests/test_torch_step.py); the port's sharded step equals its
  unsharded one bit for bit;
- ``dryrun_multichip(4, devices=["cpu"] * 4)`` equals the same world
  stepped unsharded (the composed frame itself is held against JAX by
  tests/test_torch_slice.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.engine.state import engine_state_init as j_state_init
from clap_tpu.engine.step import engine_step as jstep
from clap_tpu.engine.step import inputs_zero as j_inputs_zero
from clap_tpu.parallel import sharding as JS
from clap_tpu.scene.testbed import build_testbed
from clap_tpu.scene.testbed import replicate_state as j_replicate
from clap_tpu_torch.bridge import from_numpy, to_numpy, tree_leaves
from clap_tpu_torch.engine.step import Inputs, engine_step
from clap_tpu_torch.parallel import sharding as S
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import (ENTRY_SCENE, assert_tree_close,
                               assert_tree_equal, jnp_tree, seeded_inputs)

N_DEV, B, FRAMES = 8, 16, 3
CPU8 = ["cpu"] * N_DEV


def _trees():
    """The JAX tree and the port's copy of it: an engine_state_init(8, 4, 1)
    state over B envs, and two zero-dim leaves (replicated by both)."""
    jt = (j_replicate(j_state_init(8, 4, 1), B), jnp.int32(7),
          jnp.float32(0.25))
    st = from_numpy(jnp_tree(jt[0]), "cpu")
    return jt, (st, torch.tensor(7, dtype=torch.int32), torch.tensor(0.25))


def test_mesh_matches_jax():
    jm = JS.env_mesh()
    assert jm.devices.size == N_DEV and jm.axis_names == ("env",)
    m = S.env_mesh(devices=CPU8)
    assert m.size == N_DEV and m.axis == "env"
    assert all(d == torch.device("cpu") for d in m.devices)
    # cut to the first n, as JAX's devs[:n]
    assert S.env_mesh(3, devices=CPU8).size == JS.env_mesh(3).devices.size


def test_env_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.env_mesh()
    with pytest.raises(RuntimeError):
        S.env_mesh(4)


def test_shard_envs_matches_jax_shards():
    """Each port shard equals JAX's addressable shard of the same device
    index, leaf by leaf (31 leaves of the state and the two scalars)."""
    jt, tt = _trees()
    jsh = JS.shard_envs(jt, JS.env_mesh())
    tsh = S.shard_envs(tt, S.env_mesh(devices=CPU8))
    assert len(tsh) == N_DEV
    jl = jax.tree.leaves(jsh)
    assert len(jl) == len(tree_leaves(tt)) == 33
    for i, shard in enumerate(tsh):
        tl = tree_leaves(shard)
        for a, b in zip(jl, tl):
            by_dev = sorted(a.addressable_shards, key=lambda s: s.device.id)
            want = np.asarray(by_dev[i].data)
            got = b.numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            assert np.array_equal(got, want)
            if a.ndim >= 1:
                assert got.shape[0] == B // N_DEV
                assert a.sharding.spec == jax.sharding.PartitionSpec("env")
            else:
                assert a.sharding.is_fully_replicated


def test_shards_are_their_own_tensors():
    """A shard is a copy, as JAX's device_put makes one: writing into it
    leaves the batch as it was."""
    _, tt = _trees()
    shards = S.shard_envs(tt, S.env_mesh(devices=CPU8))
    before = tt[0].phys.pos.clone()
    shards[0][0].phys.pos.fill_(5.0)
    assert torch.equal(tt[0].phys.pos, before)


def test_replicate_matches_jax():
    """Every entry holds the whole tree, equal to JAX's replicated shards;
    on the tensor's own device the entry is the tensor itself."""
    jt, tt = _trees()
    jr = JS.replicate(jt, JS.env_mesh())
    tr = S.replicate(tt, S.env_mesh(devices=CPU8))
    for i, rep in enumerate(tr):
        for a, b, orig in zip(jax.tree.leaves(jr), tree_leaves(rep),
                              tree_leaves(tt)):
            assert a.sharding.is_fully_replicated
            assert b is orig
            by_dev = sorted(a.addressable_shards, key=lambda s: s.device.id)
            assert np.array_equal(np.asarray(by_dev[i].data), b.numpy())


@pytest.mark.parametrize("n", [4, 10, 12])
def test_uneven_split_raises_as_jax(n):
    """An env axis the mesh's size does not divide: JAX's NamedSharding
    raises ValueError, and so does the port."""
    with pytest.raises(ValueError, match="divisible"):
        JS.shard_envs(jnp.arange(n), JS.env_mesh())
    with pytest.raises(ValueError, match="does not divide"):
        S.shard_envs(torch.arange(n), S.env_mesh(devices=CPU8))


def test_axis_name_must_match():
    with pytest.raises(ValueError):
        S.shard_envs(torch.arange(8), S.env_mesh(devices=CPU8), axis="x")


def test_gather_envs_inverts_shard_envs():
    _, tt = _trees()
    mesh = S.env_mesh(devices=CPU8)
    back = S.gather_envs(S.shard_envs(tt, mesh))
    assert_tree_equal(to_numpy(tt[0]), to_numpy(back[0]))
    assert torch.equal(back[1], tt[1]) and torch.equal(back[2], tt[2])


def test_env_mean_weighs_every_element_once():
    """The cross-env mean from per-shard sums and counts equals the mean of
    the whole batch, where a mean of the shards' means would not."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0, 1, (8, 5, 5, 3)).astype(np.float32))
    parts = [x[:1], x[1:8]]
    m = S.env_mean(parts)
    assert m.dtype == torch.float32
    assert abs(float(m) - float(x.double().mean())) <= 1e-7
    of_means = (float(parts[0].mean()) + float(parts[1].mean())) / 2
    assert abs(of_means - float(x.double().mean())) > 1e-4


def test_replicate_module_once_per_device():
    """An nn.Module on its own device is returned as it is; for another
    device the entry gets a copy and the original stays (the meta device
    stands in for a second card)."""
    from torch import nn

    mod = nn.Linear(3, 2)
    reps = S.replicate(mod, S.env_mesh(devices=["cpu", "cpu", "meta"]))
    assert reps[0] is mod and reps[1] is mod and reps[2] is not mod
    assert reps[2].weight.device.type == "meta"
    assert mod.weight.device.type == "cpu"


def test_map_shards_pairs_entries_in_order():
    mesh = S.env_mesh(devices=["cpu"] * 4)
    a = S.shard_envs(torch.arange(8), mesh)
    b = S.replicate(torch.tensor(10), mesh)
    out = S.map_shards(lambda x, y: x + y, mesh, a, b)
    assert torch.equal(torch.cat(out), torch.arange(8) + 10)


# ---------------------------------------------------------------------------
# engine_step over sharded envs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_steps():
    """FRAMES frames of B envs with distinct seeded inputs: the JAX
    package's jit(vmap(engine_step)) over shard_envs on the 8-device mesh,
    the port's engine_step over its 8 CPU shards (map_shards) and the
    port's unsharded step. Returns [(JAX state numpy, port sharded state
    gathered, port unsharded state)] per frame."""
    J = build_testbed(**ENTRY_SCENE)
    T = ttb.build_testbed(**ENTRY_SCENE, device="cpu")
    jmesh, mesh = JS.env_mesh(), S.env_mesh(devices=CPU8)
    step = jax.jit(jax.vmap(
        lambda s, i: jstep(J.cfg, s, i, camera_occlusion=True)))
    js = JS.shard_envs(j_replicate(J.state0, B), jmesh)
    whole = ttb.replicate_state(T.state0, B)
    shards = S.shard_envs(whole, mesh)
    cfgs = S.replicate(T.cfg, mesh)
    out = []
    for mot, jmp, cam in seeded_inputs(21, B, 1, FRAMES, jump_p=0.3):
        ji = JS.shard_envs(j_inputs_zero(1)._replace(
            motion=jnp.asarray(mot), jump=jnp.asarray(jmp),
            cam_delta=jnp.asarray(cam), dash=jnp.zeros((B, 1), bool)), jmesh)
        ti = Inputs(motion=torch.as_tensor(mot), jump=torch.as_tensor(jmp),
                    cam_delta=torch.as_tensor(cam),
                    dash=torch.zeros((B, 1), dtype=torch.bool))
        js = step(js, ji)
        shards = S.map_shards(
            lambda c, s, i: engine_step(c, s, i, camera_occlusion=True),
            mesh, cfgs, shards, S.shard_envs(ti, mesh))
        whole = engine_step(T.cfg, whole, ti, camera_occlusion=True)
        out.append((jnp_tree(js), S.gather_envs(shards), whole))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_sharded_engine_step_matches_jax(sharded_steps, frame):
    ref, got, _ = sharded_steps[frame]
    assert_tree_close(ref, got, path=f"frame{frame}")


@pytest.mark.parametrize("frame", range(FRAMES))
def test_sharded_engine_step_equals_unsharded(sharded_steps, frame):
    _, got, whole = sharded_steps[frame]
    assert_tree_equal(to_numpy(whole), to_numpy(got), f"frame{frame}")


def test_sharded_envs_diverge(sharded_steps):
    """The inputs really differ per env: the characters stand in B places."""
    pos = sharded_steps[-1][1].phys.pos[:, 0]
    assert torch.unique(pos, dim=0).shape[0] == B


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun():
    from clap_tpu_torch.engine.frame import step_and_render
    from clap_tpu_torch.parallel.multichip import (dryrun_multichip,
                                                   multichip_world)

    gs, mean, frames = dryrun_multichip(4, devices=["cpu"] * 4)
    w = multichip_world(8, "cpu")
    gs_u, frames_u = step_and_render(w["gw"], w["renderer"], w["gs"],
                                     w["ins"])
    return gs, mean, frames, gs_u, frames_u, w


def test_dryrun_multichip_frame_and_mean(dryrun):
    gs, mean, frames, _, frames_u, w = dryrun
    assert w["renderer"].cluster_records      # the dryrun's kernel-attrs path
    assert frames.shape == (8, 32, 32, 3)
    assert bool((gs.engine.frame == 1).all())
    assert bool(torch.isfinite(mean)) and float(frames.std()) > 0.01
    assert torch.equal(frames, frames_u)
    assert abs(float(mean) - float(frames_u.double().mean())) \
        <= 1e-6 * abs(float(mean))


def test_dryrun_multichip_state_equals_unsharded(dryrun):
    gs, _, _, gs_u, _, _ = dryrun
    assert_tree_equal(to_numpy(gs_u), to_numpy(gs), "state")
