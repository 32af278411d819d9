"""Per-env triangle soups (B, T, 3, 3) in the port's narrowphase against
the JAX package, which gets them per env through vmap: raycast_down (its
first-hit gather included), raycast and capsule_world_contacts on 3 envs
of 24 triangles each, shifted per env, with a per-env validity mask.
Hits, entities and validity exact; distances, normals, points and depths
within 1e-5. Each env also equals the port's call on that env's own
(T, 3, 3) soup, bit for bit."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.physics import narrowphase as J
from clap_tpu_torch.physics import narrowphase as T
import test_torch_common  # noqa: F401  (one torch thread per worker)
from test_torch_cuda import _per_env_world

DIR = np.array([0.3, -1.0, 0.2], np.float32)
DIR = DIR / np.linalg.norm(DIR)


LIFT = np.array([0.0, 0.4, 0.0], np.float32)


def _port_calls(world, q):
    ones = torch.ones(q.shape[:-1])
    lo = q - torch.as_tensor(LIFT)
    return {
        "raycast_down": T.raycast_down(world, q, 3.0),
        "raycast": T.raycast(world, q, torch.as_tensor(DIR) * ones[..., None],
                             4.0 * ones),
        "capsule": tuple(T.capsule_world_contacts(world, lo, q, 0.3 * ones)),
    }


def _jax_calls(world, q):
    """The JAX package's calls (one query each), vmapped over the queries
    of one env."""
    d = jnp.asarray(DIR)
    return {
        "raycast_down": jax.vmap(lambda o: J.raycast_down(world, o, 3.0))(q),
        "raycast": jax.vmap(lambda o: J.raycast(world, o, d, 4.0))(q),
        "capsule": tuple(jax.vmap(lambda o: J.capsule_world_contacts(
            world, o - jnp.asarray(LIFT), o, 0.3))(q)),
    }


@pytest.fixture(scope="module")
def results():
    world, q = _per_env_world("cpu")
    got = _port_calls(world, q)
    jworld = J.StaticWorld(hf=jnp_tree_from_port(world.hf),
                           tris=jnp.asarray(world.tris.numpy()),
                           tri_valid=jnp.asarray(world.tri_valid.numpy()),
                           tri_entity=jnp.asarray(world.tri_entity.numpy()),
                           hf_entity=jnp.int32(int(world.hf_entity)))
    axes = J.StaticWorld(hf=None, tris=0, tri_valid=0, tri_entity=None,
                         hf_entity=None)
    ref = jax.vmap(_jax_calls, in_axes=(axes, 0))(jworld,
                                                   jnp.asarray(q.numpy()))
    return world, q, got, jax.tree.map(np.asarray, ref)


def jnp_tree_from_port(hf):
    """The port's Heightfield as the JAX package's (numpy → jnp)."""
    from clap_tpu.physics.heightfield import Heightfield

    return Heightfield(*(jnp.asarray(x.numpy()) for x in hf))


@pytest.mark.parametrize("call", ["raycast_down", "raycast", "capsule"])
def test_per_env_triangles_match_jax(results, call):
    _, _, got, ref = results
    for a, b in zip(ref[call], got[call]):
        b = b.numpy()
        assert a.shape == b.shape, (call, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a)
        else:
            fin = np.isfinite(a)
            np.testing.assert_array_equal(np.isfinite(b), fin)
            np.testing.assert_allclose(b[fin], a[fin], atol=1e-5)


@pytest.mark.parametrize("env", range(3))
def test_each_env_equals_its_own_soup(results, env):
    world, q, got, _ = results
    one = world._replace(tris=world.tris[env],
                         tri_valid=world.tri_valid[env])
    own = _port_calls(one, q[env])
    for call in own:
        for a, b in zip(got[call], own[call]):
            assert torch.equal(a[env], b), call
