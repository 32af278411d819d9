"""The inputs of the port's time-only bench configs against the JAX
package's calls that bench.py makes with them, on the CPU:

- skinning (bench.py:75-136): the rig, clip, mesh, weights and joint
  indices from ``default_rng(0)`` bit for bit at 8 joints × 64 verts, and
  the posed, skinned verts of 8 instances within LBS_TOL
  (tests/test_torch_charskin.py's tolerance);
- headless (bench.py:139-166): the testbed's state after 3 steps at 2 envs
  within tests/test_torch_step.py's tolerance (ints exact, floats 1e-4);
- ca2d (bench.py:57-72): the JAX package's seeded 256² grid through the
  port's config, 1,000 generations, equal to the JAX package's scan
  (its Pallas kernel's plain reference) cell for cell;
- kernel_parity_check on the CPU (the wrappers' plain versions) is true.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from clap_tpu.anim.clips import (PATH_ROTATION, PATH_TRANSLATION,
                                 build_library, sample_pose)
from clap_tpu.anim.joints import build_skeleton, joint_matrices
from clap_tpu.anim.skin import skin_verts_batch
from clap_tpu.engine.step import engine_step, inputs_zero
from clap_tpu.ops.ca2d import CA_TEST, ca2d_run, ca2d_seed
from clap_tpu.scene.testbed import build_testbed, replicate_state
from clap_tpu_torch import bench as port
from clap_tpu_torch.engine.step import engine_step as t_engine_step
from test_torch_common import assert_tree_close, assert_tree_equal, jnp_tree

LBS_TOL = dict(atol=1e-5, rtol=1e-5)
N_JOINTS, N_VERTS, N_INST = 8, 64, 8


def jax_rig(n_joints, n_verts):
    """bench.py:88-115 as bench.py writes it, with the JAX package."""
    rng = np.random.default_rng(0)
    parent = [-1] + [(i - 1) // 2 for i in range(1, n_joints)]
    invbind = np.tile(np.eye(4, dtype=np.float32), (n_joints, 1, 1))
    base_t = rng.standard_normal((n_joints, 3)).astype(np.float32) * 0.1
    base_r = np.tile(np.array([0, 0, 0, 1], np.float32), (n_joints, 1))
    base_s = np.ones((n_joints, 3), np.float32)
    sk = build_skeleton(parent, invbind, base_t, base_r, base_s)
    keys = np.linspace(0, 2.0, 16)

    def qr():
        q = rng.standard_normal((16, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    clip = []
    for j in range(n_joints):
        clip.append((j, PATH_ROTATION, keys, qr()))
        clip.append((j, PATH_TRANSLATION, keys,
                     rng.standard_normal((16, 3)).astype(np.float32) * 0.05))
    lib = build_library([clip], n_joints)
    verts = jnp.asarray(rng.standard_normal((n_verts, 3)), jnp.float32)
    normals = verts / jnp.linalg.norm(verts, axis=-1, keepdims=True)
    w = rng.random((n_verts, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    w = jnp.asarray(w)
    ji = jnp.asarray(rng.integers(0, n_joints, (n_verts, 4)), jnp.int32)
    return sk, lib, (verts, normals, w, ji)


def test_skinning_rig_and_skinned_verts_match_bench_py():
    jsk, jlib, jmesh = jax_rig(N_JOINTS, N_VERTS)
    tsk, tlib, tmesh = port.skinning_rig(N_JOINTS, N_VERTS, "cpu")
    assert_tree_equal(jnp_tree(jsk), tsk, "skeleton")
    assert_tree_equal(jnp_tree(jlib), tlib, "library")
    for name, a, b in zip(("verts", "normals", "weights", "joints"), jmesh,
                          tmesh):
        assert_tree_equal(np.asarray(a), b, name)

    @jax.jit
    def pose_and_skin(ts):
        def pose_of(t):
            return joint_matrices(jsk, sample_pose(jlib, jsk.base,
                                                   jnp.int32(0), t))
        return skin_verts_batch(jax.vmap(pose_of)(ts), *jmesh)[0]

    ref = np.asarray(pose_and_skin(jnp.linspace(0.0, 2.0, N_INST)))
    got = port.pose_and_skin(tsk, tlib, tmesh,
                             torch.linspace(0.0, 2.0, N_INST))
    assert ref.shape == (N_INST, N_VERTS, 3)
    assert_tree_close(ref, got, **LBS_TOL, path="skinned verts")


def test_headless_state_after_3_steps_matches_bench_py():
    tb = build_testbed(seed=42, side=64.0, nr_v=128, n_dynamic=8,
                       max_entities=64)
    ins1 = inputs_zero(1)._replace(
        motion=jnp.array([[1.0, 0.0]], jnp.float32))
    step = jax.jit(jax.vmap(lambda s, i: engine_step(tb.cfg, s, i)))
    js = replicate_state(tb.state0, 2)
    jins = jax.tree.map(lambda x: jnp.broadcast_to(x, (2, *x.shape)), ins1)
    cfg, ts, tins = port.headless_world(2, "cpu")
    for _ in range(3):
        js = step(js, jins)
        ts = t_engine_step(cfg, ts, tins)
    assert_tree_close(jnp_tree(js), ts, path="headless state")
    assert bool((ts.frame == 3).all())


def test_ca2d_on_the_jax_seeded_grid_matches_bench_py():
    g = ca2d_seed(CA_TEST, jax.random.PRNGKey(0), (256, 256))
    ref = np.asarray(ca2d_run(CA_TEST, g, 1000))
    got = port.bench_ca2d(device="cpu", grid=np.array(g), return_grid=True)
    assert got.dtype == np.uint8 and got.shape == (256, 256)
    assert np.array_equal(got, ref)
    assert 0 < (got != 0).mean() < 1


def test_kernel_parity_check_on_cpu():
    assert port.kernel_parity_check(device="cpu") is True
