"""The port's cellular automata against the JAX package, all exact: the
synchronous 2-D step (``ca2d_run``), K3's wrapper on CPU tensors (its
plain version) against ``ca2d_run_pallas`` in interpret mode, the seeding
distribution, the 3-D step / prune / count for the 9 rulesets, the numpy
host copies of the cave generator, and ``cave_scene``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.ops import ca2d as J2
from clap_tpu.ops import ca3d as J3
from clap_tpu.scene import voxel as JV
from clap_tpu.utils.frand import Rand48 as JRand48
from clap_tpu_torch.ops import ca2d as T2
from clap_tpu_torch.ops import ca3d as T3
from clap_tpu_torch.scene import voxel as TV
from clap_tpu_torch.utils.frand import Rand48
from test_torch_cuda import CA_VN1_TEST, CA_VNV_TEST


def jax_rule(rule):
    """The JAX package's CARule with the port rule's fields."""
    return J2.CARule(**dataclasses.asdict(rule))


RULES2 = [T2.CA_TEST, T2.CA_COOL_TREE, T2.CA_ASH_PINUS, CA_VN1_TEST,
          CA_VNV_TEST]


def test_rules_match_the_jax_package():
    for a, b in ((T2.CA_TEST, J2.CA_TEST), (T2.CA_COOL_TREE, J2.CA_COOL_TREE),
                 (T2.CA_ASH_PINUS, J2.CA_ASH_PINUS)):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(r) for r in T3.CA3D_RULES] \
        == [dataclasses.asdict(r) for r in J3.CA3D_RULES]


def _grid(rule, shape, seed):
    return np.random.default_rng(seed).integers(
        0, rule.nr_states + 1, shape).astype(np.uint8)


@pytest.mark.parametrize("rule", RULES2, ids=lambda r: r.name)
def test_ca2d_run_matches_jax(rule):
    g = _grid(rule, (2, 33, 47), 0)
    ref = np.asarray(J2.ca2d_run(jax_rule(rule), jnp.asarray(g), 4))
    got = T2.ca2d_run(rule, torch.as_tensor(g), 4)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape,steps", [((2, 64, 64), 5), ((1, 64, 64), 32),
                                        ((1, 512, 512), 3)])
def test_ca2d_run_fused_cpu_matches_pallas(shape, steps):
    """K3's wrapper on CPU tensors (its plain version) against the TPU
    kernel in interpret mode; (1, 64, 64) × 32 is kernel_parity_check's
    shape (bench.py:773-778); 512² is past one CTA's shared memory on the
    card, where K3 splits the grid over a cluster."""
    g = np.array(J2.ca2d_seed(J2.CA_TEST, jax.random.PRNGKey(3), shape))
    ref = np.asarray(J2.ca2d_run_pallas(J2.CA_TEST, jnp.asarray(g), steps))
    before = T2.ca2d_run_fused.launches
    got = T2.ca2d_run_fused(T2.CA_TEST, torch.as_tensor(g), steps)
    assert T2.ca2d_run_fused.launches == before      # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), ref)


def test_ca2d_run_fused_cpu_shapes_and_edges():
    g = torch.as_tensor(_grid(T2.CA_TEST, (64, 64), 1))
    one = T2.ca2d_run_fused(T2.CA_TEST, g, 3)               # (H, W) in and out
    assert one.shape == (64, 64)
    assert torch.equal(one, T2.ca2d_run(T2.CA_TEST, g, 3))
    same = T2.ca2d_run_fused(T2.CA_TEST, g, 0)              # a copy
    assert torch.equal(same, g) and same.data_ptr() != g.data_ptr()
    empty = T2.ca2d_run_fused(T2.CA_TEST, g[None, :0], 4)
    assert empty.shape == (1, 0, 64)
    with pytest.raises(ValueError):
        T2.ca2d_run_fused(T2.CA_TEST, g.to(torch.int32), 1)
    with pytest.raises(ValueError):
        T2.ca2d_run_fused(T2.CA_TEST, g, -1)


@pytest.mark.parametrize("w", [37, 53, 64, 160])
@pytest.mark.parametrize("neigh", T2.NEIGH_MODES)
def test_packed_step_ref_matches_ca2d_step(neigh, w):
    """The kernel's per-word formulas (four cells to a word, funnel
    shifts, the byte lookup, pad bytes kept at 0) against the plain step,
    for 20 random 32-bit born / survive masks; byte values up to 255 in a
    third of the cases, to hold the byte compare of mv / vnv exact."""
    rng = np.random.default_rng(1000 * T2.NEIGH_MODES.index(neigh) + w)
    for k in range(20):
        rule = T2.CARule("random", int(rng.integers(0, 2**32)),
                         int(rng.integers(0, 2**32)),
                         int(rng.integers(1, 256)), bool(k % 2), neigh)
        top = 256 if k % 3 == 0 else rule.nr_states + 1
        g = torch.as_tensor(rng.integers(0, top, (2, 9, w)).astype(np.uint8))
        words = T2._packed_step_ref(rule, T2._pack(g), w)
        assert torch.equal(T2._unpack(words, w), T2.ca2d_step(rule, g))
        assert torch.equal(T2._pack(T2._unpack(words, w)), words)  # pads 0


_FULL, _SMALL = 232_448, 49_152      # H100 opt-in shared memory; 48 KiB


@pytest.mark.parametrize("shape,limit,cap,want", [
    # (b, h, w), smem limit, cluster cap -> (route, cluster, band rows, smem)
    ((1, 256, 256), _FULL, 16, ("cluster", 16, (16,) * 16, 8712)),
    ((1024, 256, 256), _FULL, 16, ("inplace", 1, (256,), 68112)),
    ((1, 512, 512), _FULL, 16, ("cluster", 16, (32,) * 16, 33800)),
    ((1, 1024, 1024), _FULL, 16, ("cluster", 16, (64,) * 16, 133128)),
    ((1, 37, 53), _FULL, 16,
     ("cluster", 16, (2, 2, 2, 3, 2, 2, 3, 2, 2, 3, 2, 2, 3, 2, 2, 3), 448)),
    ((1, 2048, 2048), _FULL, 16, ("global", 128, (16,) * 128, 0)),
    ((1, 1024, 1024), _FULL, 8, ("global", 64, (16,) * 64, 0)),
    ((1, 256, 256), _SMALL, 16, ("cluster", 16, (16,) * 16, 8712)),
    ((1024, 256, 256), _SMALL, 16, ("cluster", 4, (64,) * 4, 34056)),
    ((1, 512, 512), _SMALL, 16, ("cluster", 16, (32,) * 16, 33800)),
    ((1, 1024, 1024), _SMALL, 16, ("global", 64, (16,) * 64, 0)),
    ((1, 37, 53), _SMALL, 16,
     ("cluster", 16, (2, 2, 2, 3, 2, 2, 3, 2, 2, 3, 2, 2, 3, 2, 2, 3), 448)),
    ((1, 2048, 2048), _SMALL, 16, ("global", 128, (16,) * 128, 0)),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    and isinstance(v[0], int) else str(v))
def test_ca2d_plan_routes(shape, limit, cap, want):
    p = T2.ca2d_plan(*shape, limit, cap)
    assert (p.route, p.cluster, p.bands, p.smem) == want
    assert sum(p.bands) == shape[1]
    if p.route == "cluster":          # a run covers a band in <= 1 pass
        assert p.run * T2.CLUSTER_THREADS >= max(p.bands) * -(-shape[2] // 4)


def test_ca2d_plan_choices():
    """A forced cluster size runs on two buffers, a cluster of 1 too;
    every power of two up to the cap can be forced; a size that does not
    fit or is not schedulable raises; with few grids the largest cluster
    that fits is taken; a grid too wide to step in place takes two
    buffers."""
    p = T2.ca2d_plan(1024, 256, 256, _FULL, 16, cluster=1)
    assert (p.route, p.cluster, p.smem, p.run) == ("cluster", 1, 135432, 16)
    for cs in (1, 2, 4, 8, 16):
        p = T2.ca2d_plan(1, 256, 256, _FULL, 16, cluster=cs)
        assert (p.route, p.cluster, len(p.bands)) == ("cluster", cs, cs)
    with pytest.raises(ValueError):
        T2.ca2d_plan(1, 256, 256, _FULL, 8, cluster=16)
    with pytest.raises(ValueError):
        T2.ca2d_plan(1, 1024, 1024, _FULL, 16, cluster=1)
    assert T2.ca2d_plan(8, 256, 256, _FULL, 16).cluster == 16
    assert T2.ca2d_plan(33, 256, 256, _FULL, 16).cluster == 4
    assert T2.ca2d_plan(1, 5, 64, _FULL, 16).cluster == 4   # cs <= h
    p = T2.ca2d_plan(132, 40, 1100, _FULL, 16)
    assert (p.route, p.cluster) == ("cluster", 1)


@pytest.mark.parametrize("rule", [T2.CA_TEST, T2.CA_COOL_TREE],
                         ids=lambda r: r.name)
def test_ca2d_seed_distribution(rule):
    """Same distribution as the JAX package's seeding (ca2d.c:88-91:
    lrand48() % 8 <= nr_states → nr_states), from another stream."""
    shape = (4, 128, 128)
    ref = np.asarray(J2.ca2d_seed(jax_rule(rule), jax.random.PRNGKey(0),
                                  shape))
    gen = torch.Generator().manual_seed(0)
    got = T2.ca2d_seed(rule, shape, generator=gen, device="cpu")
    assert got.shape == shape and got.dtype == torch.uint8
    assert set(np.unique(got.numpy())) <= {0, rule.nr_states}
    p = min(rule.nr_states + 1, 8) / 8
    for frac in (float((got == rule.nr_states).float().mean()),
                 float((ref == rule.nr_states).mean())):
        assert abs(frac - p) < 0.01
    again = T2.ca2d_seed(rule, shape, torch.Generator().manual_seed(0),
                         device="cpu")
    assert torch.equal(got, again)


@pytest.mark.parametrize("idx", range(len(T3.CA3D_RULES)),
                         ids=[r.name for r in T3.CA3D_RULES])
def test_ca3d_step_prune_count(idx):
    rule, jrule = T3.CA3D_RULES[idx], J3.CA3D_RULES[idx]
    g = _grid(rule, (2, 10, 12, 14), idx)
    jg, tg = jnp.asarray(g), torch.as_tensor(g)
    np.testing.assert_array_equal(T3.ca3d_run(rule, tg, 2).numpy(),
                                  np.asarray(J3.ca3d_run(jrule, jg, 2)))
    np.testing.assert_array_equal(T3.ca3d_step(rule, tg).numpy(),
                                  np.asarray(J3.ca3d_step(jrule, jg)))
    np.testing.assert_array_equal(T3.ca3d_prune(tg).numpy(),
                                  np.asarray(J3.ca3d_prune(jg)))
    count = T3.ca3d_count(tg)
    assert count.dtype == torch.int32
    np.testing.assert_array_equal(count.numpy(),
                                  np.asarray(J3.ca3d_count(jg)))


def test_ca3d_host_copies_match_jax():
    """The numpy host copies against the JAX package's, bit for bit."""
    np.testing.assert_array_equal(T3.ca3d_make_np(10, 12, 14, Rand48(3)),
                                  J3.ca3d_make_np(10, 12, 14, JRand48(3)))
    g = _grid(T3.CA3D_RULES[2], (5, 6, 7), 4)
    np.testing.assert_array_equal(
        T3.ca3d_run_seq_np(T3.CA3D_RULES[2], g, 2),
        J3.ca3d_run_seq_np(J3.CA3D_RULES[2], g, 2))
    box = np.zeros((8, 9, 10), np.uint8)
    np.testing.assert_array_equal(T3.ca3d_walk_np(box, 60, 3, Rand48(9)),
                                  J3.ca3d_walk_np(box, 60, 3, JRand48(9)))


@pytest.mark.parametrize("ca_rule,ca_steps", [(-1, 0), (2, 3)])
def test_cave_scene_matches_jax(ca_rule, ca_steps):
    ref = JV.cave_scene(12, 12, 12, seed=5, ca_rule=ca_rule,
                        ca_steps=ca_steps)
    got = TV.cave_scene(12, 12, 12, seed=5, ca_rule=ca_rule,
                        ca_steps=ca_steps, device="cpu")
    assert got[1].shape[0] > 0
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
