"""Host scene builders of the port against the JAX package, bit for bit:
build_testbed, testbed_models and build_render_tables (through the
bridge)."""
import numpy as np
import pytest

from clap_tpu.render import scenerender as jsr
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.bridge import to_numpy
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import COMPOSED_SCENE, assert_tree_equal, jnp_tree


@pytest.fixture(scope="module")
def built():
    J = jtb.build_testbed(**COMPOSED_SCENE)
    T = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    return J, T, jtb.testbed_models(J), ttb.testbed_models(T)


@pytest.mark.parametrize("part", ["cfg", "state0"])
def test_build_testbed_exact(built, part):
    J, T, _, _ = built
    assert_tree_equal(jnp_tree(getattr(J, part)), to_numpy(getattr(T, part)),
                      part)


def test_terrain_chunks_exact(built):
    J, T, _, _ = built
    assert len(J.chunks) == len(T.chunks)
    for (a, b) in zip(J.chunks, T.chunks):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_testbed_models_exact(built):
    _, _, jm, tm = built
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        assert a._fields == b._fields
        for f, x, y in zip(a._fields, a, b):
            if f == "lod_faces":
                assert len(x) == len(y)
                assert all(np.array_equal(p, q) for p, q in zip(x, y))
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            else:
                assert x == y, f


@pytest.mark.parametrize("static_split", [True, False])
def test_build_render_tables_exact(built, static_split):
    J, T, jm, tm = built
    ent = J.cfg.entities
    jr = jsr.build_render_tables(
        jm, np.asarray(ent.model_id), np.asarray(ent.active),
        entity_edge_id=jsr.default_edge_ids(np.asarray(ent.active),
                                            np.asarray(ent.body_is_char)),
        entity_shadow_static=jsr.shadow_static_mask(ent)
        if static_split else None)
    te = T.cfg.entities
    tr = tsr.build_render_tables(
        tm, te.model_id, te.active,
        entity_edge_id=tsr.default_edge_ids(te.active, te.body_is_char),
        entity_shadow_static=tsr.shadow_static_mask(te)
        if static_split else None, device="cpu")
    assert jsr.kernel_attrs_ok(jr) == tsr.kernel_attrs_ok(tr)
    assert_tree_equal(jnp_tree(jr), to_numpy(tr), "rt")
