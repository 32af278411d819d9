"""Checkpoints across the two packages (clap_tpu/utils/checkpoint.py and
clap_tpu_torch/utils/checkpoint.py), on the 31 tensor leaves of
``engine_state_init(8, 4, 1)``:

- the JAX package's ``.npz`` (written where orbax is absent: the test
  hides it) loads into the port bit for bit;
- the port's checkpoint loads into the JAX package bit for bit (through its
  ``.npz`` fallback);
- the JAX package's orbax directory gives the port's named ValueError (the
  port has no orbax; ROADMAP §3 records the difference).
"""
import os
import sys

import numpy as np
import pytest

import jax

from clap_tpu.engine.state import engine_state_init as j_state_init
from clap_tpu.utils import checkpoint as JC
from clap_tpu_torch.bridge import to_numpy, tree_leaves
from clap_tpu_torch.engine.state import engine_state_init as t_state_init
from clap_tpu_torch.utils import checkpoint as TC
from test_torch_common import assert_tree_equal, jnp_tree, to_port


def _jax_state():
    """engine_state_init(8, 4, 1) with every leaf made distinct from a
    seed (integers and booleans included), so a leaf in the wrong place
    shows."""
    st = j_state_init(8, 4, 1)
    rng = np.random.default_rng(11)
    leaves, treedef = jax.tree.flatten(st)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == bool:
            return rng.uniform(size=x.shape) < 0.5
        if x.dtype.kind in "iu":
            return rng.integers(0, 100, x.shape).astype(x.dtype)
        return rng.normal(size=x.shape).astype(x.dtype)

    return jax.tree.unflatten(treedef, [jax.numpy.asarray(fill(x))
                                        for x in leaves])


def _hide_orbax(monkeypatch):
    for name in [k for k in sys.modules if k.split(".")[0] == "orbax"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)


def test_jax_npz_loads_into_the_port(tmp_path, monkeypatch):
    st = _jax_state()
    _hide_orbax(monkeypatch)
    path = JC.save_checkpoint(str(tmp_path / "jax_state"), st)
    assert path.endswith(".npz")
    assert len(np.load(path).files) == len(jax.tree.leaves(st)) == 31
    template = t_state_init(8, 4, 1, device="cpu")
    assert len(tree_leaves(template)) == 31
    got = TC.load_checkpoint(path, template)
    assert_tree_equal(jnp_tree(st), to_numpy(got), "state")


def test_port_checkpoint_loads_into_jax(tmp_path):
    st = _jax_state()
    port = to_port(st)
    path = TC.save_checkpoint(str(tmp_path / "port_state"), port)
    got = JC.load_checkpoint(path, j_state_init(8, 4, 1))
    assert_tree_equal(jnp_tree(st), to_numpy(port), "port")
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_jax_orbax_directory_gives_the_ports_error(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    path = str(tmp_path / "orbax_state.npz")
    JC.save_checkpoint(path, j_state_init(8, 4, 1))
    assert os.path.isdir(path)
    template = t_state_init(8, 4, 1, device="cpu")
    for p in (path, path[:-len(".npz")]):
        with pytest.raises(ValueError, match="orbax checkpoint format"):
            TC.load_checkpoint(p, template)
