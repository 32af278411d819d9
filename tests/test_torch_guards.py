"""The port's numeric guards and checkpoints against the JAX package's:
``finite_mask``, ``quarantine`` and ``assert_finite`` on the same trees
(a dict of arrays and a bridged 4-env GameSessionState of the entry
testbed, a NaN or an Inf put into one env); ``save_checkpoint`` /
``load_checkpoint`` round trips, None leaves included.

Bars: masks exact, quarantined trees bit-exact (healthy envs pass through,
bad envs take the reset state), the same FloatingPointError message (the
first bad leaf's index and shape), the loaded tree bit-exact with the
template's dtypes and devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap_tpu.utils import guards as JG
from clap_tpu_torch.bridge import tree_map
from clap_tpu_torch.utils import guards as TG
from clap_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from test_torch_common import (ENTRY_SCENE, assert_tree_equal, jnp_tree,
                               to_port)

N = 4


@pytest.fixture(scope="module")
def sessions():
    """The JAX package's 4-env GameSessionState over the entry testbed
    (engine, game, anim, joint matrices) with numpy leaves, its unbatched
    initial session, and both as port trees."""
    from clap_tpu.anim.system import anim_instances_init
    from clap_tpu.engine.game import GameSessionState
    from clap_tpu.engine.gamelogic import game_state_init
    from clap_tpu.scene.testbed import build_testbed

    tb = build_testbed(**ENTRY_SCENE)
    s0 = GameSessionState(engine=tb.state0, game=game_state_init(1, 1),
                          anim=anim_instances_init(1),
                          joint_mats=jnp.tile(jnp.eye(4), (1, 3, 1, 1)))
    s0 = jnp_tree(s0)
    rng = np.random.default_rng(3)
    batch = jax.tree.map(
        lambda x: (np.broadcast_to(x, (N, *x.shape))
                   + (rng.normal(0, 0.1, (N, *x.shape)).astype(x.dtype)
                      if x.dtype.kind == "f" else 0)).astype(x.dtype), s0)
    return s0, batch


def _poison(tree, path, env, value):
    """A copy of a numpy tree with ``value`` at env ``env`` of the leaf
    at attribute ``path``."""
    tree = jax.tree.map(np.array, tree)
    leaf = tree
    for p in path.split("."):
        leaf = getattr(leaf, p)
    leaf[env].reshape(-1)[leaf[env].size // 2] = value
    return tree


CASES = {
    "finite": None,
    "nan_body_pos_env2": ("engine.phys.pos", 2, np.nan),
    "inf_joint_mats_env0": ("joint_mats", 0, np.inf),
    "nan_camera_env3": ("engine.camera.pos", 3, np.nan),
}


def _case(sessions, name):
    s0, batch = sessions
    c = CASES[name]
    return s0, batch if c is None else _poison(batch, *c)


@pytest.mark.parametrize("case", list(CASES))
def test_finite_mask_matches_jax(sessions, case):
    _, tree = _case(sessions, case)
    ref = np.asarray(JG.finite_mask(tree))
    got = TG.finite_mask(to_port(tree))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), ref)
    assert ref.sum() == (N if CASES[case] is None else N - 1)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("reset", ["broadcast", "batched"])
def test_quarantine_matches_jax(sessions, case, reset):
    s0, tree = _case(sessions, case)
    r = s0 if reset == "broadcast" else sessions[1]
    ref, ok = JG.quarantine(tree, r)
    got, tok = TG.quarantine(to_port(tree), to_port(r))
    assert np.array_equal(tok.numpy(), np.asarray(ok))
    assert_tree_equal(jnp_tree(ref), got)
    if CASES[case] is not None:                     # healthy envs untouched
        env = CASES[case][1]
        keep = [b for b in range(N) if b != env]
        assert_tree_equal(jax.tree.map(lambda x: x[keep], tree),
                          tree_map(lambda x: x[keep], got))


@pytest.mark.parametrize("case", list(CASES))
def test_assert_finite_matches_jax(sessions, case):
    _, tree = _case(sessions, case)
    if CASES[case] is None:
        JG.assert_finite(tree)
        TG.assert_finite(to_port(tree))
        return
    with pytest.raises(FloatingPointError) as ref:
        JG.assert_finite(tree, "session")
    with pytest.raises(FloatingPointError) as got:
        TG.assert_finite(to_port(tree), "session")
    assert str(got.value) == str(ref.value)


def test_guards_on_dicts_match_jax():
    """tests/test_aux.py's dict tree: ints pass through, one env resets."""
    a = np.arange(12.0, dtype=np.float32).reshape(4, 3)
    bad = {"a": a.copy(), "b": np.ones((4,), np.int32)}
    bad["a"][2, 1] = np.nan
    ref = {"a": np.zeros((4, 3), np.float32), "b": np.zeros(4, np.int32)}
    tb = {k: torch.as_tensor(v) for k, v in bad.items()}
    tr = {k: torch.as_tensor(v) for k, v in ref.items()}
    assert TG.finite_mask(tb).tolist() == \
        np.asarray(JG.finite_mask(bad)).tolist() == [True, True, False, True]
    jf, _ = JG.quarantine(bad, ref)
    tf, _ = TG.quarantine(tb, tr)
    for k in bad:
        assert np.array_equal(tf[k].numpy(), np.asarray(jf[k]))
    with pytest.raises(FloatingPointError, match="leaf #0"):
        TG.assert_finite(tb)


def test_assert_finite_reads_back_once():
    """On a finite tree: one scalar read of the device, whatever the
    number of leaves."""
    from torch.utils._python_dispatch import TorchDispatchMode

    reads = []

    class Probe(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.name().split("::")[-1].startswith("_local_scalar_dense"):
                reads.append(func.name())
            return func(*args, **(kwargs or {}))

    tree = {f"x{i}": torch.randn(3, 5) for i in range(12)}
    tree["n"] = torch.arange(4)
    with Probe():
        TG.assert_finite(tree)
    assert len(reads) == 1


def test_checkpoint_round_trip(sessions, tmp_path):
    """The port's session (None leaves: particles, sfx events) saved and
    loaded into a template of zeros: bit-exact, dtypes and devices of the
    template."""
    from clap_tpu_torch.engine.game import GameSessionState

    st = to_port(sessions[1])
    assert isinstance(st, GameSessionState) and st.particles is None
    path = save_checkpoint(str(tmp_path / "ckpt"), st)
    assert path.endswith(".npz")
    template = tree_map(torch.zeros_like, st)
    back = load_checkpoint(path, template)
    assert back.particles is None and back.sfx_events is None
    assert_tree_equal(jnp_tree(sessions[1]), back)
    assert back.engine.phys.pos.dtype == torch.float32
    # a template of another shape family is refused
    with pytest.raises(ValueError, match="arrays"):
        load_checkpoint(path, st.engine)


def test_checkpoint_engine_state_like_jax(tmp_path):
    """tests/test_aux.py's round trip on the port: engine_state_init with a
    body moved and the frame counter set."""
    from clap_tpu_torch.engine.state import engine_state_init

    st = engine_state_init(8, 4, 1, device="cpu")
    pos = st.pos.clone()
    pos[2] = torch.tensor([1.0, 2.0, 3.0])
    st = st._replace(pos=pos, frame=torch.tensor(77, dtype=torch.int32))
    st2 = load_checkpoint(save_checkpoint(str(tmp_path / "c.npz"), st), st)
    assert torch.equal(st2.pos, st.pos) and int(st2.frame) == 77
    assert st2.frame.dtype == torch.int32
