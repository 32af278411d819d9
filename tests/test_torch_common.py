"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py),
plus the bridge's own round-trip tests.

Inputs are made from a seed with numpy and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and runs its Pallas kernels in
interpret mode, as the JAX package's own tests do. Other test files import
these helpers (``from test_torch_common import ...``).
"""
import numpy as np
import pytest
import torch

import jax

from clap_tpu_torch.bridge import _PORT_ONLY, from_numpy, to_numpy

# xdist runs several workers on a few cores: one torch thread each
torch.set_num_threads(1)

# the entry() scene (__graft_entry__.py:17-37) and the composed testbed cut
# to test size (bench.py:544-545 shape: 2 chars, chunked terrain)
ENTRY_SCENE = dict(seed=7, side=32.0, nr_v=32, n_dynamic=4, max_entities=32)
COMPOSED_SCENE = dict(seed=7, side=32.0, nr_v=32, n_dynamic=4,
                      max_entities=32, n_chars=2, terrain_chunks=2)


def jnp_tree(tree):
    """JAX-package tree → the same tree with numpy leaves."""
    return jax.tree.map(np.asarray, tree)


def to_port(tree, device="cpu"):
    """JAX-package tree → the port's tree of the same type name."""
    return from_numpy(jnp_tree(tree), device)


def _fields_match(ref, got, path):
    """The JAX package's fields lead the port type's; what follows them is
    the port's host-side fields (bridge._PORT_ONLY)."""
    n = len(ref._fields)
    assert tuple(ref._fields) == tuple(got._fields[:n]), path
    assert all((type(got).__name__, f) in _PORT_ONLY
               for f in got._fields[n:]), path


def assert_tree_close(ref, got, atol=1e-4, rtol=1e-4, path="tree"):
    """Field-by-field comparison of a JAX-package tree (numpy leaves; plain
    tuples element by element) and a port tree: int/bool leaves exact,
    float leaves within atol + rtol."""
    if ref is None:
        assert got is None, path
        return
    if hasattr(ref, "_fields"):
        _fields_match(ref, got, path)
        for f, a, b in zip(ref._fields, ref, got):
            assert_tree_close(a, b, atol, rtol, f"{path}.{f}")
        return
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree_close(a, b, atol, rtol, f"{path}[{i}]")
        return
    a = np.asarray(ref)
    b = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a, err_msg=path)
    else:
        np.testing.assert_allclose(b, a, atol=atol, rtol=rtol, err_msg=path)


def assert_tree_equal(ref, got, path="tree"):
    """Bit-exact field-by-field comparison (values and dtypes)."""
    if ref is None:
        assert got is None, path
        return
    if hasattr(ref, "_fields"):
        _fields_match(ref, got, path)
        for f, a, b in zip(ref._fields, ref, got):
            assert_tree_equal(a, b, f"{path}.{f}")
        return
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree_equal(a, b, f"{path}[{i}]")
        return
    a = np.asarray(ref)
    b = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    assert np.array_equal(a, b), path


_JAX_BENCH = """
import json, sys
import numpy as np
import bench
out = getattr(bench, sys.argv[1])(**json.loads(sys.argv[2]))
if isinstance(out, np.ndarray):
    np.save(sys.argv[3], out)
else:
    with open(sys.argv[3], "w") as f:
        json.dump(out, f)
"""


def jax_bench(tmp_path, fn, fast_compile=False, **kw):
    """Start ``bench.<fn>(**kw)``, bench.py's own function under JAX on the
    CPU, in a process of its own: its compile cache (``CLAP_TPU_COMP_CACHE``)
    in ``tmp_path``, so that it writes none into the repo and leaves this
    process's JAX settings alone; the caller runs the port meanwhile.
    ``fast_compile``: XLA's backend optimisation off (LLVM -O0), about a
    fifth less compile for the composed frame, whose bar is a PSNR.
    Returns ``wait()`` -> its dict, or its frames as numpy."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    flags = os.environ.get("XLA_FLAGS", "")
    if fast_compile:
        flags += " --xla_backend_optimization_level=0"
    out = tmp_path / f"{fn}.out"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags.strip(),
               CLAP_TPU_COMP_CACHE=str(tmp_path / "jit"))
    err = tmp_path / f"{fn}.err"
    with open(err, "w") as f:
        p = subprocess.Popen([sys.executable, "-c", _JAX_BENCH, fn,
                              json.dumps(kw), str(out)], cwd=repo, env=env,
                             stderr=f)

    def wait():
        try:
            p.wait(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
        assert p.returncode == 0, err.read_text()[-3000:]
        npy = out.with_suffix(".out.npy")
        return np.load(npy) if npy.exists() else json.loads(out.read_text())

    return wait


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


# ---------------------------------------------------------------------------
# the bridge itself
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def entry_testbed():
    from clap_tpu.scene.testbed import build_testbed

    return build_testbed(**ENTRY_SCENE)


@pytest.mark.parametrize("part", ["cfg", "state0"])
def test_bridge_round_trip(entry_testbed, part):
    """JAX tree → port tree → numpy reproduces every leaf bit for bit."""
    ref = jnp_tree(getattr(entry_testbed, part))
    assert_tree_equal(ref, to_numpy(from_numpy(ref, "cpu")))


def test_bridge_rejects_unknown_types():
    from typing import NamedTuple

    class NotPorted(NamedTuple):
        x: np.ndarray

    with pytest.raises(TypeError):
        from_numpy(NotPorted(x=np.zeros(2)), "cpu")


# ---------------------------------------------------------------------------
# engine_step trajectories of both packages on one loaded scene
# ---------------------------------------------------------------------------

def seeded_inputs(seed: int, n_envs: int, n_chars: int, frames: int,
                  jump_p: float = 0.05, cam: float = 0.05):
    """``frames`` (motion (B, C, 2), jump (B, C), cam_delta (B, 3)) numpy
    input triples made from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(frames):
        out.append((rng.uniform(-1, 1, (n_envs, n_chars, 2)
                                ).astype(np.float32),
                    rng.uniform(size=(n_envs, n_chars)) < jump_p,
                    rng.uniform(-cam, cam, (n_envs, 3)).astype(np.float32)))
    return out


def engine_trajectories(jcfg, tcfg, js, ts, inputs, camera_occlusion=True,
                        per_env=False):
    """Step the JAX package (jit of vmap) and the port over the same input
    triples from batched states ``js`` / ``ts``. Returns [(JAX state with
    numpy leaves, port state)] per frame. ``per_env``: JAX jits the
    unbatched step and runs it env by env (a scene whose batched program
    takes XLA long to compile)."""
    import jax.numpy as jnp

    from clap_tpu.engine.step import engine_step as jstep
    from clap_tpu.engine.step import inputs_zero as jinputs_zero
    from clap_tpu_torch.engine.step import Inputs, engine_step

    one = jax.jit(lambda s, i: jstep(jcfg, s, i,
                                     camera_occlusion=camera_occlusion))
    if per_env:
        def step(s, i):
            s, i = jnp_tree((s, i))
            outs = [jnp_tree(one(*jax.tree.map(lambda x: x[b], (s, i))))
                    for b in range(i.jump.shape[0])]
            return jax.tree.map(lambda *xs: np.stack(xs), *outs)
    else:
        step = jax.jit(jax.vmap(one))
    out = []
    for mot, jmp, cam in inputs:
        B, C = jmp.shape
        ji = jinputs_zero(C)._replace(
            motion=jnp.asarray(mot), jump=jnp.asarray(jmp),
            cam_delta=jnp.asarray(cam), dash=jnp.zeros((B, C), bool))
        ti = Inputs(motion=torch.as_tensor(mot), jump=torch.as_tensor(jmp),
                    cam_delta=torch.as_tensor(cam),
                    dash=torch.zeros((B, C), dtype=torch.bool))
        js = step(js, ji)
        ts = engine_step(tcfg, ts, ti, camera_occlusion=camera_occlusion)
        out.append((jnp_tree(js), ts))
    return out
