"""The port's input fuzzer against the JAX package's.

torch cannot reproduce ``jax.random``, so the port draws from a
counter-based hash of (seed, env, frame, draw index). Held here:

- with the JAX package's own draws (``draws=``), ``fuzz_inputs`` and
  ``fuzz_batch`` equal the reference's inputs within 1e-6, jumps exact;
- the port's stream is deterministic in (seed, frame) and differs across
  frames, seeds and envs;
- env *i*'s inputs are the same at 8 and at 64 envs, and the single
  stream of ``fuzz_inputs`` is env 0's;
- the draws are uniforms in [0, 1) on the 2⁻²⁴ grid, with the moments of
  a uniform, and the inputs have the reference's distribution shape."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clap_tpu.engine import fuzzer as JF
from clap_tpu_torch.engine import fuzzer as TF
import test_torch_common  # noqa: F401  (one torch thread per worker)


def jax_draws(key, frame, n_chars):
    """The draws the JAX package's fuzz_inputs takes (fuzzer.py:24-30):
    angle, magnitude and jump uniforms, then the camera normals."""
    k = jax.random.fold_in(key, frame)
    k1, k2, k3, k4 = jax.random.split(k, 4)
    return tuple(torch.as_tensor(np.array(d)) for d in (
        jax.random.uniform(k1, (n_chars,)),
        jax.random.uniform(k2, (n_chars,)),
        jax.random.uniform(k3, (n_chars,)), jax.random.normal(k4, (3,))))


def _close(ref, got):
    np.testing.assert_allclose(got.motion.numpy(), np.asarray(ref.motion),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.cam_delta.numpy(),
                               np.asarray(ref.cam_delta), atol=1e-6, rtol=0)
    assert np.array_equal(got.jump.numpy(), np.asarray(ref.jump))
    assert got.motion.dtype == torch.float32 and got.jump.dtype == torch.bool


@pytest.mark.parametrize("n_chars", [1, 3])
@pytest.mark.parametrize("frame", [0, 10, 4095])
def test_fuzz_inputs_with_jax_draws(frame, n_chars):
    key = jax.random.PRNGKey(5)
    ref = JF.fuzz_inputs(key, jnp.int32(frame), n_chars)
    got = TF.fuzz_inputs(0, frame, n_chars,
                         draws=jax_draws(key, jnp.int32(frame), n_chars))
    _close(ref, got)


@pytest.mark.parametrize("jump_prob,turn_scale", [(0.5, 1.0), (0.02, 3.0)])
def test_fuzz_inputs_options_with_jax_draws(jump_prob, turn_scale):
    key = jax.random.PRNGKey(9)
    ref = JF.fuzz_inputs(key, jnp.int32(3), 2, jump_prob=jump_prob,
                         turn_scale=turn_scale)
    got = TF.fuzz_inputs(0, 3, 2, jump_prob=jump_prob, turn_scale=turn_scale,
                         draws=jax_draws(key, jnp.int32(3), 2))
    _close(ref, got)


def test_fuzz_batch_with_jax_draws():
    """Each env's key is fold_in(key, env) (fuzzer.py:35-38); the port's
    fuzz_inputs takes the batch of draws at once."""
    key, n, frame = jax.random.PRNGKey(0), 6, jnp.int32(17)
    ref = JF.fuzz_batch(key, frame, n, 2)
    per_env = [jax_draws(jax.random.fold_in(key, i), frame, 2)
               for i in range(n)]
    draws = tuple(torch.stack(x) for x in zip(*per_env))
    _close(ref, TF.fuzz_inputs(0, 17, 2, draws=draws))


def test_stream_is_deterministic_in_seed_and_frame():
    a = TF.fuzz_inputs(5, 10, device="cpu")
    b = TF.fuzz_inputs(5, 10, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    for other in (TF.fuzz_inputs(5, 11, device="cpu"),
                  TF.fuzz_inputs(6, 10, device="cpu"),
                  TF.fuzz_inputs(5, 10, device="cpu", env=1)):
        assert not torch.equal(a.motion, other.motion)
    # a 0-d frame tensor draws what the int does
    c = TF.fuzz_inputs(5, torch.tensor(10, dtype=torch.int32), device="cpu")
    assert torch.equal(a.motion, c.motion)


@pytest.mark.parametrize("n_chars", [1, 2])
def test_env_streams_do_not_depend_on_the_batch(n_chars):
    small = TF.fuzz_batch(3, 42, 8, n_chars, device="cpu")
    big = TF.fuzz_batch(3, 42, 64, n_chars, device="cpu")
    for a, b in zip(small[:3], big[:3]):
        assert torch.equal(a, b[:8])
    one = TF.fuzz_inputs(3, 42, n_chars, device="cpu")
    assert torch.equal(one.motion, small.motion[0])
    assert torch.equal(one.cam_delta, small.cam_delta[0])
    seven = TF.fuzz_inputs(3, 42, n_chars, device="cpu", env=7)
    assert torch.equal(seven.motion, big.motion[7])
    assert big.motion.shape == (64, n_chars, 2) and big.jump.shape == (
        64, n_chars) and big.cam_delta.shape == (64, 3)
    assert small.motion[:, 0, 0].std() > 0          # envs differ


def test_draws_are_uniform_on_the_grid():
    u = TF.fuzz_draws(0, 7, torch.arange(20000), 2, device="cpu")
    assert u.shape == (20000, TF.n_draws(2)) and u.dtype == torch.float32
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u * (1 << 24), torch.floor(u * (1 << 24)))
    np.testing.assert_allclose(u.mean(0).numpy(), 0.5, atol=0.01)
    np.testing.assert_allclose(u.var(0).numpy(), 1 / 12, atol=0.003)
    # neighbouring draw indices and envs are not correlated
    c = np.corrcoef(u.numpy().T)
    assert np.abs(c - np.eye(c.shape[0])).max() < 0.03


def test_inputs_have_the_reference_distribution():
    """Against the JAX package's own batch: motion inside the unit disc
    with the same mean radius, jump rate near 2 %, camera sigmas 0.01,
    0.03 and 0.05."""
    n = 20000
    got = TF.fuzz_batch(1, 0, n, device="cpu")
    ref = JF.fuzz_batch(jax.random.PRNGKey(1), jnp.int32(0), n)
    r_got = got.motion.norm(dim=-1).numpy()
    r_ref = np.linalg.norm(np.asarray(ref.motion), axis=-1)
    assert r_got.max() <= 1.0
    assert abs(r_got.mean() - r_ref.mean()) < 0.01
    assert abs(float(got.jump.float().mean()) - 0.02) < 0.005
    np.testing.assert_allclose(got.cam_delta.std(0).numpy(),
                               np.asarray(ref.cam_delta).std(0), rtol=0.05)
