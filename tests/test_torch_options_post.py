"""``render_frame`` options of the post chain, the port against the JAX
package on tests/test_torch_options_frame.py's scene (2 views × 64² of the
``batched_render`` terrain, per-view cascades), with its bars (finite,
full-size, differs from the default frame, LDR PSNR >= 35 dB per view):
``ssao_mode="kernel"`` with the committed default table and with a
caller's own, ``lighting_lut`` on a baked preset, film grain on the
committed blue noise, and particles (billboards rastered by K1's plain
version, depth-tested, blended), some behind the camera and some across
its near plane."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu.render import lut as jlut
from clap_tpu_torch.ops.noise import blue_noise2d
from clap_tpu_torch.render import lut as tlut
from test_torch_options_frame import (N_VIEWS, check_option, port_default,
                                      port_frame, render_pair)
from test_torch_options_frame import scene  # noqa: F401  (fixture)


@pytest.fixture(scope="module")
def default(scene):  # noqa: F811
    return port_default(scene)


def test_ssao_kernel_mode(scene, default):  # noqa: F811
    ref, got = render_pair(scene, dict(ssao_mode="kernel"))
    check_option(ref, got, default)


def test_ssao_kernel_array_is_read(scene):  # noqa: F811
    """A caller's own hemisphere table replaces the default one."""
    kern = torch.as_tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(3), (16, 3))) * 0.5)
    own = port_frame(scene, dict(ssao_mode="kernel"), ssao_kernel_arr=kern)
    dflt = port_frame(scene, dict(ssao_mode="kernel"))
    assert np.isfinite(own).all() and np.abs(own - dflt).max() > 1e-3


def test_lighting_lut(scene, default):  # noqa: F811
    vol = tlut.bake_lut(tlut.lut_find("teal orange"), 32, device="cpu")
    jvol = jlut.bake_lut(jlut.lut_find("teal orange"), 32)
    ref, got = render_pair(scene, dict(lighting_lut=True),
                           dict(lut_volume=jvol), dict(lut_volume=vol))
    check_option(ref, got, default)


def test_film_grain(scene, default):  # noqa: F811
    noise = blue_noise2d(64, device="cpu")
    ref, got = render_pair(scene, dict(film_grain=0.03),
                           dict(grain_noise=jnp.asarray(noise.numpy())),
                           dict(grain_noise=noise))
    check_option(ref, got, default)


def test_particles(scene, default):  # noqa: F811
    """300 particles around the terrain's centre, 8 of them behind view 0
    and 8 straddling its near plane; the first 20 inactive."""
    rng = np.random.default_rng(12)
    pos = np.concatenate([
        rng.uniform(-6, 6, (300, 3)) * [1, 0.5, 1] + [0, 3, 0],
        np.asarray(scene["eyes"][0]) * 1.3 + rng.uniform(-1, 1, (8, 3)),
        np.asarray(scene["eyes"][0]) * 0.995 + rng.uniform(-0.1, 0.1,
                                                           (8, 3))]) \
        .astype(np.float32)
    active = np.arange(pos.shape[0]) >= 20
    color, alpha = (0.95, 0.9, 0.5), 0.6
    jp = (jnp.asarray(pos), jnp.float32(0.15), jnp.asarray(active), color,
          alpha)
    tp = (torch.as_tensor(pos).expand(N_VIEWS, -1, -1), 0.15,
          torch.as_tensor(active).expand(N_VIEWS, -1), color, alpha)
    ref, got = render_pair(scene, {}, dict(particles=jp), dict(particles=tp))
    check_option(ref, got, default)
