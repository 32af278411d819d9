"""``render_frame`` with each render option on, the port against the JAX
package: the JAX bench's ``batched_render`` terrain (chip_smoke.
build_batched) seen by 2 views at 64², each with its own cascades
(``render_frame_batch(shared_shadow=False)``), SSAO on, fog from 5 to 40 m
so that the fog options show. Per option and view: the port's frame is
finite, full-size, differs from its default frame, and its LDR PSNR
against the JAX package's is >= 35 dB.

This file: ``model_msaa`` 2, ``shadow_msaa`` 2, PCF (``shadow_vsm``
off) and laplace edges (``edge_sobel`` off). ``ssao_mode="kernel"``,
the LUT, film grain and particles are in tests/test_torch_options_post.py,
``fog_noise`` and ``material_fog`` in tests/test_torch_options_fog.py
(each file holds what one worker compiles of the JAX frame in well under
90 s). The default frame's parity is test_torch_batched.py's."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chip_smoke import build_batched
from clap_tpu.render import pipeline as jpl
from clap_tpu_torch.render import pipeline as tpl
from test_torch_batched import _jax_geometry, _jax_lights
from test_torch_common import psnr

N_VIEWS, RES = 2, 64
BASE = dict(width=RES, height=RES, shadow_size=64, film_grain=0.0,
            ssao=True, kernel_attrs=True, fog_near=5.0, fog_far=40.0)


@pytest.fixture(scope="module")
def scene():
    return build_batched("cpu", n_envs=N_VIEWS, res=RES)


def render_pair(scene, opts_kw, jax_kw=None, port_kw=None):
    """The JAX package's and the port's frames of both views under
    ``BASE`` + ``opts_kw``; ``jax_kw`` / ``port_kw`` go to each
    render_frame_batch as they are. Returns (ref, got), numpy."""
    o = {**BASE, **opts_kw}
    jopts, topts = jpl.RenderOptions(**o), tpl.RenderOptions(**o)
    jg, jl = _jax_geometry(scene["geom"]), _jax_lights()
    proj = jnp.asarray(scene["proj"].numpy())
    jkw = jax_kw or {}
    f = jax.jit(lambda vw, e: jpl.render_frame_batch(
        jopts, jg, vw, proj, jl, e, far=100.0, shared_shadow=False, **jkw))
    ref = np.asarray(f(jnp.asarray(scene["views"].numpy()),
                       jnp.asarray(scene["eyes"].numpy())))
    got = tpl.render_frame_batch(
        topts, scene["geom"], scene["views"], scene["proj"],
        scene["lights"], scene["eyes"], far=100.0, shared_shadow=False,
        **(port_kw or {})).numpy()
    return ref, got


def port_frame(scene, opts_kw=None, **kw):
    """The port's frames alone (numpy), as render_pair renders them."""
    return tpl.render_frame_batch(
        tpl.RenderOptions(**{**BASE, **(opts_kw or {})}), scene["geom"],
        scene["views"], scene["proj"], scene["lights"], scene["eyes"],
        far=100.0, shared_shadow=False, **kw).numpy()


def port_default(scene):
    return port_frame(scene)


def check_option(ref, got, default, min_change=1e-3):
    assert got.shape == (N_VIEWS, RES, RES, 3)
    assert np.isfinite(got).all()
    for v in range(N_VIEWS):
        assert np.abs(got[v] - default[v]).max() > min_change
        assert psnr(ref[v], got[v]) >= 35.0, (v, psnr(ref[v], got[v]))


OPTIONS = {
    "model_msaa 2": dict(model_msaa=2),
    "shadow_msaa 2": dict(shadow_msaa=2),
    "pcf": dict(shadow_vsm=False),
    "laplace edges": dict(edge_sobel=False),
}


@pytest.fixture(scope="module")
def default(scene):
    return port_default(scene)


def test_default_frame(default):
    assert default.shape == (N_VIEWS, RES, RES, 3)
    assert np.isfinite(default).all()
    assert all(default[v].std() > 0.01 for v in range(N_VIEWS))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_render_frame_option(scene, default, name):
    ref, got = render_pair(scene, OPTIONS[name])
    check_option(ref, got, default)
