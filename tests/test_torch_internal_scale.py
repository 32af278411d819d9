"""The shading-rate lever of the port against the JAX package:
``post.upsample_bilinear`` (integer factors within 1e-6 of the JAX
package's, other shapes within 1e-5 of ``jax.image.resize``),
``post.upsample2`` at a non-integer shape, ``render_frame`` with
``internal_scale=2`` on tests/test_internal_scale.py's cube scene at
128×96 (LDR PSNR >= 35 dB, and not the full-resolution frame), and 2 envs
of the composed testbed through ``SceneRenderer`` at internal_scale 2
against the JAX package's composition (>= 35 dB per env)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import post as jpost
from clap_tpu.render import scenerender as jsr
from clap_tpu.render.lights import lights_empty
from clap_tpu_torch import mathx as mx
from clap_tpu_torch.engine.frame import SceneRenderer
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import post as tpost
from test_render import make_cube_geom
from test_torch_common import psnr, to_port
from test_torch_render import (LOD_SCALE, OPTS, composed_scene, jax_views,
                               rendered_state)


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(3)
    return rng.uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("f", [2, 3, 4])
def test_upsample_bilinear_integer(img, f):
    got = tpost.upsample_bilinear(torch.as_tensor(img), 24 * f, 32 * f)
    assert got.shape == (2, 24 * f, 32 * f, 3)
    for e in range(2):
        want = np.asarray(jpost.upsample_bilinear(jnp.asarray(img[e]), 24 * f,
                                                  32 * f))
        np.testing.assert_allclose(got[e].numpy(), want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(37, 50), (61, 45), (30, 80)])
@pytest.mark.parametrize("channels", [True, False])
def test_upsample_bilinear_resize(img, shape, channels):
    """Non-integer factors: jax.image.resize's bilinear weights (edges
    clamp through the weights' normalisation)."""
    x = img if channels else img[..., 0]
    got = tpost.upsample_bilinear(torch.as_tensor(x), *shape).numpy()
    for e in range(2):
        want = np.asarray(jax.image.resize(jnp.asarray(x[e]),
                                           shape + x.shape[3:], "bilinear"))
        np.testing.assert_allclose(got[e], want, atol=1e-5, rtol=0)


def test_upsample2_non_integer(img):
    got = tpost.upsample2(torch.as_tensor(img), 37, 50).numpy()
    for e in range(2):
        want = np.asarray(jpost.upsample2(jnp.asarray(img[e]), 37, 50))
        np.testing.assert_allclose(got[e], want, atol=1e-5, rtol=0)


BASE = dict(width=128, height=96, shadow_size=64, film_grain=0.0)


@pytest.fixture(scope="module")
def cube_frames():
    """tests/test_internal_scale.py's frame: the JAX package's at
    internal_scale 2 and the port's at 2 and 1."""
    jg = make_cube_geom()
    eye = np.array([1.5, 1.2, 2.0], np.float32)
    lights = lights_empty(1)
    d = jnp.array([-0.4, -0.8, -0.4])
    lights = lights._replace(
        direction=lights.direction.at[0].set(d / jnp.linalg.norm(d)),
        color=lights.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
        is_dir=lights.is_dir.at[0].set(True),
        active=lights.active.at[0].set(True))
    view = jmx.mat4_look_at(jnp.asarray(eye), jnp.zeros(3),
                            jnp.array([0.0, 1.0, 0.0]))
    proj = jmx.mat4_perspective(jnp.pi / 3, 128 / 96, 0.1, 50.0)
    ref = np.asarray(jax.jit(lambda v, p, e: jpl.render_frame(
        jpl.RenderOptions(internal_scale=2, **BASE), jg, v, p, lights, e))(
            view, proj, jnp.asarray(eye)))
    per_env = {"verts", "face_valid"}
    tg = tpl.SceneGeometry(**{
        f: torch.as_tensor(np.array(v))[None] if f in per_env
        else torch.as_tensor(np.array(v))
        for f, v in zip(jg._fields, jg) if v is not None})
    te = torch.as_tensor(eye)[None]
    tview = mx.mat4_look_at(te, torch.zeros(1, 3),
                            torch.tensor([[0.0, 1.0, 0.0]]))
    tproj = mx.mat4_perspective(math.pi / 3, 128 / 96, 0.1, 50.0)
    tl = to_port(lights)

    def frame(scale):
        return tpl.render_frame(
            tpl.RenderOptions(internal_scale=scale, **BASE), tg, tview,
            tproj, tl, te)[0].numpy()

    return ref, frame(2), frame(1)


def test_internal_scale_frame(cube_frames):
    ref, half, full = cube_frames
    assert half.shape == full.shape == (96, 128, 3)
    assert np.isfinite(half).all() and half.min() >= 0 and half.max() <= 1
    assert psnr(ref, half) >= 35.0
    assert not np.allclose(half, full, atol=1e-4)      # the lever engaged


@pytest.fixture(scope="module")
def composed_half():
    """2 envs of the composed testbed (cluster records, kernel attrs, the
    static shadow) at internal_scale 2: the JAX package's
    render_frame_dynamic_batch and the port's SceneRenderer."""
    J, T, jrt, trt, jl, tl = composed_scene()
    st = rendered_state(J)
    jss = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                 shadow_size=128, far=200.0)
    opts = dict(OPTS, internal_scale=2)
    jopts = jpl.RenderOptions(**opts)
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)

    @jax.jit
    def jax_frame(sts):
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_cluster_records_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos, views, proj,
            cap=jopts.record_compact,
            skip_culling=J.cfg.entities.skip_culling, lod_scale=LOD_SCALE)
        return jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jss)

    ref = np.asarray(jax_frame(st))
    r = SceneRenderer(trt, tl, tpl.RenderOptions(**opts),
                      skip_culling=T.cfg.entities.skip_culling,
                      static_shadow=to_port(jss), lod_scale=LOD_SCALE)
    assert r.opts.internal_scale == 2
    ts = to_port(st)
    full = SceneRenderer(trt, tl, dataclasses.replace(r.opts,
                                                      internal_scale=1),
                         skip_culling=T.cfg.entities.skip_culling,
                         static_shadow=to_port(jss), lod_scale=LOD_SCALE)
    return ref, r(ts).numpy(), full(ts).numpy()


@pytest.mark.parametrize("env", range(2))
def test_scene_renderer_internal_scale(composed_half, env):
    ref, got, full = composed_half
    assert got.shape == full.shape == ref.shape
    assert np.isfinite(got[env]).all()
    assert psnr(ref[env], got[env]) >= 35.0
    assert not np.allclose(got[env], full[env], atol=1e-4)
