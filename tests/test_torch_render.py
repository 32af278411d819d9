"""The port's composed render against the JAX package on 2 envs at 96²
(the composed testbed cut to test size): bake_static_shadow,
shadow_pass_all (the per-env 4-cascade atlas), the kernel-attrs G-buffer
and render_frame_dynamic_batch. Bars: atlas depth within 1e-4 on
>= 99.5 % of texels, G-buffer tid agreement >= 99.5 % per env, LDR PSNR
>= 35 dB per env. Film grain noise and a LUT volume change nothing while
their options are off, as in the JAX package; the grain applies when on."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.engine import step as jstep
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.render import view as jview
from clap_tpu.render.camera import camera_view_proj
from clap_tpu.render.lights import lights_empty
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.engine.frame import SceneRenderer
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.render.view import cascade_subviews
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import COMPOSED_SCENE, psnr, to_port

B, RES = 2, 96
OPTS = dict(width=RES, height=RES, shadow_size=64, film_grain=0.0,
            record_compact=1024, raster_cap=512, kernel_attrs=True)
LOD_SCALE = 96 / 720.0


def composed_scene():
    """Both packages' composed testbed, render tables, light and options
    (the flagship configuration of bench.py:544-625 at test size)."""
    J = jtb.build_testbed(**COMPOSED_SCENE)
    T = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    ent = J.cfg.entities
    jrt = jsr.build_render_tables(
        jtb.testbed_models(J), np.asarray(ent.model_id),
        np.asarray(ent.active),
        entity_edge_id=jsr.default_edge_ids(np.asarray(ent.active),
                                            np.asarray(ent.body_is_char)),
        entity_shadow_static=jsr.shadow_static_mask(ent))
    te = T.cfg.entities
    trt = tsr.build_render_tables(
        ttb.testbed_models(T), te.model_id, te.active,
        entity_edge_id=tsr.default_edge_ids(te.active, te.body_is_char),
        entity_shadow_static=tsr.shadow_static_mask(te), device="cpu")
    d = jnp.array([-0.4, -0.8, -0.4])
    le = lights_empty(1)
    jl = le._replace(direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
                     color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
                     is_dir=le.is_dir.at[0].set(True),
                     active=le.active.at[0].set(True))
    return J, T, jrt, trt, jl, to_port(jl)


def jax_views(cam, proj):
    def view_of(c):
        q = jmx.qmul(
            jmx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), c.yaw),
            jmx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), c.pitch))
        return camera_view_proj(c.pos, q, jnp.pi / 3, 1.0)[0]

    views = jax.vmap(view_of)(cam)
    return views, jax.vmap(lambda v: jview.make_subview(v, proj).planes)(views)


def rendered_state(J):
    """Two envs of the JAX package's testbed that differ: env 1's bodies
    shifted, its camera turned; entity matrices and the camera refresh as
    in engine_step."""
    st = jtb.replicate_state(J.state0, B)
    st = st._replace(
        phys=st.phys._replace(pos=st.phys.pos.at[1, :, 0].add(0.35)),
        camera=st.camera._replace(yaw=st.camera.yaw.at[1].add(0.4)))
    st = jax.vmap(partial(jstep._scene_update, J.cfg))(st)
    return jax.vmap(lambda s: jstep._camera_update(
        J.cfg, s, jstep.inputs_zero(2), camera_occlusion=True))(st)


@pytest.fixture(scope="module")
def rendered():
    J, T, jrt, trt, jl, tl = composed_scene()
    st = rendered_state(J)
    jss = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                 shadow_size=128, far=200.0)
    tss = tsr.bake_static_shadow(trt, T.state0.mx, tl.direction[0],
                                 shadow_size=128, far=200.0)

    jopts = jpl.RenderOptions(**OPTS)
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)
    skip = J.cfg.entities.skip_culling

    @jax.jit
    def jax_frame(sts):
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_cluster_records_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos, views, proj,
            cap=jopts.record_compact, skip_culling=skip, lod_scale=LOD_SCALE)

        def per_env(g, vw):
            casc, _ = jview.cascade_subviews(vw, proj, jl.direction[0],
                                             0.1, 200.0)
            sm = jpl.shadow_pass_all(jopts, g, casc.view, casc.proj)
            gb = jpl._surface_kernel_attrs(jopts, g, None)[0]
            return sm, gb.tri_id, gb.depth

        sm, tid, depth = jax.vmap(per_env, in_axes=(axes, 0))(geom, views)
        img = jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jss)
        return sm, tid, depth, img

    ref = [np.asarray(x) for x in jax_frame(st)]

    ts = to_port(st)
    topts = tpl.RenderOptions(**OPTS)
    renderer = SceneRenderer(trt, tl, topts,
                             skip_culling=T.cfg.entities.skip_culling,
                             static_shadow=tss, lod_scale=LOD_SCALE)
    views = renderer.views(ts)
    geom = renderer.geometry(ts, views)
    casc, _ = cascade_subviews(views, renderer.proj, tl.direction[0],
                               0.1, 200.0)
    sm = tpl.shadow_pass_all(topts, geom, casc.view, casc.proj)
    gb = tpl._surface_kernel_attrs(topts, geom)[0]
    got = [sm.numpy(), gb.tri_id.numpy(), gb.depth.numpy(),
           renderer(ts).numpy()]
    # the frame again, handed film grain noise and a LUT volume while
    # their options are off: the JAX package reads neither then
    rng = np.random.default_rng(5)
    off = tpl.render_frame_dynamic_batch(
        topts, geom, views, renderer.proj, tl, ts.camera.pos, far=200.0,
        static_shadow=tss,
        grain_noise=torch.as_tensor(rng.uniform(size=(B, RES, RES, 3))),
        lut_volume=torch.as_tensor(rng.uniform(size=(16, 16, 16, 3))))
    # film grain on: the committed blue noise tiled over the 96² frame
    from clap_tpu_torch.ops.noise import blue_noise2d

    grain = tpl.render_frame_dynamic_batch(
        tpl.RenderOptions(**{**OPTS, "film_grain": 0.03}), geom, views,
        renderer.proj, tl, ts.camera.pos, far=200.0, static_shadow=tss,
        grain_noise=blue_noise2d(64, device="cpu"))
    # the frame again with its per-pass taps collected
    taps = {}
    tapped = tpl.render_frame_dynamic_batch(
        topts, geom, views, renderer.proj, tl, ts.camera.pos, far=200.0,
        static_shadow=tss, _taps=taps)
    return (jss, tss), ref, got + [off.numpy(), grain.numpy(),
                                   (tapped.numpy(), taps)]


def test_bake_static_shadow(rendered):
    (jss, tss), _, _ = rendered
    for a, b in zip(jss, tss):
        a = np.asarray(a)
        b = b.numpy()
        assert a.shape == b.shape
        assert (np.abs(a - b) <= 1e-4).mean() >= 0.995


@pytest.mark.parametrize("env", range(B))
def test_shadow_pass_all(rendered, env):
    _, ref, got = rendered
    a, b = ref[0][env], got[0][env]
    assert a.shape == b.shape == (4, 64, 64, 2)
    assert (np.abs(a - b) <= 1e-4).mean() >= 0.995


@pytest.mark.parametrize("env", range(B))
def test_gbuffer_ids(rendered, env):
    _, ref, got = rendered
    same = ref[1][env] == got[1][env]
    assert same.mean() >= 0.995
    hit = same & (ref[1][env] >= 0)
    assert hit.mean() > 0.3          # the view actually sees geometry
    assert np.abs(ref[2][env][hit] - got[2][env][hit]).max() <= 1e-4


@pytest.mark.parametrize("env", range(B))
def test_render_frame_dynamic_batch(rendered, env):
    _, ref, got = rendered
    a, b = ref[3][env], got[3][env]
    assert b.shape == (RES, RES, 3) and np.isfinite(b).all()
    assert psnr(a, b) >= 35.0


def test_envs_differ(rendered):
    _, ref, got = rendered
    assert np.abs(got[3][0] - got[3][1]).max() > 0.01


def test_unported_options_raise(rendered):
    """Nothing of render_frame raises any more: its per-pass images
    (``_taps``, the data of the JAX package's render_frame_debug), the
    last thing it did not carry, are ported, as is every render option of
    RenderOptions (tests/test_torch_options*.py). On the flagship's
    kernel-attrs frame the taps fill the passes the frame runs and leave
    its image bit-identical; the combine tap is the image."""
    from clap_tpu_torch.render.passbrowser import PASS_ORDER

    _, _, got = rendered
    img, taps = got[6]
    assert np.array_equal(img, got[3])
    assert set(taps) <= set(PASS_ORDER)
    for name in ("shadow_atlas", "lighting_hdr", "emission", "view_normals",
                 "depth", "edges", "smaa_weights", "ssao", "bloom",
                 "combine"):
        assert taps[name].shape[0] == B, name
    assert np.array_equal(taps["combine"].numpy(), img)
    assert taps["lighting_hdr"].shape == (B, RES, RES, 3)


def test_grain_and_lut_unread_while_off(rendered):
    """grain_noise and lut_volume with film_grain 0 and lighting_lut off:
    the frame is the one rendered without them."""
    _, _, got = rendered
    assert np.array_equal(got[3], got[4])


def test_frame_constants_stay_unchanged():
    """mathx.const's tensors are shared by every caller on a device: two
    engine steps and two frames of the composed testbed leave each one
    equal to the values it was made from."""
    from clap_tpu_torch import mathx as tmx
    from clap_tpu_torch.bridge import tree_map
    from clap_tpu_torch.engine.step import engine_step, inputs_zero

    _, T, _, trt, _, tl = composed_scene()
    renderer = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                             skip_culling=T.cfg.entities.skip_culling,
                             lod_scale=LOD_SCALE)
    st = ttb.replicate_state(T.state0, B)
    ins = tree_map(lambda x: x.expand(B, *x.shape).clone(),
                   inputs_zero(2, device="cpu"))
    ins.motion[:, 0, 0] = 1.0
    for _ in range(2):
        st = engine_step(T.cfg, st, ins, camera_occlusion=True)
        assert np.isfinite(renderer(st).numpy()).all()
    assert tmx.CONSTS
    for (values, dtype, device), t in tmx.CONSTS.items():
        torch.testing.assert_close(
            t, torch.tensor(values, dtype=dtype, device=device), rtol=0,
            atol=0, equal_nan=True, msg=f"const {values} was written to")


def test_film_grain_raises_when_on(rendered):
    """Film grain with film_grain > 0 and grain_noise given raised
    NotImplementedError while the grain was not ported; now the frame
    takes it: finite, and off the grain-free frame on most pixels by at
    most the grain's amplitude (0.015 before the sRGB curve, whose slope
    is 12.92 at black)."""
    _, _, got = rendered
    grain, plain = got[5], got[3]
    assert np.isfinite(grain).all()
    d = np.abs(grain - plain)
    assert (d.max(-1) > 1e-4).mean() > 0.5
    assert d.max() < 0.015 * 12.92 * 1.1
