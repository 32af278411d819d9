"""The textured frame (the JAX bench's ``step_and_render_textured``,
bench.py:566-575, 620-666) at test size: skinned and textured characters,
textured trees, so the tables are not flat-eligible and the frame takes the
member-granularity assembly and the per-pixel attribute gather (K1 in
barycentric mode). 2 frames of game_step over 2 envs at 96² against the JAX
composition. Bars: G-buffer tid agreement >= 99.5 % per env, depth within
1e-4 where ids agree, LDR PSNR >= 35 dB per env, state within 1e-4, and
textured pixels that differ from the same frame rendered without textures.

The G-buffer comparison takes the JAX frame's per-env views, projection,
world vertices and face validity for both packages, and runs the JAX
package's surface stage op by op (no jit): XLA's fusion contracts products
into FMAs (it rounds 4.5 % of the jitted skinned vertices one ulp away from
the unfused product, which the port matches exactly), and a sliver's depth
plane amplifies one ulp of a corner to ~1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.engine import game as Jg
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.render.raster import rasterize
from clap_tpu_torch.scene import testbed as ttb
from test_torch_charskin import B, game_session, skinned_scene
from test_torch_common import assert_tree_close, jnp_tree, psnr
from test_torch_render import LOD_SCALE, OPTS, RES, jax_views

FRAMES = 2


@pytest.fixture(scope="module")
def textured_frames():
    from test_torch_game import seeded_inputs

    J, T, _, _, jrt, trt, jcs, tcs, jl, tl = skinned_scene(textured=True)
    assert not jsr.kernel_attrs_ok(jrt) and not tsr.kernel_attrs_ok(trt)
    jgw, tgw, jss, tss = game_session(J, T)
    jtex = jtb.testbed_textures()
    # bench.py:606-621: kernel_attrs only where the tables allow it
    jopts = jpl.RenderOptions(**{**OPTS, "kernel_attrs": False})
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)
    skip = J.cfg.entities.skip_culling
    jstatic = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                     shadow_size=128, far=200.0)

    @jax.jit
    def jax_step_and_render(gss, ins):           # bench.py:637-684
        gss = jax.vmap(lambda s, i: Jg.game_step(jgw, s, i))(gss, ins)
        sts = gss.engine
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_scene_geometry_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos,
            skip_culling=skip, char_skin=jcs, joint_mats=gss.joint_mats,
            lod_scale=LOD_SCALE)
        img = jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jstatic, textures=jtex)
        return gss, img, views, geom

    def jax_gbuffer(geom, views, env):
        """The JAX package's G-buffer of one env, op by op: its jitted
        ``rasterize`` runs as the plain function it wraps."""
        g = geom._replace(verts=geom.verts[env],
                          face_valid=geom.face_valid[env],
                          ent_rot=geom.ent_rot[env],
                          shadow_face_valid=geom.shadow_face_valid[env])
        clip = jpl.clip_transform(g.verts, views[env], proj)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpl, "rasterize", jpl.rasterize.__wrapped__)
            gb = jpl._surface_gather(jopts, g, clip, None, jtex)[0]
        return np.asarray(gb.tri_id), np.asarray(gb.depth)

    tstatic = tsr.bake_static_shadow(trt, T.state0.mx, tl.direction[0],
                                     shadow_size=128, far=200.0)
    # kernel_attrs asked for, as the flagship asks: the renderer takes the
    # gather path on its own
    renderer = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                             skip_culling=T.cfg.entities.skip_culling,
                             static_shadow=tstatic, lod_scale=LOD_SCALE,
                             char_skin=tcs,
                             textures=ttb.testbed_textures(device="cpu"))
    plain = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                          skip_culling=T.cfg.entities.skip_culling,
                          static_shadow=tstatic, lod_scale=LOD_SCALE,
                          char_skin=tcs)
    bf16 = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS, attr_bf16=True),
                         skip_culling=T.cfg.entities.skip_culling,
                         static_shadow=tstatic, lod_scale=LOD_SCALE,
                         char_skin=tcs, textures=renderer.textures)
    assert not renderer.opts.kernel_attrs and not renderer.cluster_records
    rng = np.random.default_rng(6)
    out = []
    for _ in range(FRAMES):
        jins, tins = seeded_inputs(rng, 2)
        jss, jimg, jviews, jgeom = jax_step_and_render(jss, jins)
        jtid, jdepth = zip(*(jax_gbuffer(jgeom, jviews, e) for e in range(B)))
        tss, timg = step_and_render(tgw, renderer, tss, tins)
        st = tss.engine
        views, verts, fv = (torch.as_tensor(np.array(x)) for x in (
            jviews, jgeom.verts, jgeom.face_valid))
        geom = renderer.geometry(st, views, tss.joint_mats)._replace(
            verts=verts, face_valid=fv)
        clip = tpl.clip_transform(geom.verts, views,
                                  torch.as_tensor(np.array(proj)))
        rec, binned = tpl.gather_records(renderer.opts, geom, clip)[:2]
        gb = rasterize(rec, binned, RES, RES)
        out.append(dict(
            jss=jnp_tree(jss), tss=tss, jimg=np.asarray(jimg),
            timg=timg.numpy(), jtid=np.stack(jtid),
            jdepth=np.stack(jdepth), ttid=gb.tri_id.numpy(),
            tdepth=gb.depth.numpy(),
            untextured=plain(st, tss.joint_mats).numpy(),
            bf16=bf16(st, tss.joint_mats).numpy()))
    return out


@pytest.mark.parametrize("env", range(B))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_textured_gbuffer(textured_frames, frame, env):
    f = textured_frames[frame]
    same = f["jtid"][env] == f["ttid"][env]
    assert same.mean() >= 0.995
    hit = same & (f["jtid"][env] >= 0)
    assert hit.mean() > 0.3
    assert np.abs(f["jdepth"][env][hit] - f["tdepth"][env][hit]).max() <= 1e-4


@pytest.mark.parametrize("env", range(B))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_textured_images(textured_frames, frame, env):
    f = textured_frames[frame]
    timg = f["timg"]
    assert timg.shape == (B, RES, RES, 3) and np.isfinite(timg).all()
    assert float(timg[env].std()) > 0.01
    assert psnr(f["jimg"][env], timg[env]) >= 35.0


@pytest.mark.parametrize("frame", range(FRAMES))
def test_textured_state(textured_frames, frame):
    f = textured_frames[frame]
    for part in ("engine", "game", "anim", "joint_mats"):
        assert_tree_close(getattr(f["jss"], part), getattr(f["tss"], part),
                          path=f"frame{frame}.{part}")


def test_textures_change_pixels(textured_frames):
    """The textured frame differs from the same state rendered without
    textures, and only where it should: the untextured and textured
    renders agree on most pixels (terrain, spheres)."""
    f = textured_frames[-1]
    d = np.abs(f["timg"] - f["untextured"]).max(-1)
    assert (d > 0.02).sum() > 0
    assert (d <= 1e-6).mean() > 0.5


def test_attr_bf16_frame_close(textured_frames):
    """RenderOptions.attr_bf16 stores the per-triangle table in bf16: the
    frame stays close to the float32 table's (the JAX package's bar in
    test_dynamic_batch_attr_bf16_close), ids and layers riding it exactly."""
    f = textured_frames[-1]
    d = np.abs(f["bf16"] - f["timg"])
    assert np.isfinite(f["bf16"]).all()
    assert d.mean() < 3e-3 and np.quantile(d, 0.999) < 0.1
