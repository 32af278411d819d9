"""Kernel-side attributes over member-granularity geometry and the
shared-scene batch of the port against the JAX package, on the JAX bench's
``batched_render`` scene (chip_smoke.build_batched) cut to 96²:

- the 22-column extras records ``surface_records`` builds from faces and
  normals (``vextra``), with and without a corner stream
  (``corner_normals``), with and without ``record_compact``: within 1e-5
  of the JAX package's, ids and validity exact, env by env with per-env
  face validity; the kernel-attrs G-buffer against the JAX package's
  ``_surface_kernel_attrs`` (packed ids >= 99.5 %, normals within 1e-4
  where they agree);
- ``render_frame_batch`` at 4 views × 96² with the shared light atlas and
  with per-view cascades: LDR PSNR >= 35 dB per view; the shared atlas is
  one K2 walk for all views."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import build_batched
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import raster as jra
from clap_tpu.render.lights import lights_empty
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import raster as tra
from test_torch_common import psnr

N_VIEWS, RES = 4, 96


@pytest.fixture(scope="module")
def scene():
    return build_batched("cpu", n_envs=N_VIEWS, res=RES)


def _jax_geometry(geom):
    """The port's shared geometry as the JAX package's SceneGeometry."""
    return jpl.SceneGeometry(**{f: jnp.asarray(v.numpy())
                                for f, v in zip(geom._fields, geom)
                                if v is not None})


def _jax_lights():
    le = lights_empty(1)
    d = jnp.array([-0.4, -0.8, -0.4])
    return le._replace(
        direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
        color=le.color.at[0].set(jnp.ones(3)),
        is_dir=le.is_dir.at[0].set(True),
        active=le.active.at[0].set(True))


def _jopts(opts, **kw):
    return jpl.RenderOptions(**{**{f: getattr(opts, f) for f in (
        "width", "height", "shadow_size", "film_grain", "ssao",
        "kernel_attrs", "record_compact")}, **kw})


def _member_case(scene, corners, compact):
    """Two envs (views 0 and 1) of the shared terrain, each with its own
    random face validity; optionally with corner streams and compaction."""
    g = scene["geom"]
    opts = scene["opts"]
    T = g.faces.shape[0]
    rng = np.random.default_rng(31)
    fv = torch.as_tensor(rng.random((2, T)) > 0.3)
    g = tpl.per_env(g, 2)._replace(face_valid=fv)
    if corners:
        f = g.faces.numpy()
        g = g._replace(
            corner_verts=tra.expand_corners_major(
                g.verts[0].numpy(), f, "cpu").expand(2, -1, -1),
            corner_normals=tra.expand_corners_major(g.normals.numpy(), f,
                                                    "cpu"))
    if compact:
        opts = dataclasses.replace(opts, record_compact=2048)
    src = g.corner_verts if corners else g.verts
    clip = tpl.clip_transform(src, scene["views"][:2], scene["proj"])
    return g, opts, clip


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("corners", [False, True])
def test_member_kernel_attr_records(scene, corners, compact):
    g, opts, clip = _member_case(scene, corners, compact)
    assert opts.kernel_attrs
    rec, _binned, stride = tpl.surface_records(opts, g, clip)
    assert rec.shape[1] == 22
    for env in range(2):
        faces, fvalid = jnp.asarray(g.faces.numpy()), \
            jnp.asarray(g.face_valid[env].numpy())
        fent = jnp.asarray(g.face_entity.numpy())
        vex = jnp.asarray((g.corner_normals if corners else g.normals)
                          .numpy())
        if opts.record_compact and not corners:
            faces, fvalid, fent = jra.compact_faces(
                faces, fvalid, opts.record_compact, extra=fent)
        jrec, jok, _, _ = jra.clip_near_records(
            jnp.asarray(clip[env].numpy()), faces, RES, RES, fvalid,
            vextra=vex, tid_pack=fent, pack_stride=stride,
            pre_expanded=corners)
        jrec = np.asarray(jrec)
        got = rec[env].numpy()
        assert got.shape == jrec.shape
        assert np.array_equal(got[12], jrec[12])          # tid·stride + ent
        assert np.array_equal(got.any(0), np.asarray(jok))
        np.testing.assert_allclose(got, jrec, atol=1e-5, rtol=1e-5)


def test_member_kernel_attr_gbuffer(scene):
    """The kernel-attrs G-buffer over a compacted corner-free stream
    against the JAX package's _surface_kernel_attrs, env by env."""
    g, opts, clip = _member_case(scene, False, True)
    gb, nrm = tpl._surface_kernel_attrs(opts, g, clip)[:2]
    jopts = _jopts(opts)
    for env in range(2):
        jg = _jax_geometry(g._replace(
            verts=g.verts[env], face_valid=g.face_valid[env],
            ent_rot=g.ent_rot[env], shadow_face_valid=None))
        jgb, jnrm = jpl._surface_kernel_attrs(
            jopts, jg, jnp.asarray(clip[env].numpy()))[:2]
        jtid = np.asarray(jgb.tri_id)
        tid = gb.tri_id[env].numpy()
        same = jtid == tid
        assert same.mean() >= 0.995
        hit = same & (tid >= 0)
        assert hit.mean() > 0.1                 # 70 % of the faces drawn
        d = np.abs(np.asarray(jnrm) - nrm[env].numpy())[hit]
        assert d.max() <= 1e-4


def test_kernel_attrs_need_corner_normals(scene):
    g, opts, clip = _member_case(scene, True, False)
    with pytest.raises(ValueError):
        tpl.surface_records(opts, g._replace(corner_normals=None), clip)


@pytest.fixture(scope="module")
def batch_frames(scene):
    """JAX's render_frame_batch and the port's, with the shared atlas and
    with per-view cascades; the port's K1/K2 walks of the shared frame."""
    jg = _jax_geometry(scene["geom"])
    jopts = _jopts(scene["opts"])
    jl = _jax_lights()
    views = jnp.asarray(scene["views"].numpy())
    eyes = jnp.asarray(scene["eyes"].numpy())
    proj = jnp.asarray(scene["proj"].numpy())
    out = {}
    walks = []
    real = tra.raster_depth_ref, tra.raster_tile_ref
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tra, "raster_depth_ref",
                   lambda *a: walks.append("K2") or real[0](*a))
        mp.setattr(tra, "raster_tile_ref",
                   lambda *a: walks.append("K1") or real[1](*a))
        for shared in (True, False):
            f = jax.jit(lambda vw, e, s=shared: jpl.render_frame_batch(
                jopts, jg, vw, proj, jl, e, far=100.0, shared_shadow=s))
            walks.clear()
            got = tpl.render_frame_batch(
                scene["opts"], scene["geom"], scene["views"], scene["proj"],
                scene["lights"], scene["eyes"], far=100.0,
                shared_shadow=shared).numpy()
            out[shared] = (np.asarray(f(views, eyes)), got, list(walks))
    return out


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("view", range(N_VIEWS))
def test_render_frame_batch(batch_frames, shared, view):
    ref, got, _ = batch_frames[shared]
    assert got.shape == (N_VIEWS, RES, RES, 3)
    assert np.isfinite(got[view]).all() and got[view].std() > 0.01
    assert psnr(ref[view], got[view]) >= 35.0


def test_shared_atlas_is_one_walk(batch_frames):
    """The shared atlas is one depth walk for all views and the views
    differ; per-view cascades also take one (batched) walk."""
    _, got, walks = batch_frames[True]
    assert walks == ["K2", "K1"]
    assert np.abs(got[0] - got[1]).max() > 0.01
    assert batch_frames[False][2] == ["K2", "K1"]
    assert np.abs(batch_frames[True][1] - batch_frames[False][1]).max() \
        > 1e-3
