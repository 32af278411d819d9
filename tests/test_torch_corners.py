"""Corner-expanded static streams of the port against the JAX package:
``expand_corners_record`` / ``expand_corners_major`` exact; records built
from a corner stream bit-identical to records built from the faces
(``assemble_tri_records``, ``clip_near_records`` in both layouts, on a
camera that near-clips) and equal to the JAX package's; and the JAX
bench's ``full_frame`` scene (chip_smoke.build_full_frame at nr_v 12, 4
cubes, 128×96, corner streams) against the JAX package's render_frame.
Bars: G-buffer tid agreement >= 99.5 % and depth within 1e-4 where ids
agree, LDR PSNR >= 35 dB, and the port's frame from the corner streams
equal to its frame from the faces."""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import build_full_frame
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import raster as jra
from clap_tpu.render.lights import lights_empty
from clap_tpu_torch import mathx as mx
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import raster as tra
from test_torch_common import psnr

W, H = 128, 96


@pytest.fixture(scope="module")
def scene():
    return build_full_frame("cpu", nr_v=12, n_cubes=4, width=W, height=H)


def _jax_geometry(w):
    """The same scene as the JAX package's SceneGeometry, its corner
    streams expanded by the JAX package."""
    vx, nrm, f = w["host"]
    V = vx.shape[0]
    return jpl.SceneGeometry(
        verts=jnp.asarray(vx), normals=jnp.asarray(nrm), faces=jnp.asarray(f),
        face_valid=jnp.ones((f.shape[0],), bool),
        base_color=jnp.full((V, 3), 0.45),
        rough_metal=jnp.tile(jnp.array([[0.8, 0.0]]), (V, 1)),
        emission=jnp.zeros((V, 3)),
        corner_verts=jnp.asarray(jra.expand_corners_major(vx, f)),
        shadow_corner_verts=jnp.asarray(jra.expand_corners_record(vx, f)))


def _jax_lights():
    le = lights_empty(2)
    d = jnp.array([-0.4, -0.8, -0.4])
    return le._replace(
        direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
        color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
        is_dir=le.is_dir.at[0].set(True),
        active=le.active.at[0].set(True))


@pytest.mark.parametrize("order", ["record", "major"])
def test_expand_corners_exact(scene, order):
    vx, nrm, f = scene["host"]
    for table in (vx, nrm):
        a = getattr(jra, f"expand_corners_{order}")(table, f)
        b = getattr(tra, f"expand_corners_{order}")(table, f, "cpu")
        assert b.dtype == torch.float32 and b.shape == (3 * f.shape[0], 3)
        assert np.array_equal(a, b.numpy())


def _near_clip(scene):
    """A low camera inside the terrain's extent (some faces cross the near
    plane) and its clip-space vertices and corners."""
    vx, nrm, f = scene["host"]
    eye = torch.tensor([[2.0, 1.5, 3.0]])
    view = mx.mat4_look_at(eye, torch.tensor([[-6.0, 0.0, -8.0]]),
                           torch.tensor([[0.0, 1.0, 0.0]]))
    proj = mx.mat4_perspective(math.pi / 3, W / H, 0.1, 200.0)
    clipv = tpl.clip_transform(torch.as_tensor(vx)[None], view, proj)
    clipc = tpl.clip_transform(tra.expand_corners_major(vx, f, "cpu")[None],
                               view, proj)
    return view, proj, clipv, clipc


@pytest.mark.parametrize("builder", ["assemble_tri_records", "clip_near",
                                     "clip_near_extras"])
def test_corner_records_bit_identical(scene, builder):
    """Records from a corner stream equal records from the faces bit for
    bit (the face path's gather and the v0/v2/v1 swap baked into the
    stream), and both equal the JAX package's (run eagerly) within 1e-6,
    ids and validity exact."""
    vx, nrm, f = scene["host"]
    rng = np.random.default_rng(21)
    valid = rng.random(f.shape[0]) > 0.1
    view, proj, clipv, clipc = _near_clip(scene)
    tf, tv = torch.as_tensor(f), torch.as_tensor(valid)[None]
    jclip = jnp.asarray(clipv[0].numpy())
    if builder == "assemble_tri_records":
        sx, sy, z, iw = tra.project_to_screen(clipv, W, H)
        a = tra.assemble_tri_records(sx, sy, z, iw, tf, tv)
        tbl = torch.stack([sx[0], sy[0], z[0], iw[0]], -1).numpy()
        ex = tra.expand_corners_record(tbl, f, "cpu")[None]
        b = tra.assemble_tri_records(*ex.unbind(-1), tf, tv,
                                     pre_expanded=True)
        j = jra.assemble_tri_records(*jra.project_to_screen(jclip, W, H),
                                     jnp.asarray(f), jnp.asarray(valid))
    else:
        kw, jkw, kwc = {}, {}, {}
        if builder == "clip_near_extras":
            kw = dict(vextra=torch.as_tensor(nrm))
            jkw = dict(vextra=jnp.asarray(nrm))
            kwc = dict(vextra=tra.expand_corners_major(nrm, f, "cpu"))
        a = tra.clip_near_records(clipv, tf, W, H, tv, **kw)[:2]
        b = tra.clip_near_records(clipc, tf, W, H, tv, pre_expanded=True,
                                  **kwc)[:2]
        j = jra.clip_near_records(jclip, jnp.asarray(f), W, H,
                                  jnp.asarray(valid), **jkw)[:2]
        n_in = (clipc[0, :, 3].reshape(3, -1) > 1e-4).sum(0)
        assert int(((n_in > 0) & (n_in < 3)).sum()) > 0   # near-clipped
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    rec, ok = a[0][0].numpy(), a[1][0].numpy()
    jrec, jok = np.asarray(j[0]), np.asarray(j[1])
    assert np.array_equal(ok, jok)
    assert np.array_equal(rec[12], jrec[12])
    np.testing.assert_allclose(rec, jrec, atol=1e-6, rtol=1e-6)


def test_corner_stream_must_match_faces(scene):
    """A corner stream of another face table raises, as the JAX package's
    trace-time check does."""
    w = scene
    g = w["geom"]
    bad = g._replace(corner_verts=g.corner_verts[:, :-3])
    with pytest.raises(ValueError):
        tpl.render_frame(w["opts"], bad, w["view"], w["proj"], w["lights"],
                         w["eye"])
    bad = g._replace(shadow_corner_verts=g.shadow_corner_verts[:, :-3])
    with pytest.raises(ValueError):
        tpl.render_frame(w["opts"], bad, w["view"], w["proj"], w["lights"],
                         w["eye"])


@pytest.fixture(scope="module")
def frames(scene):
    """(JAX tid, depth, image) and the port's, from the corner streams;
    and the port's image from the faces."""
    w = scene
    jg = _jax_geometry(w)
    jopts = jpl.RenderOptions(**{f: getattr(w["opts"], f) for f in (
        "width", "height", "shadow_size", "film_grain", "raster_cap")})
    jl = _jax_lights()

    @jax.jit
    def jframe(g, v, p, e):
        clip = jpl.clip_transform(g.corner_verts, v, p)
        gb = jpl._surface_gather(jopts, g, clip)[0]
        return gb.tri_id, gb.depth, jpl.render_frame(jopts, g, v, p, jl, e)

    ref = [np.asarray(x) for x in jframe(
        jg, jnp.asarray(w["view"][0].numpy()), jnp.asarray(w["proj"].numpy()),
        jnp.asarray(w["eye"][0].numpy()))]
    g, opts = w["geom"], w["opts"]
    clip = tpl.clip_transform(g.corner_verts, w["view"], w["proj"])
    gb = tpl._surface_gather(opts, g, clip)[0]
    img = tpl.render_frame(opts, g, w["view"], w["proj"], w["lights"],
                           w["eye"])
    faces_only = tpl.render_frame(
        opts, g._replace(corner_verts=None, shadow_corner_verts=None),
        w["view"], w["proj"], w["lights"], w["eye"])
    return ref, [gb.tri_id[0].numpy(), gb.depth[0].numpy(), img[0].numpy()], \
        faces_only[0].numpy()


def test_full_frame_gbuffer(frames):
    ref, got, _ = frames
    same = ref[0] == got[0]
    assert same.mean() >= 0.995
    hit = same & (ref[0] >= 0)
    assert hit.mean() > 0.3
    assert np.abs(ref[1][hit] - got[1][hit]).max() <= 1e-4


def test_full_frame_image(frames):
    ref, got, _ = frames
    assert got[2].shape == (H, W, 3) and np.isfinite(got[2]).all()
    assert got[2].std() > 0.01
    assert psnr(ref[2], got[2]) >= 35.0


def test_corner_streams_change_no_pixel(frames):
    _, got, faces_only = frames
    assert np.array_equal(got[2], faces_only)
