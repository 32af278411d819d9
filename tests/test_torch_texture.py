"""The textured path's pieces of the port against the JAX package: texture
sampling (wrap and clamp, uv below 0 and above 1, layered) within 1e-6;
interpolate_attrs (with and without per-face columns, bf16 table, near-clip
sub-triangle ids) within 1e-6 on per-env faces; compute_tangents and the
material streams of build_render_tables exact; the material fBm at its
stated share (the hash amplifies one ulp of sin to ~4e-3); the layer id:
every textured pixel of the port samples its face's layer, which the JAX
package's truncation misses on about 5 % of pixels; and _surface_gather
with every texture option (normal map, emission, slope blend, fBm, one
base texture) against the JAX package's at the bars its test states."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu.render import scenerender as jsr
from clap_tpu.render import shade as Jsh
from clap_tpu.render import texture as Jtx
from clap_tpu.render.raster import GBuffer as JGBuffer
from clap_tpu.scene import testbed as jtb
from clap_tpu.scene.primitives import cube
from clap_tpu_torch.bridge import to_numpy
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.render import shade as Tsh
from clap_tpu_torch.render import texture as Ttx
from clap_tpu_torch.render.raster import GBuffer, rasterize
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import (COMPOSED_SCENE, assert_tree_equal, jnp_tree,
                               to_port)

TEX_TOL = 1e-6


def _uv(rng, n=4096):
    """uv in [-2.5, 3.5): below 0, above 1, and exact texel edges."""
    uv = rng.uniform(-2.5, 3.5, (n, 2)).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 32) / 32
    uv[64:72] = [[0, 0], [1, 1], [-1, 0.5], [0.5, -1e-9], [-0.0, 2.0],
                 [1e-9, 1 - 1e-9], [-3e-8, 1.0], [0.999999, 0.0]]
    return uv


@pytest.fixture(scope="module")
def tex():
    rng = np.random.default_rng(11)
    layers = rng.uniform(0, 1, (3, 8, 16, 3)).astype(np.float32)
    return rng, layers


@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("fn", ["sample_bilinear", "sample_nearest",
                                "sample_layered", "_quad_pack"])
def test_texture_sampling(tex, fn, wrap):
    rng, layers = tex
    uv = _uv(rng)
    if fn == "_quad_pack":
        a = Jtx._quad_pack(jnp.asarray(layers), wrap)
        b = Ttx._quad_pack(torch.as_tensor(layers), wrap)
    elif fn == "sample_layered":
        lid = rng.integers(-1, 5, uv.shape[0]).astype(np.int32)
        a = Jtx.sample_layered(jnp.asarray(layers), jnp.asarray(lid),
                               jnp.asarray(uv), wrap)
        b = Ttx.sample_layered(torch.as_tensor(layers), torch.as_tensor(lid),
                               torch.as_tensor(uv), wrap)
    else:
        a = getattr(Jtx, fn)(jnp.asarray(layers[1]), jnp.asarray(uv), wrap)
        b = getattr(Ttx, fn)(torch.as_tensor(layers[1]), torch.as_tensor(uv),
                             wrap)
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=TEX_TOL, rtol=0)


def test_upload_texture():
    u8 = np.random.default_rng(1).integers(0, 256, (4, 8, 4), dtype=np.uint8)
    assert np.array_equal(np.asarray(Jtx.upload_texture(u8)),
                          Ttx.upload_texture(u8, device="cpu").numpy())


# ---------------------------------------------------------------------------
# attribute interpolation
# ---------------------------------------------------------------------------

B, H, W, T, V, A = 2, 24, 20, 40, 30, 7


@pytest.fixture(scope="module")
def gbuf():
    rng = np.random.default_rng(12)
    tri = rng.integers(-1, 2 * T, (B, H, W)).astype(np.int32)
    b = rng.uniform(0, 1, (B, H, W, 2)).astype(np.float32)
    b[..., 1] *= 1 - b[..., 0]
    faces = rng.integers(0, V, (B, T, 3)).astype(np.int32)
    vattrs = rng.standard_normal((V, A)).astype(np.float32)
    fattrs = rng.integers(0, 50, (B, T, 2)).astype(np.float32)
    return tri, b, faces, vattrs, fattrs


@pytest.mark.parametrize("mode", ["plain", "face_attrs", "bf16",
                                  "face_attrs_bf16"])
@pytest.mark.parametrize("csrc", [False, True])
def test_interpolate_attrs(gbuf, mode, csrc):
    """Per-env faces (B, T, 3) against the JAX package run env by env."""
    tri, b, faces, vattrs, fattrs = gbuf
    if not csrc:
        tri = np.where(tri >= T, tri - T, tri)
    fa = "face_attrs" in mode
    jdt = jnp.bfloat16 if "bf16" in mode else None
    tdt = torch.bfloat16 if "bf16" in mode else None
    cs = np.arange(2 * T) % T if csrc else None
    got = Tsh.interpolate_attrs(
        GBuffer(depth=torch.zeros(B, H, W), tri_id=torch.as_tensor(tri),
                bary=torch.as_tensor(b)),
        torch.as_tensor(faces), torch.as_tensor(vattrs),
        None if cs is None else torch.as_tensor(cs),
        face_attrs=torch.as_tensor(fattrs) if fa else None, table_dtype=tdt)
    for e in range(B):
        want = Jsh.interpolate_attrs(
            JGBuffer(depth=jnp.zeros((H, W)), tri_id=jnp.asarray(tri[e]),
                     bary=jnp.asarray(b[e])),
            jnp.asarray(faces[e]), jnp.asarray(vattrs),
            None if cs is None else jnp.asarray(cs), None,
            face_attrs=jnp.asarray(fattrs[e]) if fa else None,
            table_dtype=jdt)
        for x, y in zip(want if fa else (want,), got if fa else (got,)):
            np.testing.assert_allclose(y[e].numpy(), np.asarray(x),
                                       atol=TEX_TOL, rtol=0)


def test_face_attr(gbuf):
    tri, b, _, _, fattrs = gbuf
    tri = np.where(tri >= T, tri - T, tri)
    got = Tsh.face_attr(GBuffer(torch.zeros(B, H, W), torch.as_tensor(tri),
                                torch.as_tensor(b)), torch.as_tensor(fattrs))
    for e in range(B):
        want = Jsh.face_attr(JGBuffer(jnp.zeros((H, W)), jnp.asarray(tri[e]),
                                      jnp.asarray(b[e])),
                             jnp.asarray(fattrs[e]))
        assert np.array_equal(got[e].numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# host tables: tangents, material streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["char_column", "cube"])
def test_compute_tangents_exact(mesh):
    if mesh == "cube":
        v, n, uv, f = cube(1.0)
    else:
        v, n, uv, f = jtb.char_column_mesh(0.6, 2.0)
    a = jsr.compute_tangents(v, n, uv, f)
    b = tsr.compute_tangents(v, n, uv, f)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert set(np.unique(a[:, 3])) <= {-1.0, 1.0}


def _fbm_models(pkg, models):
    """The testbed models with material fBm on the sphere (model 2)."""
    v, n, _, f = cube(1.0)
    models = list(models)
    models[2] = pkg.model_from_mesh(v * 0.8, n, f, base_color=(0.6, 0.6, 0.7),
                                    mat_fbm=(0.5, 2.0, 0.2, 0.9, 0.0, 0.6))
    return models


@pytest.mark.parametrize("variant", ["textured", "textured_skinned", "fbm"])
def test_material_tables_exact(variant):
    """testbed_models(textured=True) (and material fBm) through
    build_render_tables: every stream exact, the tables not flat-eligible,
    so kernel_attrs_ok is False in both packages."""
    J = jtb.build_testbed(**COMPOSED_SCENE)
    Tb = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    sk = variant == "textured_skinned"
    jm = jtb.testbed_models(J, skinned_chars=sk, textured=variant != "fbm")
    tm = ttb.testbed_models(Tb, skinned_chars=sk, textured=variant != "fbm")
    if variant == "fbm":
        jm, tm = _fbm_models(jsr, jm), _fbm_models(tsr, tm)
    for a, b in zip(jm, tm):
        for f, x, y in zip(a._fields, a, b):
            if f == "lod_faces":
                assert all(np.array_equal(p, q) for p, q in zip(x, y))
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            else:
                assert x == y, f
    ent = J.cfg.entities
    jrt = jsr.build_render_tables(
        jm, np.asarray(ent.model_id), np.asarray(ent.active),
        entity_edge_id=jsr.default_edge_ids(np.asarray(ent.active),
                                            np.asarray(ent.body_is_char)),
        entity_shadow_static=jsr.shadow_static_mask(ent))
    te = Tb.cfg.entities
    trt = tsr.build_render_tables(
        tm, te.model_id, te.active,
        entity_edge_id=tsr.default_edge_ids(te.active, te.body_is_char),
        entity_shadow_static=tsr.shadow_static_mask(te), device="cpu")
    assert trt.any_material and not trt.flat_eligible
    assert not jsr.kernel_attrs_ok(jrt) and not tsr.kernel_attrs_ok(trt)
    assert_tree_equal(jnp_tree(jrt), to_numpy(trt), "rt")


def test_testbed_textures_exact():
    a = jtb.testbed_textures()
    b = ttb.testbed_textures(device="cpu")
    assert_tree_equal(jnp_tree(a), to_numpy(b), "textures")


# ---------------------------------------------------------------------------
# material fBm: one ulp of sin becomes ~4e-3 after the hash's multiply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["_hash3", "value_noise3", "material_fbm"])
def test_material_noise(fn):
    """Bar: >= 99.9 % of points within 4e-3 (the hash) or >= 99 % within
    1e-2 (noise, fBm), on local positions in [-8, 8)³."""
    rng = np.random.default_rng(13)
    p = rng.uniform(-8, 8, (20000, 3)).astype(np.float32)
    amp = rng.uniform(0, 1, 20000).astype(np.float32)
    sc = rng.uniform(0.5, 2, (20000, 1)).astype(np.float32)
    if fn == "material_fbm":
        a = Jsh.material_fbm(jnp.asarray(p), jnp.asarray(amp), 4,
                             jnp.asarray(sc))
        b = Tsh.material_fbm(torch.as_tensor(p), torch.as_tensor(amp), 4,
                             torch.as_tensor(sc))
    else:
        a = getattr(Jsh, fn)(jnp.asarray(p))
        b = getattr(Tsh, fn)(torch.as_tensor(p))
    d = np.abs(np.asarray(a) - b.numpy())
    if fn == "_hash3":
        assert (d <= 4e-3).mean() >= 0.999
    else:
        assert (d <= 1e-2).mean() >= 0.99
    assert ((b.numpy() >= 0) & (b.numpy() <= 1)).all()


# ---------------------------------------------------------------------------
# the layer id
# ---------------------------------------------------------------------------

def test_reference_truncates_constant_layer_id():
    """A constant per-vertex layer 1 interpolates to 1 - 1 ulp on some
    pixels; the JAX package's truncation then samples layer 0 there (a
    fault of the reference). The port's rounding picks layer 1 on all."""
    rng = np.random.default_rng(14)
    b = rng.uniform(0, 1, (64, 64, 2)).astype(np.float32)
    b[..., 1] *= 1 - b[..., 0]
    tri = np.zeros((64, 64), np.int32)
    faces = np.array([[0, 1, 2]], np.int32)
    ids = np.ones((3, 1), np.float32)
    ja = np.asarray(Jsh.interpolate_attrs(
        JGBuffer(jnp.zeros((64, 64)), jnp.asarray(tri), jnp.asarray(b)),
        jnp.asarray(faces), jnp.asarray(ids)))[..., 0]
    ta = Tsh.interpolate_attrs(
        GBuffer(torch.zeros(1, 64, 64), torch.as_tensor(tri[None]),
                torch.as_tensor(b[None])),
        torch.as_tensor(faces), torch.as_tensor(ids))[0, ..., 0]
    assert (ja.astype(np.int32) == 0).sum() > 0       # the reference's miss
    assert bool((tpl.texture_layer(ta)[0] == 1).all())


@pytest.fixture(scope="module")
def gather_scene():
    """The textured testbed at test size (2 envs, 96², skinned and
    textured, the gather path): env 0 looks at the first tree (layer 1),
    env 1 through its own camera. Returns (renderer, geometry, clip)."""
    from clap_tpu_torch import mathx as mx
    from clap_tpu_torch.engine.frame import SceneRenderer
    from clap_tpu_torch.engine.step import engine_step, inputs_zero
    from test_torch_render import LOD_SCALE, OPTS

    Tb = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    te = Tb.cfg.entities
    tm = ttb.testbed_models(Tb, skinned_chars=True, textured=True)
    trt = tsr.build_render_tables(
        tm, te.model_id, te.active,
        entity_edge_id=tsr.default_edge_ids(te.active, te.body_is_char),
        entity_shadow_static=tsr.shadow_static_mask(te), device="cpu")
    cs = ttb.build_testbed_char_skin(Tb, tm, trt, device="cpu")
    lights = to_port(jtb_lights())
    r = SceneRenderer(trt, lights, tpl.RenderOptions(**OPTS),
                      skip_culling=te.skip_culling, lod_scale=LOD_SCALE,
                      char_skin=cs, textures=ttb.testbed_textures("cpu"))
    assert not r.opts.kernel_attrs and not r.cluster_records
    st = engine_step(Tb.cfg, ttb.replicate_state(Tb.state0, 2),
                     ttb.replicate_state(inputs_zero(2, device="cpu"), 2))
    tree = st.pos[0, 7] + torch.tensor([0.0, 1.5, 0.0])
    views = torch.stack([mx.mat4_look_at(
        tree + torch.tensor([4.0, 3.0, -4.0]), tree,
        torch.tensor([0.0, 1.0, 0.0])), r.views(st)[1]])
    geom = r.geometry(st, views, torch.eye(4).expand(2, 2, 3, 4, 4))
    # material fBm on the trees' vertices (no testbed model carries it)
    on_tree = (te.model_id[trt.vert_entity.long()] == 3)[:, None]
    fbm = torch.tensor([0.5, 2.0, 0.2, 0.9, 0.0, 0.6])
    geom = geom._replace(mat_fbm=torch.where(on_tree, fbm, geom.mat_fbm))
    return r, geom, tpl.clip_transform(geom.verts, views, r.proj)


def _layer_px(r, geom, clip, gb=None):
    """The G-buffer (the port's, or ``gb``), the compacted faces and each
    pixel's interpolated per-vertex layer id."""
    from test_torch_render import RES

    rec, binned, faces, _, csrc = tpl.gather_records(r.opts, geom, clip)
    gb = rasterize(rec, binned, RES, RES) if gb is None else gb
    lay = Tsh.interpolate_attrs(gb, faces, geom.tex_id[:, None], csrc)[..., 0]
    return gb, faces, lay


def test_textured_pixels_pick_their_face_layer(gather_scene):
    """Every pixel of a textured face samples its face's layer."""
    gb, faces, lay = _layer_px(*gather_scene)
    geom = gather_scene[1]
    gb_orig = gb._replace(tri_id=torch.where(
        gb.tri_id >= 0, torch.remainder(gb.tri_id, faces.shape[-2]), -1))
    face_layer = Tsh.face_attr(gb_orig, geom.tex_id[faces[..., 0].long()])
    textured = (gb.tri_id >= 0) & (face_layer >= 0)
    assert int((textured & (face_layer == 1)).sum()) > 0   # trees in view
    picked, has_tex = tpl.texture_layer(lay)
    assert bool(has_tex[textured].all())
    assert bool((picked == face_layer.to(torch.int32))[textured].all())


def _jax_geometry(geom, env):
    """One env of the port's member-granularity geometry as the JAX
    package's SceneGeometry."""
    from clap_tpu.render.pipeline import SceneGeometry as JSceneGeometry

    per_env = {"verts", "face_valid", "ent_rot", "shadow_face_valid"}
    return JSceneGeometry(**{
        f: jnp.asarray(v[env].numpy() if f in per_env else v.numpy())
        for f, v in zip(geom._fields, geom) if v is not None})


@pytest.mark.parametrize("mode", ["textures", "base_texture"])
def test_surface_gather_options(gather_scene, mode):
    """_surface_gather with every texture option on (diffuse, normal map
    through the tangents, emission, the slope-blended atlas on layer 1,
    material fBm on the trees), or one base texture, against the JAX
    package's _surface_gather env by env (its jitted rasterize run as the
    plain function). Bars, on pixels whose ids agree and where the JAX
    package's truncated layer id (interpolated on its own barycentrics)
    equals the port's rounded one (ROADMAP §3): normal, base colour and
    emission within 1e-3 on all of them (the two G-buffers' barycentrics
    differ by an ulp, and the normal map renormalises the tangent's part
    off the normal, which can be short); roughness and metallic within
    1e-2 on >= 99 % (the fBm hash)."""
    from clap_tpu.render import pipeline as jpl
    from test_torch_render import OPTS

    r, geom, clip = gather_scene
    rng = np.random.default_rng(15)
    if mode == "textures":
        nm = np.array([0.5, 0.5, 1.0]) + rng.uniform(-0.3, 0.3, (2, 16, 16, 3))
        parts = dict(
            diffuse=rng.uniform(0.2, 1.0, (2, 16, 16, 3)),
            normal=np.clip(nm, 0.0, 1.0),
            emission=rng.uniform(0.0, 0.2, (2, 16, 16, 3)),
            slope_blend=np.array([False, True]))
        ttex = tpl.TextureSets(**{k: torch.as_tensor(
            v if v.dtype == bool else v.astype(np.float32))
            for k, v in parts.items()})
        jtex = jpl.TextureSets(**{k: jnp.asarray(v.numpy())
                                  for k, v in zip(ttex._fields, ttex)})
        targs, jargs = (None, ttex), (None, jtex)
    else:
        btex = rng.uniform(0.2, 1.0, (16, 16, 4)).astype(np.float32)
        targs, jargs = (torch.as_tensor(btex), None), (jnp.asarray(btex), None)
    got = tpl._surface_gather(r.opts, geom, clip, *targs)
    _, _, lay = _layer_px(r, geom, clip, got[0])
    jopts = jpl.RenderOptions(**{**OPTS, "kernel_attrs": False})
    fbm_px = 0
    for env in range(2):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpl, "rasterize", jpl.rasterize.__wrapped__)
            want = jpl._surface_gather(jopts, _jax_geometry(geom, env),
                                       jnp.asarray(clip[env].numpy()),
                                       *jargs)
        jtid, ttid = np.asarray(want[0].tri_id), got[0].tri_id[env].numpy()
        assert (jtid == ttid).mean() >= 0.995
        jgb = GBuffer(*(torch.as_tensor(np.array(x))[None]
                        for x in want[0]))
        _, _, jlay = _layer_px(r, geom._replace(
            verts=geom.verts[env:env + 1],
            face_valid=geom.face_valid[env:env + 1]), clip[env:env + 1], jgb)
        la = lay[env]
        layer_ok = (jlay[0].to(torch.int32) == tpl.texture_layer(la)[0]) \
            | (la < -0.5)
        m = (jtid == ttid) & (ttid >= 0) & layer_ok.numpy()
        assert m.mean() > 0.05
        for k in (1, 2, 5):          # normal, base colour, emission
            d = np.abs(np.asarray(want[k]) - got[k][env].numpy())[m]
            assert d.max() <= 1e-3, (k, d.max())
        for k in (3, 4):             # roughness, metallic
            d = np.abs(np.asarray(want[k]) - got[k][env].numpy())[m]
            assert (d <= 1e-2).mean() >= 0.99, k
        fbm_px += int((np.asarray(want[3])[m] != 0.5).sum())
    assert fbm_px > 0


def jtb_lights():
    """The JAX package's one directional light of bench.py:589-595."""
    from clap_tpu.render.lights import lights_empty

    d = jnp.array([-0.4, -0.8, -0.4])
    le = lights_empty(1)
    return le._replace(direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
                       color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
                       is_dir=le.is_dir.at[0].set(True),
                       active=le.active.at[0].set(True))
