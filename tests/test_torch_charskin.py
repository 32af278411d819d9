"""Skinned characters of the port against the JAX package (the composed
testbed cut to test size, 2 envs, 96²): the ring-column mesh, the skinned
models, render tables and CharSkin tables exact; the LBS record ranges
(skin_records, apply_shadow_skin, skin_vertex_rows) within 1e-5 on random
joint matrices (tests/test_charskin.py's recipe); the skinned cluster-record
assembly (comp within 1e-4, validity and entity ids exact); and 2 frames
of the skinned flagship (bench.py:565-588, 654-673) through game_step:
state within 1e-4, LDR PSNR >= 35 dB per env and frame."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.anim import system as Jsys
from clap_tpu.engine import game as Jg
from clap_tpu.engine import gamelogic as Jgl
from clap_tpu.render import charskin as Jcs
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.render.lights import lights_empty
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.bridge import to_numpy
from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
from clap_tpu_torch.render import charskin as Tcs
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.scene import testbed as ttb
from test_charskin import _rand_joint_mats
from test_torch_common import (COMPOSED_SCENE, assert_tree_close,
                               assert_tree_equal, jnp_tree, psnr, to_port)
from test_torch_render import LOD_SCALE, OPTS, RES, jax_views

B = 2
LBS_TOL = dict(atol=1e-5, rtol=1e-5)


def skinned_scene(textured=False):
    """Both packages' composed testbed with skinned characters (and, with
    ``textured``, textured character and tree models): (J, T, jmodels,
    tmodels, jrt, trt, jcs, tcs, jl, tl), as bench.py:544-594 builds it."""
    J = jtb.build_testbed(**COMPOSED_SCENE)
    T = ttb.build_testbed(**COMPOSED_SCENE, device="cpu")
    jm = jtb.testbed_models(J, skinned_chars=True, textured=textured)
    tm = ttb.testbed_models(T, skinned_chars=True, textured=textured)
    ent = J.cfg.entities
    jrt = jsr.build_render_tables(
        jm, np.asarray(ent.model_id), np.asarray(ent.active),
        entity_edge_id=jsr.default_edge_ids(np.asarray(ent.active),
                                            np.asarray(ent.body_is_char)),
        entity_shadow_static=jsr.shadow_static_mask(ent))
    te = T.cfg.entities
    trt = tsr.build_render_tables(
        tm, te.model_id, te.active,
        entity_edge_id=tsr.default_edge_ids(te.active, te.body_is_char),
        entity_shadow_static=tsr.shadow_static_mask(te), device="cpu")
    jcs = jtb.build_testbed_char_skin(J, jm, jrt)
    tcs = ttb.build_testbed_char_skin(T, tm, trt, device="cpu")
    d = jnp.array([-0.4, -0.8, -0.4])
    le = lights_empty(1)
    jl = le._replace(direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
                     color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
                     is_dir=le.is_dir.at[0].set(True),
                     active=le.active.at[0].set(True))
    return J, T, jm, tm, jrt, trt, jcs, tcs, jl, to_port(jl)


def game_session(J, T):
    """The game wiring of bench.py:546-559 for both packages at B envs:
    (jgw, tgw, jss, tss)."""
    from test_torch_game import port_session

    n_ents = J.cfg.entities.active.shape[0]
    jgcfg = Jgl.game_config_empty(1, n_ents)._replace(
        switch_entity=jnp.array([0], jnp.int32),
        switch_valid=jnp.array([True]), switch_permanent=jnp.array([True]))
    sk, lib, acfg = jtb.build_demo_rig()
    jgw = Jg.GameWorld(scene=J.cfg, game=jgcfg, anim=acfg, anim_sk=sk,
                       anim_lib=lib)
    jgs1 = Jg.GameSessionState(
        engine=J.state0, game=Jgl.game_state_init(1, 2),
        anim=Jsys.anim_instances_init(2),
        joint_mats=jnp.tile(jnp.eye(4, dtype=jnp.float32), (2, 3, 1, 1)))
    tgw = to_port(jgw)._replace(scene=T.cfg)
    jss = jax.tree.map(lambda x: jnp.broadcast_to(x, (B, *x.shape)), jgs1)
    return jgw, tgw, jss, port_session(jgs1, B)


@pytest.fixture(scope="module")
def scene():
    return skinned_scene()


# ---------------------------------------------------------------------------
# host tables
# ---------------------------------------------------------------------------

def test_char_column_mesh_exact():
    for a, b in zip(jtb.char_column_mesh(0.6, 2.0),
                    ttb.char_column_mesh(0.6, 2.0)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_skinned_models_and_tables_exact(scene):
    _, _, jm, tm, jrt, trt, _, _, _, _ = scene
    for a, b in zip(jm, tm):
        for f, x, y in zip(a._fields, a, b):
            if f == "lod_faces":
                assert all(np.array_equal(p, q) for p, q in zip(x, y))
            elif isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            else:
                assert x == y, f
    assert jsr.kernel_attrs_ok(jrt) and tsr.kernel_attrs_ok(trt)
    assert_tree_equal(jnp_tree(jrt), to_numpy(trt), "rt")


def test_linear_joint_weights_exact(scene):
    _, _, jm, _, _, _, _, _, _, _ = scene
    jy = np.array([0.0, 0.8, 1.6])
    for a, b in zip(Jcs.linear_joint_weights(jm[1].verts, jy),
                    Tcs.linear_joint_weights(jm[1].verts, jy)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("field", [f for f in Tcs.CharSkin._fields
                                   if f != "cl_skinned"])
def test_build_char_skin_exact(scene, field):
    _, _, _, _, _, _, jcs, tcs, _, _ = scene
    a, b = getattr(jcs, field), getattr(tcs, field)
    if isinstance(b, torch.Tensor):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    else:
        assert a == b


def test_char_skin_cluster_mask(scene):
    """The static mask of the chars' rigid clusters is the reference's
    per-call np.isin, built once with the CharSkin."""
    _, _, _, _, jrt, _, jcs, tcs, _, _ = scene
    want = np.isin(np.asarray(jrt.cl_entity), np.asarray(jcs.char_ents))
    assert want.any() and np.array_equal(tcs.cl_skinned.numpy(), want)


# ---------------------------------------------------------------------------
# the LBS record ranges
# ---------------------------------------------------------------------------

def _frame_inputs(E, cs_ents):
    """Random joint matrices (tests/test_charskin.py), distinct char world
    transforms, two look-at views."""
    rng = np.random.default_rng(3)
    jm = _rand_joint_mats(rng, B, 2, 3)
    emx = np.tile(np.eye(4, dtype=np.float32), (B, E, 1, 1))
    for b in range(B):
        for k, e in enumerate(cs_ents):
            a = 0.3 * (b + 1) + k
            ca, sa = np.cos(a), np.sin(a)
            emx[b, e, :3, :3] = np.array(
                [[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
            emx[b, e, :3, 3] = (k, 0.5, b)
    views = np.stack([np.asarray(jmx.mat4_look_at(
        jnp.asarray(e), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
        for e in ([6.0, 5.0, 6.0], [5.0, 4.0, -6.0])])
    proj = np.asarray(jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 100.0))
    vis = np.ones((B, E), bool)
    vis[1, cs_ents[1]] = False                      # one char hidden
    return jm, emx, views, proj, vis


@pytest.fixture(scope="module")
def lbs(scene):
    J, _, _, _, jrt, trt, jcs, tcs, _, _ = scene
    E = J.cfg.entities.active.shape[0]
    args = _frame_inputs(E, np.asarray(jcs.char_ents))
    jout = jax.jit(lambda *a: Jcs.skin_records(jcs, *a))(
        *(jnp.asarray(a) for a in args))
    tout = Tcs.skin_records(tcs, *(torch.as_tensor(a) for a in args))
    jm, emx = args[0], args[1]
    n_sh = 3 * jrt.shadow_faces.shape[0]
    swc = np.random.default_rng(4).standard_normal(
        (B, n_sh, 3)).astype(np.float32)
    jsh = Jcs.apply_shadow_skin(jnp.asarray(swc), jcs, jout[3])
    tsh = Tcs.apply_shadow_skin(torch.as_tensor(swc), tcs, tout[3])
    jv = [Jcs.skin_vertex_rows(jcs, jnp.asarray(jm), jnp.asarray(emx)),
          Jcs.skin_vertex_rows(jcs, jnp.asarray(jm[0]), jnp.asarray(emx[0]))]
    tv = [Tcs.skin_vertex_rows(tcs, torch.as_tensor(jm), torch.as_tensor(emx)),
          Tcs.skin_vertex_rows(tcs, torch.as_tensor(jm[0]),
                               torch.as_tensor(emx[0]))]
    return dict(jout=jout, tout=tout, jsh=jsh, tsh=tsh, swc=swc, jv=jv, tv=tv)


@pytest.mark.parametrize("part", range(4), ids=["comp", "valid", "ent",
                                                "sh_world"])
def test_skin_records(lbs, part):
    assert_tree_close(np.asarray(lbs["jout"][part]), lbs["tout"][part],
                      path=f"skin_records[{part}]", **LBS_TOL)


def test_skin_records_hidden_char_invalid(lbs, scene):
    tcs = scene[7]
    Tp = tcs.n_main
    valid = lbs["tout"][1]
    assert not valid[1, Tp:].any() and valid[0, Tp:].any()


def test_apply_shadow_skin(lbs, scene):
    tcs = scene[7]
    assert_tree_close(np.asarray(lbs["jsh"]), lbs["tsh"], **LBS_TOL)
    # a copy: the caller's stream is untouched, rows outside chars kept
    got = lbs["tsh"].numpy()
    keep = np.ones(got.shape[1], bool)
    for f0 in tcs.sh_face_row0:
        keep[3 * f0:3 * (f0 + tcs.n_shadow)] = False
    assert keep.any() and np.array_equal(got[:, keep], lbs["swc"][:, keep])


@pytest.mark.parametrize("batched", [True, False])
def test_skin_vertex_rows(lbs, batched):
    i = 0 if batched else 1
    for a, b in zip(lbs["jv"][i], lbs["tv"][i]):
        assert_tree_close(np.asarray(a), b, **LBS_TOL)


# ---------------------------------------------------------------------------
# the skinned cluster-record assembly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assembled(scene):
    J, _, _, _, jrt, trt, jcs, tcs, _, _ = scene
    E = J.cfg.entities.active.shape[0]
    jm, _, _, proj, _ = _frame_inputs(E, np.asarray(jcs.char_ents))
    st = jtb.replicate_state(J.state0, B)
    st = st._replace(camera=st.camera._replace(
        yaw=st.camera.yaw.at[1].add(0.4)))
    views, planes = jax_views(st.camera, jnp.asarray(proj))
    skip = J.cfg.entities.skip_culling
    jg, _ = jax.jit(lambda m, v, pl, pos, vw, j: jsr.assemble_cluster_records_batch(
        jrt, m, v, pl, pos, vw, jnp.asarray(proj), cap=1024,
        skip_culling=skip, char_skin=jcs, joint_mats=j,
        lod_scale=LOD_SCALE))(st.mx, st.visible, planes, st.camera.pos,
                              views, jnp.asarray(jm))
    t = [torch.as_tensor(np.asarray(x)) for x in
         (st.mx, st.visible, planes, st.camera.pos, views)]
    tg = tsr.assemble_cluster_records_batch(
        trt, *t, torch.as_tensor(proj), cap=1024,
        skip_culling=torch.as_tensor(np.asarray(skip)), char_skin=tcs,
        joint_mats=torch.as_tensor(jm), lod_scale=LOD_SCALE)
    return jg, tg


@pytest.mark.parametrize("field", ["comp", "comp_valid", "comp_ent",
                                   "shadow_corner_verts",
                                   "shadow_face_valid"])
def test_assemble_cluster_records_skinned(assembled, field):
    jg, tg = assembled
    assert_tree_close(np.asarray(getattr(jg, field)), getattr(tg, field),
                      path=field)


def test_skinned_range_within_kernel_attrs_limit(assembled, scene):
    """The C·Tp skinned records count in surface_records' 2·T·stride check
    (T is the stream's length, skinned range included)."""
    _, tg = assembled
    tcs = scene[7]
    rigid_t = tg.comp.shape[-1] - 2 * tcs.n_main
    assert rigid_t % 8 == 0 and bool(tg.comp_valid[:, rigid_t:].any())
    rec, _, stride = tpl.surface_records(tpl.RenderOptions(**OPTS), tg)
    assert rec.shape[-1] == 2 * tg.comp.shape[-1]
    assert 2 * tg.comp.shape[-1] * stride < 1 << 24


# ---------------------------------------------------------------------------
# the skinned flagship through game_step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship(scene):
    from test_torch_game import seeded_inputs

    J, T, _, _, jrt, trt, jcs, tcs, jl, tl = scene
    jgw, tgw, jss, tss = game_session(J, T)
    jopts = jpl.RenderOptions(**OPTS)
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)
    skip = J.cfg.entities.skip_culling
    jstatic = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                     shadow_size=128, far=200.0)

    @jax.jit
    def jax_step_and_render(gss, ins):           # bench.py:654-684
        gss = jax.vmap(lambda s, i: Jg.game_step(jgw, s, i))(gss, ins)
        sts = gss.engine
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_cluster_records_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos, views, proj,
            cap=jopts.record_compact, skip_culling=skip, char_skin=jcs,
            joint_mats=gss.joint_mats, lod_scale=LOD_SCALE)
        return gss, jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jstatic)

    tstatic = tsr.bake_static_shadow(trt, T.state0.mx, tl.direction[0],
                                     shadow_size=128, far=200.0)
    renderer = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                             skip_culling=T.cfg.entities.skip_culling,
                             static_shadow=tstatic, lod_scale=LOD_SCALE,
                             char_skin=tcs)
    assert renderer.cluster_records
    rng = np.random.default_rng(5)
    out = []
    for _ in range(2):
        jins, tins = seeded_inputs(rng, 2)
        jss, jimg = jax_step_and_render(jss, jins)
        tss, timg = step_and_render(tgw, renderer, tss, tins)
        out.append((jnp_tree(jss), np.asarray(jimg), tss, timg.numpy()))
    rest = renderer(tss.engine, torch.eye(4).expand_as(tss.joint_mats))
    return out, rest.numpy()


@pytest.mark.parametrize("frame", range(2))
def test_skinned_flagship_state(flagship, frame):
    jss, _, tss, _ = flagship[0][frame]
    for part in ("engine", "game", "anim", "joint_mats"):
        assert_tree_close(getattr(jss, part), getattr(tss, part),
                          path=f"frame{frame}.{part}")


@pytest.mark.parametrize("env", range(B))
@pytest.mark.parametrize("frame", range(2))
def test_skinned_flagship_images(flagship, frame, env):
    _, jimg, _, timg = flagship[0][frame]
    assert timg.shape == (B, RES, RES, 3) and np.isfinite(timg).all()
    assert float(timg[env].std()) > 0.01
    assert psnr(jimg[env], timg[env]) >= 35.0


def test_pose_moves_character_pixels(flagship):
    """The same state rendered at the rest pose (identity joint matrices)
    and at the step's pose differs on the characters' pixels."""
    frames, rest = flagship
    posed = frames[-1][3]
    moved = (np.abs(posed - rest).max(-1) > 0.02).sum(axis=(1, 2))
    assert (moved > 0).all(), moved
