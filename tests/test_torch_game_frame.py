"""The game's own rendered frame, the port against the JAX package:

- ``billboard_matrix`` and ``particle_clip_quads`` within 1e-6 (2 envs,
  particles in front of, behind and across the near plane of the camera);
- ``particle_pass`` (the billboards' corner records, K1's plain version,
  the depth test and the blend) within 1e-6 at 96 × 64, record validity
  exact: quads with a corner behind the camera are dropped as the
  reference drops them; the demo's stream (2 × 1,024 particles at
  640 × 360) passes the kernel wrappers' capacity checks;
- single-env ``assemble_scene_geometry`` with skinned characters on the
  demo testbed (demo/testbed.py:62-200; terrain cut to 32² verts): face
  validity and LOD exact, positions, normals and tangents within 1e-5.

2 frames of the demo through ``game_frame_step`` against the JAX
package's ``Engine.frame`` are in tests/test_torch_game_frame_demo.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.ops import particles as Jp
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.render.camera import camera_view_proj
from clap_tpu.render.view import make_subview
from clap_tpu_torch.ops import particles as Tp
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import raster as tra
from clap_tpu_torch.render import scenerender as tsr
import test_torch_common  # noqa: F401  (one torch thread per worker)

B = 2
W, H = 256, 128
SCENE = dict(seed=42, side=64.0, nr_v=32, n_dynamic=8, max_entities=64)


def t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# billboards
# ---------------------------------------------------------------------------

def _cameras():
    """Two envs' views (eyes at different places looking at the origin)
    and a 96 × 64 projection."""
    eyes = np.array([[0.0, 4.0, 10.0], [6.0, 3.0, 6.0]], np.float32)
    views = np.stack([np.asarray(jmx.mat4_look_at(
        jnp.asarray(e), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])))
        for e in eyes])
    proj = np.asarray(jmx.mat4_perspective(jnp.pi / 3, 1.5, 0.1, 100.0))
    return eyes, views, proj


def _particles(eyes, n=400):
    """Per env: a cloud around the origin, then 6 particles behind the
    camera, 6 between the eye and the near plane (0.1) and 6 on the near
    plane. A billboard faces the camera, so its corners share one view
    depth: a quad lies wholly on one side of the near plane."""
    rng = np.random.default_rng(21)
    out = []
    for e in eyes:
        fwd = -e / np.linalg.norm(e)
        out.append(np.concatenate([
            rng.uniform(-3, 3, (n, 3)),
            e - fwd * rng.uniform(0.5, 3.0, (6, 1)) + rng.uniform(
                -0.3, 0.3, (6, 3)),
            e + fwd * rng.uniform(0.01, 0.08, (6, 1)),
            e + fwd * rng.uniform(0.09, 0.11, (6, 1))]))
    pos = np.stack(out).astype(np.float32)
    active = np.random.default_rng(22).uniform(size=pos.shape[:2]) > 0.1
    size = np.random.default_rng(23).uniform(0.05, 0.3, pos.shape[:2]) \
        .astype(np.float32)
    return pos, active, size


def test_billboard_matrix():
    _, views, _ = _cameras()
    got = Tp.billboard_matrix(t(views)).numpy()
    for e in range(B):
        np.testing.assert_allclose(
            got[e], np.asarray(Jp.billboard_matrix(jnp.asarray(views[e]))),
            atol=1e-6, rtol=0)


def test_particle_clip_quads():
    eyes, views, proj = _cameras()
    pos, active, size = _particles(eyes)
    got = Tp.particle_clip_quads(t(pos), t(size), t(views), t(proj),
                                 t(active))
    for e in range(B):
        ref = Jp.particle_clip_quads(jnp.asarray(pos[e]),
                                     jnp.asarray(size[e]),
                                     jnp.asarray(views[e]),
                                     jnp.asarray(proj), jnp.asarray(active[e]))
        np.testing.assert_allclose(got[0][e].numpy(), np.asarray(ref[0]),
                                   atol=1e-6, rtol=1e-6)
        assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
        assert np.array_equal(got[2][e].numpy(), np.asarray(ref[2]))
        assert np.array_equal(got[3].numpy(), np.asarray(ref[3]))


@pytest.fixture(scope="module")
def particle_case():
    eyes, views, proj = _cameras()
    pos, active, size = _particles(eyes)
    rng = np.random.default_rng(24)
    hdr = rng.uniform(0, 2, (B, 64, 96, 3)).astype(np.float32)
    depth = rng.uniform(0.95, 1.0, (B, 64, 96)).astype(np.float32)
    depth[:, :, :20] = np.inf                      # background strip
    return eyes, views, proj, pos, active, size, hdr, depth


def test_particle_records_near_plane(particle_case):
    """Record validity exact against the JAX package's corner records; the
    quads behind the camera and across its near plane are dropped."""
    eyes, views, proj, pos, active, size, _, _ = particle_case
    opts = tpl.RenderOptions(width=96, height=64)
    rec, _ = tpl.particle_records(opts, t(pos), t(size), t(active),
                                  t(views), t(proj))
    ok = rec.any(1).numpy()
    from clap_tpu.render.raster import corner_records, project_to_screen

    for e in range(B):
        verts, _, valid, _ = Jp.particle_clip_quads(
            jnp.asarray(pos[e]), jnp.asarray(size[e]), jnp.asarray(views[e]),
            jnp.asarray(proj), jnp.asarray(active[e]))
        vr = jnp.stack(project_to_screen(verts, 96, 64), -1).reshape(-1, 3, 4)
        jrec, jok = corner_records(vr[:, 0], vr[:, 1], vr[:, 2], valid)
        assert np.array_equal(ok[e], np.asarray(jok))
        np.testing.assert_allclose(rec[e].numpy(), np.asarray(jrec),
                                   atol=1e-5, rtol=1e-5)
        n = pos.shape[1] - 18
        assert not ok[e, 2 * n:2 * (n + 12)].any()  # behind / before near
        assert ok[e, :2 * n].mean() > 0.5


def test_particle_pass(particle_case):
    eyes, views, proj, pos, active, size, hdr, depth = particle_case
    opts = tpl.RenderOptions(width=96, height=64)
    got = tpl.particle_pass(opts, t(hdr), t(depth), t(pos), t(size),
                            t(active), t(views), t(proj),
                            color=(0.95, 0.9, 0.5), alpha=0.6).numpy()
    jopts = jpl.RenderOptions(width=96, height=64)
    for e in range(B):
        ref = np.asarray(jpl.particle_pass(
            jopts, jnp.asarray(hdr[e]), jnp.asarray(depth[e]),
            jnp.asarray(pos[e]), jnp.asarray(size[e]),
            jnp.asarray(active[e]), jnp.asarray(views[e]),
            jnp.asarray(proj), color=(0.95, 0.9, 0.5), alpha=0.6))
        np.testing.assert_allclose(got[e], ref, atol=1e-6, rtol=0)
        assert (np.abs(got[e] - hdr[e]).max(-1) > 1e-3).mean() > 0.05


def test_demo_particle_stream_fits_the_kernels():
    """The demo's 2 × 1,024 particles at 640 × 360: K1's launch arguments
    pass every check of the kernel wrapper but the last (CPU tensors are
    not launched)."""
    eyes, views, proj = _cameras()
    rng = np.random.default_rng(25)
    pos = t(rng.uniform(-3, 3, (1, 2 * Tp.PARTICLES_MAX, 3)))
    opts = tpl.RenderOptions(width=640, height=360)
    rec, binned = tpl.particle_records(opts, pos.float(), 0.1,
                                       torch.ones(1, pos.shape[1],
                                                  dtype=torch.bool),
                                       t(views[:1]), t(proj))
    args = tra.kernel_inputs(rec, binned, 640, 360)
    with pytest.raises(ValueError, match="must all be CUDA tensors"):
        tra._kernel_args(*args, tra.NCOEF)


# ---------------------------------------------------------------------------
# the demo testbed: both packages
# ---------------------------------------------------------------------------

def parity_textures():
    """The demo's three texture layers (checker, bark, the terrain's 2×2
    grass/rock atlas blended by slope) with layer 1 made a copy of layer
    2. The JAX package truncates an interpolated layer id that lands one
    ulp under k to layer k − 1 (ROADMAP §3); on the terrain (id 2) that
    happens on scattered pixels that differ between two float
    implementations. With layers 1 and 2 alike both packages sample the
    same texel there. Returns (diffuse (3, 32, 32, 3), slope_blend (3,))."""
    checker = np.zeros((32, 32, 3), np.float32) + 0.55
    checker[::2, ::2] = (0.95, 0.55, 0.35)
    checker[1::2, 1::2] = (0.95, 0.55, 0.35)
    rng = np.random.default_rng(7)
    atlas = np.zeros((32, 32, 3), np.float32)
    gnoise = rng.uniform(0.85, 1.15, (16, 16, 1)).astype(np.float32)
    atlas[:16, :16] = np.array([0.30, 0.52, 0.22]) * gnoise
    rnoise = rng.uniform(0.8, 1.2, (16, 16, 1)).astype(np.float32)
    atlas[16:, 16:] = np.array([0.45, 0.43, 0.40]) * rnoise
    atlas[:16, 16:] = atlas[:16, :16]
    atlas[16:, :16] = atlas[16:, 16:]
    return np.stack([checker, atlas, atlas]), np.array([False, True, True])


def jax_demo_scene():
    """demo/testbed.py:62-200's scene in the JAX package (``--render``),
    the terrain cut to SCENE and the textures ``parity_textures``: a dict
    of tb, gw, s0 (the session), rt, cs, textures, lights."""
    import demo.testbed as demo
    from clap_tpu.anim.system import anim_instances_init
    from clap_tpu.engine.game import GameSessionState, GameWorld
    from clap_tpu.engine.gamelogic import game_config_empty, game_state_init
    from clap_tpu.render.lights import lights_empty
    from clap_tpu.scene.testbed import (build_demo_rig, build_testbed,
                                        build_testbed_char_skin,
                                        char_column_mesh)

    tb = build_testbed(**SCENE, n_chars=2)
    sk, lib, acfg = build_demo_rig()
    gcfg = game_config_empty(1, 64)._replace(
        switch_entity=jnp.array([0], jnp.int32),
        switch_valid=jnp.array([True]), switch_permanent=jnp.array([True]))
    pparams = Jp.ParticleParams(
        active=jnp.array([True, True]), radius=jnp.array([1.6, 1.6]),
        min_radius=jnp.array([0.4, 0.4]),
        velocity=jnp.array([0.015, 0.015]), dist=jnp.array([1, 1], jnp.int32),
        count=jnp.array([Jp.PARTICLES_MAX // 4] * 2, jnp.int32))
    pentity = jnp.array([1, 2], jnp.int32)
    gw = GameWorld(scene=tb.cfg, game=gcfg, anim=acfg, anim_sk=sk,
                   anim_lib=lib, particles=pparams, particle_entity=pentity)
    s0 = GameSessionState(
        engine=tb.state0, game=game_state_init(1, 2),
        anim=anim_instances_init(2),
        particles=Jp.particles_init(pparams, tb.state0.pos[pentity],
                                    jax.random.PRNGKey(3)),
        joint_mats=jnp.tile(jnp.eye(4), (2, 3, 1, 1)))

    ter = tb.terrain
    diffuse, slope = parity_textures()
    textures = jpl.TextureSets(diffuse=jnp.asarray(diffuse),
                               slope_blend=jnp.asarray(slope))
    chv, chn, chuv, chf = char_column_mesh(0.6, 2.0)
    models = [
        jsr.model_from_mesh(ter.vx, ter.norm, ter.idx.reshape(-1, 3),
                            base_color=(1.0, 1.0, 1.0), with_lods=False,
                            uv=ter.uv, tex_id=2),
        jsr.model_from_mesh(chv, chn, chf, base_color=(0.8, 0.5, 0.4),
                            uv=chuv, tex_id=0),
        jsr.model_from_mesh(*demo._cube_model(0.8, 0.8),
                            base_color=(0.6, 0.6, 0.7)),
        jsr.model_from_mesh(*demo._cube_model(0.8, 3.0),
                            base_color=(0.4, 0.3, 0.2), uv=demo._cube_uv(),
                            tex_id=1),
    ]
    ent = tb.cfg.entities
    rt = jsr.build_render_tables(
        models, np.asarray(ent.model_id), np.asarray(ent.active),
        entity_edge_id=jsr.default_edge_ids(np.asarray(ent.active),
                                            np.asarray(ent.body_is_char)),
        entity_shadow_static=jsr.shadow_static_mask(ent))
    le = lights_empty(1)
    d = jnp.array([-0.4, -0.8, -0.4])
    lights = le._replace(
        direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
        color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
        is_dir=le.is_dir.at[0].set(True),
        active=le.active.at[0].set(True))
    cs = build_testbed_char_skin(tb, models, rt)
    return dict(tb=tb, gw=gw, s0=s0, rt=rt, cs=cs, textures=textures,
                lights=lights)


def jax_demo_engine(width, height):
    """The JAX package's Engine over ``jax_demo_scene`` with graphics
    attached as demo/testbed.py:148-200 attaches them (256² cascades,
    film grain on blue_noise2d(64), particle size 0.1 and colour (0.95,
    0.9, 0.5), skinned characters): (engine, scene dict)."""
    from clap_tpu.engine.core import ClapConfig, Engine
    from clap_tpu.ops.noise import blue_noise2d

    j = jax_demo_scene()
    tb, gw = j["tb"], j["gw"]
    eng = Engine(ClapConfig(title="testbed", settings=False, width=width,
                            height=height), tb.cfg, tb.state0,
                 game_world=gw, session0=j["s0"])
    opts = jpl.RenderOptions(width=width, height=height, shadow_size=256)
    eng.attach_graphics(j["rt"], j["lights"], opts,
                        skip_culling=tb.cfg.entities.skip_culling,
                        textures=j["textures"], grain_noise=blue_noise2d(64),
                        particle_world=gw.particles, particle_size=0.1,
                        particle_color=(0.95, 0.9, 0.5), char_skin=j["cs"])
    return eng, j


def port_demo(width, height):
    """chip_smoke.build_game_frame over SCENE on the CPU, the textures
    ``parity_textures``."""
    from chip_smoke import build_game_frame

    w = build_game_frame("cpu", width, height, scene=SCENE)
    diffuse, slope = parity_textures()
    w["renderer"].tex_diffuse = torch.as_tensor(diffuse)
    w["renderer"].tex_slope_blend = torch.as_tensor(slope)
    return w


@pytest.fixture(scope="module")
def demo_scene():
    return jax_demo_scene(), port_demo(W, H)


def test_demo_tables_exact(demo_scene):
    j, w = demo_scene
    jrt, jcs = j["rt"], j["cs"]
    for f in ("faces", "face_entity", "face_lod", "shadow_faces",
              "static_shadow_faces", "vert_entity", "tex_id"):
        assert np.array_equal(getattr(w["rt"], f).numpy(),
                              np.asarray(getattr(jrt, f))), f
    np.testing.assert_allclose(w["rt"].verts.numpy(), np.asarray(jrt.verts),
                               atol=1e-6)
    assert list(w["cs"].vert_row0) == list(jcs.vert_row0)


@pytest.fixture(scope="module")
def assembled(demo_scene):
    """Single-env geometry of the demo's first state, skinned with random
    joint matrices, from a camera looking over the characters."""
    from test_charskin import _rand_joint_mats

    j, w = demo_scene
    jrt, jcs = j["rt"], j["cs"]
    st = j["tb"].state0
    jm = _rand_joint_mats(np.random.default_rng(2), 1, 2, 3)[0]
    q = jmx.qmul(
        jmx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), st.camera.yaw),
        jmx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]),
                                 st.camera.pitch))
    view, proj = camera_view_proj(st.camera.pos, q, jnp.pi / 3, W / H)
    planes = make_subview(view, proj).planes
    skip = j["tb"].cfg.entities.skip_culling
    ref = jsr.assemble_scene_geometry(
        jrt, st.mx, st.visible, planes, st.camera.pos, skip_culling=skip,
        char_skin=jcs, joint_mats=jnp.asarray(jm))
    got = tsr.assemble_scene_geometry(
        w["rt"], t(st.mx), t(st.visible), t(planes), t(st.camera.pos),
        skip_culling=t(skip), char_skin=w["cs"], joint_mats=t(jm))
    return ref, got


def test_assemble_scene_geometry_validity(assembled):
    ref, got = assembled
    for f in ("face_valid", "shadow_face_valid"):
        assert np.array_equal(getattr(got, f).numpy()[0],
                              np.asarray(getattr(ref, f))), f
    fv = got.face_valid.numpy()[0]
    assert 0.05 < fv.mean() < 0.95          # culled and LOD-selected


@pytest.mark.parametrize("field", ["verts", "normals", "tangent"])
def test_assemble_scene_geometry_attrs(assembled, field):
    ref, got = assembled
    g = getattr(got, field).numpy()
    g = g[0] if field == "verts" else g
    np.testing.assert_allclose(g, np.asarray(getattr(ref, field)),
                               atol=1e-5, rtol=1e-5)


def test_assemble_scene_geometry_tables(assembled):
    ref, got = assembled
    for f in ("uv", "tex_id", "local_pos", "mat_fbm", "edge_id", "faces",
              "base_color"):
        a, b = getattr(ref, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(b.numpy(), np.asarray(a)), f
