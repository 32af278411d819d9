"""The JAX bench's ``full_frame_production`` configuration (bench.py:281-420)
of the port against the JAX package at 1 env, 128×96, with a 256² static
bake (clap_tpu_torch.bench.build_production cut to size: 24² terrain verts, 8
cubes): the render tables, the bake, the cluster records and the frame
(kernel_attrs, raster_cap 4096, the static/dynamic shadow split). Bars:
tables exact, bake moments within 1e-4 on >= 99.5 % of texels, cluster
record validity and entities exact, LDR PSNR >= 35 dB."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.render.lights import lights_empty
from clap_tpu.render.view import make_subview
from clap_tpu.scene.terrain import terrain_init_square_landscape
from clap_tpu_torch.bench import (_cube_field, build_production,
                                  production_frame, production_geometry)
from clap_tpu_torch.bridge import to_numpy
from test_torch_common import assert_tree_equal, jnp_tree, psnr

W, H, NR_V, N_CUBES, BAKE, CAP = 128, 96, 24, 8, 256, 4096


@pytest.fixture(scope="module")
def both():
    """The JAX package's production scene (as bench.py builds it, cut to
    size) and its frame of the bench's camera; the port's."""
    t = terrain_init_square_landscape(3, -32.0, 0.0, -32.0, 64.0, NR_V)
    vs, ns, fs, base = [], [], [], 0
    for cv, cn, cf in _cube_field(t, N_CUBES):
        vs.append(cv)
        ns.append(cn)
        fs.append(cf + base)
        base += cv.shape[0]
    models = [
        jsr.model_from_mesh(t.vx, t.norm, t.idx.reshape(-1, 3),
                            base_color=(0.45, 0.45, 0.45), with_lods=False),
        jsr.model_from_mesh(np.concatenate(vs), np.concatenate(ns),
                            np.concatenate(fs), base_color=(0.6, 0.5, 0.4),
                            with_lods=False)]
    rt = jsr.build_render_tables(models, np.array([0, 1]), np.ones(2, bool),
                                 entity_shadow_static=np.array([True, False]))
    le = lights_empty(1)
    d = jnp.array([-0.4, -0.8, -0.4])
    jl = le._replace(direction=le.direction.at[0].set(d / jnp.linalg.norm(d)),
                     color=le.color.at[0].set(jnp.array([1.0, 0.95, 0.9])),
                     is_dir=le.is_dir.at[0].set(True),
                     active=le.active.at[0].set(True))
    mx0 = jnp.tile(jnp.eye(4), (2, 1, 1)).astype(jnp.float32)
    ss = jsr.bake_static_shadow(rt, mx0, jl.direction[0], shadow_size=BAKE)
    opts = jpl.RenderOptions(width=W, height=H, shadow_size=512,
                             film_grain=0.0, raster_cap=4096,
                             kernel_attrs=jsr.kernel_attrs_ok(rt))
    proj = jmx.mat4_perspective(jnp.pi / 3, W / H, 0.1, 200.0)
    eye = jnp.array([[0.0, 18.0, 28.0]])
    mxs = jnp.tile(jnp.eye(4), (1, 2, 1, 1)).astype(jnp.float32)

    @jax.jit
    def frame(mxs, eyes):
        views = jax.vmap(lambda e: jmx.mat4_look_at(
            e, jnp.array([0.0, 2.0, 0.0]),
            jnp.array([0.0, 1.0, 0.0])))(eyes)
        planes = jax.vmap(lambda v: make_subview(v, proj).planes)(views)
        geom, axes = jsr.assemble_cluster_records_batch(
            rt, mxs, jnp.ones((1, 2), bool), planes, eyes, views, proj,
            cap=CAP)
        img = jpl.render_frame_dynamic_batch(opts, geom, axes, views, proj,
                                             jl, eyes, static_shadow=ss)
        return geom.comp_valid, geom.comp_ent, img

    ref = dict(rt=rt, ss=[np.asarray(x) for x in ss], ka=opts.kernel_attrs,
               out=[np.asarray(x) for x in frame(mxs, eye)])
    w = build_production("cpu", width=W, height=H, nr_v=NR_V,
                         n_cubes=N_CUBES, bake_size=BAKE, cap=CAP)
    geom, _ = production_geometry(w, w["eye"])
    got = [geom.comp_valid[0].numpy(), geom.comp_ent[0].numpy(),
           production_frame(w, w["eye"])[0].numpy()]
    return ref, w, got


def test_production_tables_exact(both):
    ref, w, _ = both
    assert ref["ka"] and w["opts"].kernel_attrs
    assert_tree_equal(jnp_tree(ref["rt"]), to_numpy(w["rt"]), "rt")


def test_production_bake(both):
    ref, w, _ = both
    for a, b in zip(ref["ss"], w["static_shadow"]):
        b = b.numpy()
        assert a.shape == b.shape
        assert (np.abs(a - b) <= 1e-4).mean() >= 0.995
    assert w["static_shadow"][0].shape == (1, BAKE, BAKE, 2)


def test_production_cluster_records(both):
    ref, _, got = both
    assert np.array_equal(ref["out"][0][0], got[0])
    valid = got[0]
    assert np.array_equal(ref["out"][1][0][valid], got[1][valid])
    assert 0 < valid.sum() < CAP        # culled, and below the cap


def test_production_frame(both):
    ref, _, got = both
    img = got[2]
    assert img.shape == (H, W, 3) and np.isfinite(img).all()
    assert img.std() > 0.01
    assert psnr(ref["out"][2][0], img) >= 35.0


def test_production_frame_depends_on_camera(both):
    _, w, got = both
    moved = production_frame(w, w["eye"] + torch.tensor([[0.5, 0.0, 0.0]]))
    assert np.abs(moved[0].numpy() - got[2]).max() > 1e-6
