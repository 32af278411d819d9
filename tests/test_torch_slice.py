"""The slice end to end: 2 frames of the port's step_and_render (2 envs,
96², the composed testbed cut to test size) on a GameWorld with no game
layer, against the JAX composition of bench.py:668-684 with engine_step
in place of game_step — the vmapped engine_step (camera occlusion on),
assemble_cluster_records_batch and render_frame_dynamic_batch. (The full
game layer composed the same way is tests/test_torch_game.py's.) Bars:
state int/bool exact and float within atol 1e-4 + rtol 1e-4; LDR PSNR
>= 35 dB per env and frame."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clap_tpu import mathx as jmx
from clap_tpu.engine.step import engine_step as jstep, inputs_zero
from clap_tpu.render import pipeline as jpl
from clap_tpu.render import scenerender as jsr
from clap_tpu.scene import testbed as jtb
from clap_tpu_torch.engine.frame import SceneRenderer, step_and_render
from clap_tpu_torch.engine.game import GameSessionState, GameWorld
from clap_tpu_torch.engine.step import Inputs
from clap_tpu_torch.render import pipeline as tpl
from clap_tpu_torch.render import scenerender as tsr
from clap_tpu_torch.scene import testbed as ttb
from test_torch_common import assert_tree_close, jnp_tree, psnr
from test_torch_render import (LOD_SCALE, OPTS, RES, composed_scene,
                               jax_views)

B, FRAMES = 2, 2


@pytest.fixture(scope="module")
def frames():
    J, T, jrt, trt, jl, tl = composed_scene()
    jopts = jpl.RenderOptions(**OPTS)
    proj = jmx.mat4_perspective(jnp.pi / 3, 1.0, 0.1, 200.0)
    skip = J.cfg.entities.skip_culling
    jss = jsr.bake_static_shadow(jrt, J.state0.mx, jl.direction[0],
                                 shadow_size=128, far=200.0)

    @jax.jit
    def jax_step_and_render(sts, ins):
        sts = jax.vmap(lambda s, i: jstep(J.cfg, s, i,
                                          camera_occlusion=True))(sts, ins)
        views, planes = jax_views(sts.camera, proj)
        geom, axes = jsr.assemble_cluster_records_batch(
            jrt, sts.mx, sts.visible, planes, sts.camera.pos, views, proj,
            cap=jopts.record_compact, skip_culling=skip, lod_scale=LOD_SCALE)
        return sts, jpl.render_frame_dynamic_batch(
            jopts, geom, axes, views, proj, jl, sts.camera.pos, far=200.0,
            static_shadow=jss)

    tss = tsr.bake_static_shadow(trt, T.state0.mx, tl.direction[0],
                                 shadow_size=128, far=200.0)
    renderer = SceneRenderer(trt, tl, tpl.RenderOptions(**OPTS),
                             skip_culling=T.cfg.entities.skip_culling,
                             static_shadow=tss, lod_scale=LOD_SCALE)
    mot = np.zeros((B, 2, 2), np.float32)
    mot[:, 0, 0] = 1.0                       # bench.py:688-689
    mot[1, 0] = (0.3, -0.8)
    jins = inputs_zero(2)._replace(
        motion=jnp.asarray(mot), jump=jnp.zeros((B, 2), bool),
        cam_delta=jnp.zeros((B, 3)), dash=jnp.zeros((B, 2), bool))
    tins = Inputs(motion=torch.as_tensor(mot),
                  jump=torch.zeros((B, 2), dtype=torch.bool),
                  cam_delta=torch.zeros((B, 3)),
                  dash=torch.zeros((B, 2), dtype=torch.bool))
    js = jtb.replicate_state(J.state0, B)
    gw = GameWorld(scene=T.cfg)
    gs = GameSessionState(engine=ttb.replicate_state(T.state0, B))
    out = []
    for _ in range(FRAMES):
        js, jimg = jax_step_and_render(js, jins)
        gs, timg = step_and_render(gw, renderer, gs, tins)
        out.append((jnp_tree(js), np.asarray(jimg), gs.engine, timg.numpy()))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_slice_state(frames, frame):
    jst, _, tst, _ = frames[frame]
    assert_tree_close(jst, tst, path=f"frame{frame}")


@pytest.mark.parametrize("env", range(B))
@pytest.mark.parametrize("frame", range(FRAMES))
def test_slice_images(frames, frame, env):
    _, jimg, _, timg = frames[frame]
    assert timg.shape == (B, RES, RES, 3) and np.isfinite(timg).all()
    assert float(timg[env].std()) > 0.01
    assert psnr(jimg[env], timg[env]) >= 35.0


def test_slice_frame_counter(frames):
    assert (frames[-1][2].frame == FRAMES).all()
