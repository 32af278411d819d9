"""The authored level's rendered frame on the port against the JAX
package: demo/level57.json loaded by both packages, its render tables and
texture layers from scene_render_setup (the crate's checker puts the
frame on the gather path), one state (the port's engine_step, 3 frames of
the walk, group 0's platforms shown) drawn from both camera slots at
256 × 128 (the JAX package cannot raster the game's 640 wide, ROADMAP §3).
The JAX side is Engine.attach_graphics's render closure
(clap_tpu/engine/core.py:193-215) through render_frame_debug; the port's
is GameFrameRenderer, and render_frame_debug on the same geometry.

Bars: the frame LDR PSNR >= 35 dB, as the other frame parity tests; every
tap of render_frame_debug present in both with the same shape, both sides
scaled into [0, 1] by the JAX tap's finite range (so a gain or offset
between the two shows) at PSNR >= 35 dB, the depth
tap's background agreeing on >= 99.5 % of the pixels; the counts of valid
faces and shadow casters exact, hit pixels within 0.5 %."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "demo"))

import assets57
from clap_tpu import mathx as jmx
from clap_tpu.render.camera import camera_view_proj
from clap_tpu.render.passbrowser import PASS_ORDER as JPASS_ORDER
from clap_tpu.render.passbrowser import render_frame_debug as jdebug
from clap_tpu.render.pipeline import RenderOptions as JOptions
from clap_tpu.render.scenerender import assemble_scene_geometry as jassemble
from clap_tpu.render.view import make_subview
from clap_tpu.scene.content import scene_render_setup as jsetup
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu_torch.engine.frame import GameFrameRenderer
from clap_tpu_torch.engine.step import engine_step, inputs_zero
from clap_tpu_torch.render.passbrowser import PASS_ORDER, render_frame_debug
from clap_tpu_torch.render.pipeline import RenderOptions
from clap_tpu_torch.scene import assets57 as tassets
from clap_tpu_torch.scene.content import scene_render_setup
from clap_tpu_torch.scene.loader import load_scene
from clap_tpu_torch.scene.testbed import replicate_state
from test_torch_common import jnp_tree, psnr

LEVEL = Path(__file__).resolve().parents[1] / "demo" / "level57.json"
W, H = 256, 128


def _normalized(a, ref):
    """Tap ``a`` scaled by the finite range of the reference tap ``ref``
    (the reference lands in [0, 1]); non-finite values become 0."""
    a = np.asarray(a, np.float64)
    r = np.asarray(ref, np.float64)
    fin = np.isfinite(r)
    lo, hi = (r[fin].min(), r[fin].max()) if fin.any() else (0.0, 1.0)
    return np.where(np.isfinite(a), (a - lo) / max(hi - lo, 1e-6), 0.0)


def render_slots(J, T, st, width, height):
    """Both camera slots of port state ``st`` (one env) drawn by the JAX
    package (attach_graphics's closure through render_frame_debug, jitted)
    and the port (GameFrameRenderer, and render_frame_debug on its
    geometry) at ``width`` × ``height``: a dict per slot of img, dimg (the
    port's debug image), taps, counts and ref (the JAX package's (img,
    taps, counts) with numpy leaves)."""
    opts = dict(width=width, height=height, shadow_size=256,
                film_grain=0.0)
    rt_j, ts_j = jsetup(J, tex_size=16, with_lods=False)
    rt_t, ts_t = scene_render_setup(T, tex_size=16, with_lods=False,
                                    device="cpu")
    renderer = GameFrameRenderer(rt_t, T.lights, RenderOptions(**opts),
                                 skip_culling=T.cfg.entities.skip_culling,
                                 textures=ts_t)
    jopts = JOptions(**opts)

    def jrender(mxs, visible, pos, pitch, yaw):
        q = jmx.qmul(
            jmx.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), yaw),
            jmx.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), pitch))
        view, proj = camera_view_proj(pos, q, math.pi / 3, width / height)
        geom = jassemble(rt_j, mxs, visible, make_subview(view, proj).planes,
                         pos, skip_culling=J.cfg.entities.skip_culling)
        return jdebug(jopts, geom, view, proj, J.lights, pos,
                      textures=ts_j)

    jrender = jax.jit(jrender)
    out = []
    for slot in range(st.cameras.pos.shape[1]):
        cam = type(st.camera)(*(x[:, slot] for x in st.cameras))
        sts = st._replace(camera=cam)
        img = renderer(sts)
        view = renderer.view(sts)
        geom = renderer.geometry(sts, view)
        timg, taps, counts = render_frame_debug(
            renderer.opts, geom, view, renderer.proj, renderer.lights,
            cam.pos, textures=renderer.textures)
        ref = jnp_tree(jrender(*(jnp.asarray(x[0].numpy()) for x in (
            st.mx, st.visible, cam.pos, cam.pitch, cam.yaw))))
        out.append(dict(img=img, dimg=timg, taps=taps, counts=counts,
                        ref=ref))
    return out


def walked_state(T, frames=3):
    """The port's state after ``frames`` frames of character 0's walk
    (camera occlusion on), one env."""
    st = replicate_state(T.state0, 1)
    ins = inputs_zero(T.cfg.char_params.body.shape[0], device="cpu")
    ins.motion[0, 0] = 1.0
    ins = type(ins)(*(x[None] for x in ins))
    for _ in range(frames):
        st = engine_step(T.cfg, st, ins, camera_occlusion=True)
    return st


@pytest.fixture(scope="module")
def frames():
    doc = LEVEL.read_text()
    kw = dict(max_entities=16, max_bodies=4)
    J = jload(doc, asset_loader=assets57.asset_loader, **kw)
    T = load_scene(doc, asset_loader=tassets.asset_loader, device="cpu",
                   **kw)
    st = walked_state(T)
    st = st._replace(visible=st.visible | (T.game.platform_group == 0))
    return render_slots(J, T, st, W, H)


@pytest.mark.parametrize("slot", [0, 1])
def test_level_frame(frames, slot):
    f = frames[slot]
    img = f["img"].numpy()
    assert img.shape == (1, H, W, 3) and np.isfinite(img).all()
    assert float(img.std()) > 0.01
    assert psnr(f["ref"][0], img[0]) >= 35.0
    # the debug run draws the same frame
    assert torch.equal(f["dimg"], f["img"])


def test_both_slots_differ(frames):
    a, b = (f["img"].numpy() for f in frames)
    assert not np.allclose(a, b, atol=1e-3)


def test_pass_order():
    assert PASS_ORDER == JPASS_ORDER


@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("name", PASS_ORDER)
def test_level_frame_taps(frames, slot, name):
    f = frames[slot]
    ref, taps = f["ref"][1], f["taps"]
    assert (name in ref) == (name in taps), name
    if name not in ref:
        return
    a = np.asarray(ref[name])
    b = taps[name][0].numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    assert np.isfinite(b).all() or name == "depth"
    if name == "depth":
        agree = (np.isfinite(a) == np.isfinite(b)).mean()
        assert agree >= 0.995, agree
    assert psnr(_normalized(a, a), _normalized(b, a)) >= 35.0, name


@pytest.mark.parametrize("slot", [0, 1])
def test_level_frame_counts(frames, slot):
    f = frames[slot]
    ref, got = f["ref"][2], f["counts"]
    assert sorted(ref) == sorted(got)
    for k in ("faces_valid", "shadow_casters"):
        assert int(got[k][0]) == int(ref[k]), k
    hp = int(ref["hit_pixels"])
    assert abs(int(got["hit_pixels"][0]) - hp) <= 0.005 * hp
    assert hp > 0
