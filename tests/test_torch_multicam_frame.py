"""Both camera slots of the two-camera scene (tests/test_multicam.py)
rendered by the port against the JAX package at 128 × 64, from one state
(the port's engine_step, 3 frames of character 0's walk): the JAX side is
Engine.attach_graphics's render closure through render_frame_debug, the
port's GameFrameRenderer and render_frame_debug (the helpers of
tests/test_torch_level_frame.py). Bars as there: LDR PSNR >= 35 dB per
slot, every tap scaled by the JAX tap's range at PSNR >= 35 dB, counts
exact (hit pixels within 0.5 %)."""
import numpy as np
import pytest

import test_multicam
from clap_tpu.scene.loader import load_scene as jload
from clap_tpu_torch.scene.loader import load_scene
from test_torch_common import psnr
from test_torch_level_frame import (PASS_ORDER, _normalized, render_slots,
                                    walked_state)

W, H = 128, 64


@pytest.fixture(scope="module")
def frames():
    kw = dict(asset_loader=test_multicam._loader, max_entities=8,
              max_bodies=4)
    J = jload(test_multicam.SCENE, **kw)
    T = load_scene(test_multicam.SCENE, device="cpu", **kw)
    return render_slots(J, T, walked_state(T), W, H)


@pytest.mark.parametrize("slot", [0, 1])
def test_camera_slot_frame(frames, slot):
    f = frames[slot]
    img = f["img"].numpy()
    assert img.shape == (1, H, W, 3) and np.isfinite(img).all()
    assert float(img.std()) > 0.01
    assert psnr(f["ref"][0], img[0]) >= 35.0


def test_slots_see_different_views(frames):
    a, b = (f["img"].numpy() for f in frames)
    assert not np.allclose(a, b, atol=1e-3)


@pytest.mark.parametrize("slot", [0, 1])
def test_camera_slot_taps_and_counts(frames, slot):
    f = frames[slot]
    ref, taps = f["ref"][1], f["taps"]
    assert sorted(ref) == sorted(taps)
    for name in PASS_ORDER:
        if name in ref:
            a, b = np.asarray(ref[name]), taps[name][0].numpy()
            assert a.shape == b.shape, name
            assert psnr(_normalized(a, a), _normalized(b, a)) >= 35.0, name
    for k in ("faces_valid", "shadow_casters"):
        assert int(f["counts"][k][0]) == int(f["ref"][2][k]), k
    hp = int(f["ref"][2]["hit_pixels"])
    assert abs(int(f["counts"]["hit_pixels"][0]) - hp) <= 0.005 * hp
