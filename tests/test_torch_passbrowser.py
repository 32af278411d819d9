"""The pass browser's picture on the port against the JAX package:
``compose_pass_browser`` (normalized thumbnails in a labelled grid, the
labels through ``ui_compose``) on the same numpy taps, exact; and on the
port's own taps of the authored level's frame against the JAX package's
taps of the same frame (``test_torch_level_frame.render_slots``), each
thumbnail within the taps' bar there (PSNR >= 35 dB) and every label
pixel exact."""
import numpy as np
import pytest
import torch

from clap_tpu.render import font as jfont
from clap_tpu.render import passbrowser as J
from clap_tpu_torch.render import font as tfont
from clap_tpu_torch.render import passbrowser as T
from test_torch_common import psnr


def seeded_taps(seed, s=48):
    """One env's taps of every kind the browser normalizes, made from a
    seed: the atlas, HDR, RGB and 2-/4-channel images, a depth tap with a
    background of inf, a 1-channel mask and a tap outside PASS_ORDER."""
    rng = np.random.default_rng(seed)
    f = np.float32
    depth = rng.uniform(1.0, 30.0, (s, s + 16)).astype(f)
    depth[rng.uniform(size=depth.shape) < 0.3] = np.inf
    return {
        "combine": rng.uniform(0, 1, (s, s + 16, 3)).astype(f),
        "shadow_atlas": rng.uniform(0.2, 0.9, (4 * s, s, 2)).astype(f),
        "lighting_hdr": rng.uniform(0, 4, (s, s + 16, 3)).astype(f),
        "depth": depth,
        "edges": (rng.uniform(size=(s, s + 16)) < 0.1).astype(f),
        "smaa_weights": rng.uniform(0, 1, (s, s + 16, 2)).astype(f),
        "emission": rng.uniform(0, 1, (s, s + 16, 4)).astype(f),
        "edge_key": rng.uniform(-3, 7, (s, s + 16)).astype(f),
        "ssao": rng.uniform(0, 1, (s, s + 16)).astype(f),
        "custom": rng.uniform(-0.5, 1.5, (s // 2, s, 3)).astype(f),
    }


@pytest.mark.parametrize("name", list(seeded_taps(0)) + ["all_inf"])
def test_normalize_and_thumb_equal(name):
    taps = seeded_taps(1)
    a = np.full((8, 8), np.inf, np.float32) if name == "all_inf" \
        else taps[name]
    key = "depth" if name == "all_inf" else name
    ref = J._normalize(key, a)
    got = T._normalize(key, torch.from_numpy(a))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(T._thumb(got, 17, 23),
                                  J._thumb(ref, 17, 23))


@pytest.mark.parametrize("font", [None, 12], ids=["5x7", "atlas12"])
@pytest.mark.parametrize("kw", [dict(), dict(thumb_h=40, thumb_w=56,
                                             cols=3)],
                         ids=["default", "small"])
@pytest.mark.parametrize("counts", [False, True])
def test_compose_equal_on_the_same_taps(font, kw, counts):
    taps = seeded_taps(2)
    cnt = dict(faces_valid=np.int32(1234), shadow_casters=np.int32(56),
               hit_pixels=np.int64(3001)) if counts else None
    ref = J.compose_pass_browser(
        taps, cnt, font=None if font is None else jfont.load_font(font),
        **kw)
    got = T.compose_pass_browser(
        {k: torch.from_numpy(v) for k, v in taps.items()},
        None if cnt is None else {k: torch.tensor(int(v))
                                  for k, v in cnt.items()},
        font=None if font is None else tfont.load_font(font), **kw)
    assert got.dtype == np.float32 and got.shape == np.asarray(ref).shape
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_compose_empty():
    np.testing.assert_array_equal(T.compose_pass_browser({}),
                                  np.asarray(J.compose_pass_browser({})))


@pytest.fixture(scope="module")
def level_taps():
    """The level frame's taps from both packages (slot 0; the port's env
    0), as test_torch_level_frame.py makes them."""
    from test_torch_level_frame import (LEVEL, H, W, assets57, jload,
                                        load_scene, render_slots, tassets,
                                        walked_state)

    doc = LEVEL.read_text()
    kw = dict(max_entities=16, max_bodies=4)
    Jl = jload(doc, asset_loader=assets57.asset_loader, **kw)
    Tl = load_scene(doc, asset_loader=tassets.asset_loader, device="cpu",
                    **kw)
    st = walked_state(Tl)
    st = st._replace(visible=st.visible | (Tl.game.platform_group == 0))
    f = render_slots(Jl, Tl, st, W, H)[0]
    return f["ref"][1], {k: v[0] for k, v in f["taps"].items()}


def test_compose_on_each_package_s_taps(level_taps):
    ref_taps, taps = level_taps
    assert sorted(ref_taps) == sorted(taps)
    th, tw, pad, label_h, cols = 90, 120, 4, 14, 4
    ref = np.asarray(J.compose_pass_browser(ref_taps))
    got = T.compose_pass_browser(taps)
    assert got.shape == ref.shape and np.isfinite(got).all()
    names = [n for n in T.PASS_ORDER if n in taps]
    thumbs = np.zeros(got.shape[:2], bool)
    for i, n in enumerate(names):
        r, c = divmod(i, cols)
        y = pad + r * (th + label_h + pad) + label_h
        x = pad + c * (tw + pad)
        thumbs[y:y + th, x:x + tw] = True
        p = psnr(ref[y:y + th, x:x + tw], got[y:y + th, x:x + tw])
        assert p >= 35.0, (n, p)
    # the labels and the background: the same pixels
    np.testing.assert_array_equal(got[~thumbs], ref[~thumbs])
    # the first row's thumbnails differ from one another
    y = pad + label_h
    means = [float(got[y:y + th, pad + k * (tw + pad):
                       pad + k * (tw + pad) + tw].mean())
             for k in range(cols)]
    assert len(set(np.round(means, 5))) == cols, means
