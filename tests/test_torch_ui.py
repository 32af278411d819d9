"""The UI layer of the port against the JAX package: the 5×7 font and the
baked glyph atlas, ui_layout, ui_compose, click/focus routing, the menu,
the debug panels and the UI animations.

Fonts, quads, focus, stacks, settings keys and animation values are exact;
``ui_compose`` is held bit-exact against the JAX function run eagerly on
the CPU (its order of operations and roundings are the reference's)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clap_tpu.engine.input import InputRecord as JRecord
from clap_tpu.render import debugui as jdbg
from clap_tpu.render import font as jfont
from clap_tpu.render import ui as jui
from clap_tpu.render import ui_anim as janim
from clap_tpu_torch.engine.input import InputRecord
from clap_tpu_torch.render import debugui as tdbg
from clap_tpu_torch.render import font as tfont
from clap_tpu_torch.render import ui as tui
from clap_tpu_torch.render import ui_anim as tanim
import test_torch_common  # noqa: F401  (one torch thread per worker)

TEXTS = ["", "FPS 60", "Hello, clap!", "~x_y=(1/2)%", "abc XYZ 0123456789"]


@pytest.mark.parametrize("text", TEXTS)
@pytest.mark.parametrize("scale", [1, 2, 3])
def test_5x7_font_equal(text, scale):
    np.testing.assert_array_equal(tfont.render_text(text, scale),
                                  jfont.render_text(text, scale))
    assert tfont.text_size(text, scale) == jfont.text_size(text, scale)
    for ch in text or " ":
        np.testing.assert_array_equal(tfont.glyph_bitmap(ch),
                                      jfont.glyph_bitmap(ch))


@pytest.mark.parametrize("size", [12, 16])
def test_glyph_atlas_bake_equal(size):
    """The baked atlas, its advances and its rendered lines are the
    reference's (PIL and the DejaVu face are in the test image)."""
    ja, ta = jfont.load_font(size), tfont.load_font(size)
    assert ja is not None and ta is not None
    np.testing.assert_array_equal(ta.atlas, ja.atlas)
    np.testing.assert_array_equal(ta.advance, ja.advance)
    assert (ta.cell_w, ta.cell_h) == (ja.cell_w, ja.cell_h)
    for text in TEXTS:
        for scale in (1, 2):
            np.testing.assert_array_equal(ta.render_text(text, scale),
                                          ja.render_text(text, scale))
            assert ta.text_size(text, scale) == ja.text_size(text, scale)


def test_load_font_none_without_a_face(tmp_path):
    assert tfont.load_font(16, str(tmp_path / "missing.ttf")) is None
    assert jfont.load_font(16, str(tmp_path / "missing.ttf")) is None


def _tree(pkg, font=None):
    """The same element tree built from one package's UiElement."""
    AF, E = pkg.AF, pkg.UiElement
    return [
        E(w=0.5, h=0.25, affinity=AF.RIGHT | AF.BOTTOM, x=10, y=10,
          color=(0.2, 0.4, 0.9, 0.35)),
        E(w=100, h=50, affinity=AF.CENTER | AF.VCENTER,
          color=(1.0, 0.0, 0.0, 0.5),
          children=[E(w=0.5, h=0.5, affinity=AF.RIGHT | AF.BOTTOM,
                      color=(0.1, 0.9, 0.1, 0.7), text="OK", text_scale=1,
                      font=font)]),
        pkg.osd("HELLO WORLD 42", text_scale=2, font=font),
        E(x=-30, y=-6, w=80, h=30, color=(0.3, 0.3, 0.3, 0.9),
          text="CLIPPED LABEL", text_scale=1),
        E(x=5, y=40, w=0.3, h=0.2, affinity=AF.LEFT | AF.VCENTER,
          text="focus", focused=True, font=font),
        E(x=0, y=0, w=10, h=10, visible=False, color=(1, 1, 1, 1)),
    ]


def _quads_equal(jq, tq):
    assert len(jq) == len(tq)
    for a, b in zip(jq, tq):
        assert (a.x0, a.y0, a.x1, a.y1) == (b.x0, b.y0, b.x1, b.y1)
        assert tuple(a.color) == tuple(b.color)
        if a.text_bitmap is None:
            assert b.text_bitmap is None
        else:
            np.testing.assert_array_equal(b.text_bitmap, a.text_bitmap)


@pytest.mark.parametrize("size", [(128, 96), (320, 180), (640, 360)])
@pytest.mark.parametrize("atlas", [False, True])
def test_layout_and_compose_equal(size, atlas):
    """The quads are the reference's and the composite over a seeded
    frame equals the eager JAX composite bit for bit."""
    W, H = size
    jf, tf = (jfont.load_font(14), tfont.load_font(14)) if atlas \
        else (None, None)
    jq = jui.ui_layout(_tree(jui, jf), W, H)
    tq = tui.ui_layout(_tree(tui, tf), W, H)
    _quads_equal(jq, tq)
    frame = np.random.default_rng(W).uniform(0, 1, (H, W, 3)).astype(
        np.float32)
    ref = np.asarray(jui.ui_compose(jnp.asarray(frame), jq))
    src = torch.from_numpy(frame.copy())
    got = tui.ui_compose(src, tq)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(src.numpy(), frame)   # input untouched
    assert not np.array_equal(ref, frame)


def test_click_routing_equal():
    def run(pkg):
        hits = []
        els = [pkg.UiElement(x=10, y=10, w=100, h=100, name="below",
                             on_click=lambda el, x, y: hits.append(
                                 ("below", x, y))),
               pkg.UiElement(x=40, y=40, w=40, h=40, name="above",
                             on_click=lambda el, x, y: hits.append(
                                 ("above", x, y)))]
        q = pkg.ui_layout(els, 200, 200)
        res = [pkg.ui_element_click(q, x, y)
               for x, y in ((50, 50), (15, 15), (190, 190), (79.5, 40))]
        return res, hits

    assert run(tui) == run(jui)


def _menu_run(pkg, Rec):
    fired = []
    M, I = pkg.Menu, pkg.MenuItem
    items = [
        I("RESUME", fn=lambda m, it: fired.append("resume")),
        I("SETTINGS", items=[
            I("FULLSCREEN", fn=lambda m, it: fired.append("fs")),
            I("AUDIO", items=[I("MUTE", fn=lambda m, it: fired.append(
                "mute"))]),
            I("VSYNC", fn=lambda m, it: fired.append("vsync")),
        ]),
        I("QUIT", fn=lambda m, it: fired.append("quit")),
    ]
    m = M(items, 320, 240)
    trace = []
    seq = [dict(down=True), dict(enter=True), dict(down=True),
           dict(enter=True), dict(enter=True), dict(menu_toggle=True),
           dict(up=True), dict(up=True), dict(space=True),
           dict(menu_toggle=True), dict(menu_toggle=True),
           dict(mouse_x=160.0, mouse_y=150.0),
           dict(mouse_x=160.0, mouse_y=150.0, mouse_click=True),
           dict(mouse_x=5.0, mouse_y=5.0)]
    for kw in seq:
        consumed = m.handle_input(Rec(**kw))
        trace.append((consumed, m.widget.focus, [it.name for it in m.items],
                      [(q.x0, q.y0, q.x1, q.y1, q.color) for q in m.quads]))
    return trace, fired


def test_menu_navigation_equal():
    """The same InputRecord sequence (down, enter, nested submenus, back,
    wraparound, hover and click) gives the same focus, stack, quads and
    fired leaves."""
    assert _menu_run(tui, InputRecord) == _menu_run(jui, JRecord)


def test_widget_focus_equal():
    def run(pkg):
        log = []
        els = [pkg.UiElement(x=0, y=30 * i, w=80, h=24, name=f"e{i}",
                             on_focus=lambda el, f: log.append((el.name, f)),
                             on_click=lambda el, x, y: log.append(
                                 ("click", el.name, x, y)))
               for i in range(3)]
        w = pkg.UiWidget(els)
        q = pkg.ui_layout(els, 200, 200)
        out = []
        for op in (lambda: w.pick_rel(1), lambda: w.pick_rel(-1),
                   lambda: w.pick_rel(2), lambda: w.hover(q, 10, 65),
                   lambda: w.click(q, 10, 35), lambda: w.activate(),
                   lambda: w.hover(q, 190, 190)):
            out.append((op(), w.focus))
        return out, log

    assert run(tui) == run(jui)


def test_menu_compose_equal():
    """A menu with the baked font composites like the reference's."""
    jm = jui.Menu([jui.MenuItem("START"), jui.MenuItem("QUIT")], 128, 96,
                  font=jfont.load_font(14))
    tm = tui.Menu([tui.MenuItem("START"), tui.MenuItem("QUIT")], 128, 96,
                  font=tfont.load_font(14))
    frame = np.random.default_rng(1).uniform(0, 1, (96, 128, 3)).astype(
        np.float32)
    for focus in (0, 1):
        jm.widget._set_focus(focus)
        tm.widget._set_focus(focus)
        jm.quads = jui.ui_layout(jm.widget.uies, 128, 96)
        tm.quads = tui.ui_layout(tm.widget.uies, 128, 96)
        np.testing.assert_array_equal(
            tm.compose(torch.from_numpy(frame)).numpy(),
            np.asarray(jm.compose(jnp.asarray(frame))))


def _panel_run(pkg, Rec, settings, font=None):
    state = {"exposure": 1.0, "bloom": True, "steps": 3}
    dui = pkg.InteractiveDebugUI(settings=settings, width=160, height=120,
                                 font=font)
    dui.register("render", lambda: {"fps": 59.9, "ms": 16.6667})
    dui.register("mem", lambda: {"objs": 12})
    for key, step in (("exposure", 0.25), ("bloom", 0.1), ("steps", 1)):
        dui.register_adjustable("render", key, pkg.Adjustable(
            get=lambda k=key: state[k],
            set=lambda v, k=key: state.__setitem__(k, v), step=step))
    dui.toggle("render", True)
    dui.toggle("mem")
    trace = []
    seq = [dict(down=True), dict(menu_toggle=True), dict(down=True),
           dict(down=True), dict(right=True), dict(left=True),
           dict(left=True), dict(down=True), dict(right=True),
           dict(down=True), dict(right=True), dict(up=True), dict(up=True),
           dict(up=True), dict(up=True), dict(enter=True), dict(down=True),
           dict(space=True), dict(down=True), dict(down=True)]
    for kw in seq:
        consumed = dui.handle_input(Rec(**kw))
        q = (jui if pkg is jdbg else tui).ui_layout(dui.build_elements(),
                                                    160, 120)
        trace.append((consumed, dui.focus, dui.visible, dict(state),
                      [(x.x0, x.y0, x.x1, x.y1, x.color,
                        None if x.el is None else x.el.text) for x in q]))
    return dui, trace


def test_debug_panels_equal(tmp_path, monkeypatch):
    """The interactive panels under one InputRecord sequence: the same
    focus, values, fold state, settings keys and quads; the panel column
    composites like the reference's."""
    from clap_tpu.utils.settings import Settings as JSettings
    from clap_tpu_torch.utils.settings import Settings as TSettings

    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "j"))
    js = JSettings("dbg.json")
    jd, jt = _panel_run(jdbg, JRecord, js)
    monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / "t"))
    ts = TSettings("dbg.json")
    td, tt = _panel_run(tdbg, InputRecord, ts)
    assert tt == jt
    assert ts.doc == js.doc and ts.doc["debug"]["render"]["unfolded"] in (
        True, False)
    frame = np.random.default_rng(2).uniform(0, 1, (120, 160, 3)).astype(
        np.float32)
    jd.visible = td.visible = True
    np.testing.assert_array_equal(
        td.compose(torch.from_numpy(frame)).numpy(),
        np.asarray(jd.compose(jnp.asarray(frame))))


def test_debug_registry_equal(tmp_path, monkeypatch):
    from clap_tpu.utils.settings import Settings as JSettings
    from clap_tpu_torch.utils.settings import Settings as TSettings

    out = []
    for pkg, S, sub in ((jdbg, JSettings, "j"), (tdbg, TSettings, "t")):
        monkeypatch.setenv("XDG_STATE_HOME", str(tmp_path / sub))
        dui = pkg.DebugUI(settings=S("dbg.json"))
        dui.register("fps", lambda: {"fps": 59.94321})
        dui.register("mem", lambda: {"objs": 12})
        dui.toggle("fps")
        texts = [e.text for e in dui.build_elements()]
        again = pkg.DebugUI(settings=S("dbg.json"))
        again.register("fps", lambda: {})
        out.append((texts, again.modules["fps"].enabled))
    assert out[0] == out[1]


@pytest.mark.parametrize("easing", sorted(janim.EASINGS))
def test_easings_equal(easing):
    ts = np.linspace(0.0, 1.0, 101)
    assert [tanim.EASINGS[easing](float(t)) for t in ts] \
        == [janim.EASINGS[easing](float(t)) for t in ts]


def test_animator_equal():
    """Slide-in, fade and a custom animation with on_done, stepped at
    60 Hz past the longest: the same element values every frame."""
    def run(pkg, anim):
        el = pkg.UiElement(w=100, h=40, y=-50.0, color=(1, 1, 1, 0.0))
        done = []
        an = anim.UiAnimator()
        an.slide_in(el, -50.0, 20.0, duration=0.5)
        an.fade(el, 0.0, 0.8, duration=0.25)
        an.add(anim.UiAnimation(el, "w", 100.0, 160.0, 0.3, "elastic",
                                on_done=lambda a: done.append(a.attr)))
        vals = []
        for _ in range(40):
            an.step(1 / 60)
            vals.append((el.x, el.y, el.w, el.color, len(an.anims)))
        return vals, done

    assert run(tui, tanim) == run(jui, janim)
