"""Retained-mode quad UI (counterpart of clap_tpu/render/ui.py; reference:
core/ui.c — quad/text UI rendered through its own model queue after the
3D pipeline, clap.c:645-648).

UI elements use parent-relative fractional layout with affinity flags
(ui.h:10-28: UI_AF_TOP/BOTTOM/LEFT/RIGHT/CENTER/...). Layout, click and
focus routing and the menu are host Python, as in the JAX package.
``ui_compose`` blends the resolved quads and their text over one frame,
an (H, W, C) tensor on its device: a caller with an env batch picks its
env. The call's text bitmaps and colours reach the device in one copy,
and the composite reads nothing back.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntFlag

import numpy as np
import torch

from .font import render_text, text_size


class AF(IntFlag):
    """Affinity flags (ui.h:10-28)."""

    LEFT = 1
    RIGHT = 2
    TOP = 4
    BOTTOM = 8
    CENTER = LEFT | RIGHT
    VCENTER = TOP | BOTTOM


@dataclass
class UiElement:
    """A quad (and optionally text) with fractional layout.

    on_click/on_focus mirror the reference's element callbacks
    (on_click_fn/on_focus_fn, ui.h:61-76): click receives element-local
    coordinates, focus receives the new focus state."""

    x: float = 0.0            # offset (pixels, from affinity edge)
    y: float = 0.0
    w: float = 0.1            # size: fraction of parent if <= 1, else px
    h: float = 0.1
    affinity: AF = AF.LEFT | AF.TOP
    color: tuple = (1.0, 1.0, 1.0, 0.6)
    text: str | None = None
    text_scale: int = 2
    children: list = field(default_factory=list)
    visible: bool = True
    name: str = ""
    on_click: object = None   # callable(el, x_rel, y_rel)
    on_focus: object = None   # callable(el, focused: bool)
    focused: bool = False
    focus_color: tuple = (1.0, 0.85, 0.3, 0.85)
    font: object = None       # GlyphAtlas | None (None → 5×7 procedural)


@dataclass
class ResolvedQuad:
    x0: int
    y0: int
    x1: int
    y1: int
    color: tuple
    text_bitmap: np.ndarray | None = None
    el: UiElement | None = None


def _resolve(el: UiElement, px0, py0, px1, py1, out):
    if not el.visible:
        return
    pw, ph = px1 - px0, py1 - py0
    w = el.w * pw if el.w <= 1.0 else el.w
    h = el.h * ph if el.h <= 1.0 else el.h
    if el.text is not None:
        if el.font is not None:
            th, tw = el.font.text_size(el.text, el.text_scale)
        else:
            th, tw = text_size(el.text, el.text_scale)
        w = max(w, tw + 8)
        h = max(h, th + 8)

    if el.affinity & AF.CENTER == AF.CENTER:
        x0 = px0 + (pw - w) / 2 + el.x
    elif el.affinity & AF.RIGHT:
        x0 = px1 - w - el.x
    else:
        x0 = px0 + el.x
    if el.affinity & AF.VCENTER == AF.VCENTER:
        y0 = py0 + (ph - h) / 2 + el.y
    elif el.affinity & AF.BOTTOM:
        y0 = py1 - h - el.y
    else:
        y0 = py0 + el.y

    tb = None
    if el.text is not None:
        tb = (el.font.render_text(el.text, el.text_scale)
              if el.font is not None
              else render_text(el.text, el.text_scale))
    color = el.focus_color if el.focused else el.color
    out.append(ResolvedQuad(int(x0), int(y0), int(x0 + w), int(y0 + h),
                            color, tb, el))
    for c in el.children:
        _resolve(c, int(x0), int(y0), int(x0 + w), int(y0 + h), out)


def ui_layout(root_elements: list, width: int, height: int) -> list:
    """Resolve the element tree to screen-space quads."""
    out: list[ResolvedQuad] = []
    for el in root_elements:
        _resolve(el, 0, 0, width, height, out)
    return out


def _upload(parts: list, dtype: torch.dtype, device) -> list:
    """The host arrays ``parts`` on ``device`` as views of one flat tensor,
    made in one copy: from pinned memory without waiting on the card, or
    shared with the host buffer on the CPU."""
    if not parts:
        return []
    flat = np.concatenate([p.reshape(-1) for p in parts])
    buf = torch.from_numpy(flat)
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    out, o = [], 0
    for p in parts:
        out.append(buf[o:o + p.size].view(p.shape).to(dtype))
        o += p.size
    return out


def ui_compose(frame: torch.Tensor, quads: list) -> torch.Tensor:
    """Alpha-composite resolved quads (and their text) over one frame (H, W,
    C) — the models_render(&ui->mq) overlay step (clap.c:645-648). Returns
    a new tensor; ``frame`` is left as it is.

    Each quad blends ``region * (1 - a) + colour * a`` and each text
    bitmap ``reg * (1 - alpha) + alpha``, in the JAX package's order of
    operations and roundings (colour · a is the float32 product the
    reference makes), so the result equals its eager composite bit for
    bit."""
    H, W = frame.shape[0], frame.shape[1]
    npdt = torch.empty((), dtype=frame.dtype).numpy().dtype
    draws, parts = [], []
    for q in quads:
        x0, y0 = max(q.x0, 0), max(q.y0, 0)
        x1, y1 = min(q.x1, W), min(q.y1, H)
        if x1 <= x0 or y1 <= y0:
            continue
        a = float(q.color[3])
        parts.append(np.asarray(q.color[:3], npdt) * npdt.type(a))
        text = None
        if q.text_bitmap is not None:
            th, tw = q.text_bitmap.shape
            tx0, ty0 = x0 + 4, y0 + 4
            tx1, ty1 = min(tx0 + tw, W), min(ty0 + th, H)
            if tx1 > tx0 and ty1 > ty0:
                text = (tx0, ty0, tx1, ty1)
                parts.append(np.ascontiguousarray(
                    q.text_bitmap[:ty1 - ty0, :tx1 - tx0, None], npdt))
        draws.append((x0, y0, x1, y1, a, text))
    dev = _upload(parts, frame.dtype, frame.device)
    out = frame.clone()
    i = 0
    for x0, y0, x1, y1, a, text in draws:
        col_a = dev[i]
        i += 1
        out[y0:y1, x0:x1] = out[y0:y1, x0:x1] * (1 - a) + col_a
        if text is not None:
            tx0, ty0, tx1, ty1 = text
            alpha = dev[i]
            i += 1
            reg = out[ty0:ty1, tx0:tx1]
            out[ty0:ty1, tx0:tx1] = reg * (1 - alpha) + alpha
    return out


def osd(text: str, **kw) -> UiElement:
    """On-screen-display helper (the demo help overlay pattern,
    onehandclap.c OSD)."""
    return UiElement(text=text, affinity=AF.CENTER | AF.TOP, y=20,
                     color=(0.05, 0.05, 0.1, 0.55), **kw)


# ---------------------------------------------------------------------------
# click / focus routing (ui.c:632-731) + menu widget (ui.c ui_menu_*)
# ---------------------------------------------------------------------------

def ui_element_click(quads: list, x: float, y: float) -> bool:
    """Dispatch a pointer click to the TOPMOST element under (x, y)
    (ui_element_click, ui.h:94-103): scan resolved quads back-to-front,
    call the hit element's on_click with element-local coordinates."""
    for q in reversed(quads):
        if q.el is None or q.el.on_click is None:
            continue
        if q.x0 <= x < q.x1 and q.y0 <= y < q.y1:
            q.el.on_click(q.el, x - q.x0, y - q.y0)
            return True
    return False


class UiWidget:
    """A focus group over elements (struct ui_widget, ui.h:117-175):
    keyboard focus index with wraparound pick_rel, pointer hover-focus,
    and click dispatch."""

    def __init__(self, elements: list):
        self.uies = elements
        self.focus = -1

    def _set_focus(self, idx: int):
        if self.focus == idx:
            return
        if 0 <= self.focus < len(self.uies):
            el = self.uies[self.focus]
            el.focused = False
            if el.on_focus:
                el.on_focus(el, False)
        self.focus = idx
        if 0 <= idx < len(self.uies):
            el = self.uies[idx]
            el.focused = True
            if el.on_focus:
                el.on_focus(el, True)

    def pick_rel(self, dpos: int):
        """Move focus by dpos with wraparound (ui_widget_pick_rel,
        ui.c:653-676)."""
        if not self.uies:
            return
        nf = (max(self.focus, 0) + dpos) % len(self.uies) \
            if self.focus >= 0 else (0 if dpos >= 0 else len(self.uies) - 1)
        self._set_focus(nf)

    def hover(self, quads: list, x: float, y: float):
        """Pointer hover focuses the element under it, unfocusing the
        previous one; off-widget unfocuses (ui_widget_hover,
        ui.c:701-724)."""
        for i, el in enumerate(self.uies):
            for q in quads:
                if q.el is el and q.x0 <= x < q.x1 and q.y0 <= y < q.y1:
                    self._set_focus(i)
                    return i
        self._set_focus(-1)
        return -1

    def click(self, quads: list, x: float, y: float) -> bool:
        """ui_widget_click (ui.c:726-731)."""
        for i, el in enumerate(self.uies):
            for q in quads:
                if q.el is el and q.x0 <= x < q.x1 and q.y0 <= y < q.y1:
                    self._set_focus(i)
                    return self.activate(x - q.x0, y - q.y0)
        return False

    def activate(self, x: float = 0.0, y: float = 0.0) -> bool:
        """Fire the focused element's on_click (keyboard Enter path)."""
        if 0 <= self.focus < len(self.uies):
            el = self.uies[self.focus]
            if el.on_click:
                el.on_click(el, x, y)
                return True
        return False


@dataclass
class MenuItem:
    """ui_menu_item (ui.h:217-236): leaf fires fn, group opens items."""

    name: str
    fn: object = None                  # callable(menu, item)
    items: list | None = None          # submenu


class Menu:
    """Navigable menu over the quad layout (ui_menu_new + the reference's
    menu input routing): a stack of item lists; up/down move focus,
    Enter activates (descend or fire), Escape ascends (closes at root).

    Drive it with ``handle_input(record)`` using the same InputRecord
    every other input consumer reads (message_input parity)."""

    def __init__(self, root_items: list, width: int, height: int,
                 font=None):
        self.width = width
        self.height = height
        self.font = font
        self.stack = [root_items]
        self.on_leaf = None            # optional observer(item)
        self._build()

    @property
    def items(self):
        return self.stack[-1]

    def _build(self):
        els = []
        for i, item in enumerate(self.items):
            label = item.name + (" >" if item.items else "")
            els.append(UiElement(
                text=label, name=item.name, text_scale=2,
                font=self.font,
                affinity=AF.CENTER | AF.VCENTER,
                y=(i - len(self.items) / 2) * 40,
                color=(0.08, 0.08, 0.15, 0.8),
                on_click=self._make_click(item)))
        self.widget = UiWidget(els)
        self.widget.pick_rel(1)        # focus the first entry
        self.quads = ui_layout(els, self.width, self.height)

    def _make_click(self, item: MenuItem):
        def click(el, x, y):
            if item.items is not None:
                self.stack.append(item.items)
                self._build()
            else:
                if item.fn:
                    item.fn(self, item)
                if self.on_leaf:
                    self.on_leaf(item)
        return click

    def back(self) -> bool:
        """Ascend one level; False when already at the root (caller
        closes the menu — the checkpoint/menu-blur path)."""
        if len(self.stack) > 1:
            self.stack.pop()
            self._build()
            return True
        return False

    def handle_input(self, rec) -> bool:
        """Route a message_input record (engine/input.InputRecord).
        Returns True if the menu consumed the event."""
        consumed = False
        if getattr(rec, "up", False):
            self.widget.pick_rel(-1)
            consumed = True
        if getattr(rec, "down", False):
            self.widget.pick_rel(1)
            consumed = True
        if getattr(rec, "enter", False) or getattr(rec, "space", False):
            self.widget.activate()
            consumed = True
        if getattr(rec, "menu_toggle", False):
            consumed = self.back() or consumed
        mx_, my_ = getattr(rec, "mouse_x", None), getattr(rec, "mouse_y", None)
        if mx_ is not None and my_ is not None:
            self.widget.hover(self.quads, mx_, my_)
            if getattr(rec, "mouse_click", False):
                consumed = self.widget.click(self.quads, mx_, my_) or consumed
        self.quads = ui_layout(self.widget.uies, self.width, self.height)
        return consumed

    def compose(self, frame):
        return ui_compose(frame, self.quads)
