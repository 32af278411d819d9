"""Debug UI module registry (counterpart of clap_tpu/render/debugui.py;
reference: core/ui-debug.{c,h} + ui-imgui*.c — ImGui debug modules with
enable/unfold state persisted to settings, clap.c:545
ui_debug_set_settings).

Headless analogue: named modules contribute key/value panels rendered
through the quad/text UI layer (``render/ui.py``); enable state persists
via Settings. Host Python: a module's ``collect`` is called where the
panel is built or navigated, and the composite reads nothing back.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from .ui import AF, UiElement


@dataclass
class DebugModule:
    name: str
    collect: Callable[[], dict]    # returns key → value to display
    enabled: bool = False
    unfolded: bool = True


@dataclass
class DebugUI:
    settings: object = None        # utils.settings.Settings or None
    modules: dict = field(default_factory=dict)

    def register(self, name: str, collect: Callable[[], dict]) -> DebugModule:
        m = DebugModule(name=name, collect=collect)
        if self.settings is not None:
            m.enabled = bool(self.settings.get(f"debug.{name}.enabled", False))
            m.unfolded = bool(self.settings.get(f"debug.{name}.unfolded", True))
        self.modules[name] = m
        return m

    def toggle(self, name: str, enabled: bool | None = None) -> None:
        m = self.modules[name]
        m.enabled = (not m.enabled) if enabled is None else enabled
        if self.settings is not None:
            self.settings.set(f"debug.{name}.enabled", m.enabled)

    def build_elements(self) -> list:
        """UI elements for all enabled modules (one panel per module,
        stacked down the left edge like the reference's debug column)."""
        els = []
        yoff = 8.0
        for m in self.modules.values():
            if not m.enabled:
                continue
            lines = [m.name.upper()]
            if m.unfolded:
                for k, v in m.collect().items():
                    if isinstance(v, float):
                        v = round(v, 3)
                    lines.append(f"{k}: {v}")
            for li, line in enumerate(lines):
                els.append(UiElement(text=line, text_scale=1,
                                     affinity=AF.LEFT | AF.TOP,
                                     x=8, y=yoff,
                                     color=(0.05, 0.05, 0.1, 0.5)))
                yoff += 16.0
            yoff += 8.0
        return els


@dataclass
class Adjustable:
    """One tweakable debug value (the ImGui slider/checkbox analogue:
    ui-imgui widgets mutate render_options/scene params in place)."""

    get: Callable[[], object]
    set: Callable[[object], None]
    step: float = 0.1


class InteractiveDebugUI(DebugUI):
    """Rendered, navigable debug panels (ui-imgui*.c's role): the panel
    column composites over the frame through the quad/text UI; focus
    moves with up/down input records, enter folds/unfolds the focused
    module, left/right adjust the focused Adjustable value. Enable and
    unfold state persist through Settings exactly like
    ui_debug_set_settings (clap.c:545)."""

    def __init__(self, settings=None, width: int = 640, height: int = 360,
                 font=None):
        super().__init__(settings=settings)
        self.width = width
        self.height = height
        self.font = font
        self.adjust: dict = {}        # (module, key) → Adjustable
        self.focus = 0                # index into visible rows
        self.visible = False
        self._rows = []               # (module, key|None) per rendered row

    def register_adjustable(self, module: str, key: str,
                            adj: Adjustable) -> None:
        self.adjust[(module, key)] = adj

    def _collect_rows(self):
        rows = []
        for m in self.modules.values():
            if not m.enabled:
                continue
            rows.append((m, None))                      # header row
            if m.unfolded:
                for k, v in m.collect().items():
                    rows.append((m, (k, v)))
                for (mod, k), adj in self.adjust.items():
                    if mod == m.name:
                        rows.append((m, (k, adj.get())))
        return rows

    def handle_input(self, rec) -> bool:
        """Route a message_input record; True when consumed."""
        if getattr(rec, "menu_toggle", False):
            self.visible = not self.visible
            return True
        if not self.visible:
            return False
        rows = self._collect_rows()
        if not rows:
            return False
        consumed = False
        if getattr(rec, "down", False):
            self.focus = (self.focus + 1) % len(rows)
            consumed = True
        if getattr(rec, "up", False):
            self.focus = (self.focus - 1) % len(rows)
            consumed = True
        self.focus = min(self.focus, len(rows) - 1)
        m, payload = rows[self.focus]
        if getattr(rec, "enter", False) or getattr(rec, "space", False):
            if payload is None:                         # header: fold
                m.unfolded = not m.unfolded
                if self.settings is not None:
                    self.settings.set(f"debug.{m.name}.unfolded",
                                      m.unfolded)
                consumed = True
        delta = (1 if getattr(rec, "right", False) else 0) \
            - (1 if getattr(rec, "left", False) else 0)
        if delta and payload is not None:
            adj = self.adjust.get((m.name, payload[0]))
            if adj is not None:
                cur = adj.get()
                if isinstance(cur, bool):
                    adj.set(not cur)
                else:
                    adj.set(type(cur)(cur + delta * adj.step))
                consumed = True
        return consumed

    def build_elements(self) -> list:
        """Panel column with the focused row highlighted."""
        if not self.visible:
            return []
        els = []
        yoff = 8.0
        for i, (m, payload) in enumerate(self._collect_rows()):
            if payload is None:
                text = ("- " if m.unfolded else "+ ") + m.name.upper()
            else:
                k, v = payload
                if isinstance(v, float):
                    v = round(v, 3)
                mark = "<>" if (m.name, k) in self.adjust else "  "
                text = f"{mark}{k}: {v}"
            els.append(UiElement(
                text=text, text_scale=1, affinity=AF.LEFT | AF.TOP,
                x=8, y=yoff, font=self.font, focused=(i == self.focus),
                color=(0.05, 0.05, 0.1, 0.5),
                focus_color=(0.35, 0.3, 0.05, 0.75)))
            yoff += 18.0
        return els

    def compose(self, frame):
        from .ui import ui_compose, ui_layout

        return ui_compose(frame, ui_layout(
            self.build_elements(), self.width, self.height))


def standard_modules(dui: DebugUI, engine) -> None:
    """Register the reference's stock debug modules (scene/camera/
    physics/memory counters — scene.c:174-391, clap.c:652-657) over the
    port's ``Engine``, whose state is a 1-env batch: the physics panel
    gives env 0's body count and reads its first body's height, the
    panel's one device read, made only when the panel collects."""
    dui.register("fps", lambda: engine.profiler.report())
    dui.register("frame", lambda: {"frame": engine.frame_no})

    def phys():
        p = engine.state.phys.pos                 # (1, N, 3)
        n = p.shape[1]
        return {"bodies": n, "char_y": float(p[0, 0, 1]) if n else 0.0}

    dui.register("physics", phys)
