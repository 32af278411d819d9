"""UI animations (counterpart of clap_tpu/render/ui_anim.py; reference:
core/ui-animations.c — eased move/fade effects on UI elements).

Host-side easing timelines applied to UiElements before layout; the
reference's animation kinds (slide in/out, fade, bounce) map to easing
functions over a normalized t in [0, 1].
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable


def ease_linear(t: float) -> float:
    return t


def ease_in_out(t: float) -> float:
    return t * t * (3 - 2 * t)


def ease_out_bounce(t: float) -> float:
    n1, d1 = 7.5625, 2.75
    if t < 1 / d1:
        return n1 * t * t
    if t < 2 / d1:
        t -= 1.5 / d1
        return n1 * t * t + 0.75
    if t < 2.5 / d1:
        t -= 2.25 / d1
        return n1 * t * t + 0.9375
    t -= 2.625 / d1
    return n1 * t * t + 0.984375


def ease_out_elastic(t: float) -> float:
    if t in (0.0, 1.0):
        return t
    c4 = (2 * math.pi) / 3
    return math.pow(2, -10 * t) * math.sin((t * 10 - 0.75) * c4) + 1


EASINGS = {
    "linear": ease_linear,
    "in_out": ease_in_out,
    "bounce": ease_out_bounce,
    "elastic": ease_out_elastic,
}


@dataclass
class UiAnimation:
    """Animates one UiElement attribute from a to b over ``duration``."""

    element: object                 # UiElement
    attr: str                       # "x", "y", "w", "h" or "alpha"
    start: float
    end: float
    duration: float
    easing: str = "in_out"
    t: float = 0.0
    done: bool = False
    on_done: Callable | None = None

    def step(self, dt: float) -> None:
        if self.done:
            return
        self.t = min(self.t + dt / max(self.duration, 1e-6), 1.0)
        v = self.start + (self.end - self.start) * EASINGS[self.easing](self.t)
        if self.attr == "alpha":
            c = self.element.color
            self.element.color = (c[0], c[1], c[2], v)
        else:
            setattr(self.element, self.attr, v)
        if self.t >= 1.0:
            self.done = True
            if self.on_done:
                self.on_done(self)


@dataclass
class UiAnimator:
    anims: list = field(default_factory=list)

    def add(self, anim: UiAnimation) -> UiAnimation:
        self.anims.append(anim)
        return anim

    def slide_in(self, el, from_y: float, to_y: float, duration=0.4,
                 easing="bounce"):
        return self.add(UiAnimation(el, "y", from_y, to_y, duration, easing))

    def fade(self, el, from_a: float, to_a: float, duration=0.3):
        return self.add(UiAnimation(el, "alpha", from_a, to_a, duration))

    def step(self, dt: float) -> None:
        for a in self.anims:
            a.step(dt)
        self.anims = [a for a in self.anims if not a.done]
