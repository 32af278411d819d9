"""In-engine scene editor (counterpart of clap_tpu/scene/editor.py;
reference: core/scene.c:174-304 — the debug scene editor that live-edits
entity transforms — feeding scene_save, scene.c:1891-1922, which
re-serializes the retained JSON DOM).

Edits are pure functions on the EngineState (entity pos/rot/scale/visible
plus the rebuilt world matrix of that slot); selection, mode and step
live host-side in the editor object, and ``save`` writes the live state
back through the retained DOM. The state may be the unbatched template
(E, ...) or a batched state (B, E, ...): an edit then applies to every
env. Input routing mirrors the reference's debug-UI key navigation: the
editor consumes InputRecords when active, Tab cycles the selected entity,
arrows nudge along the active axes, enter cycles the mode (move → rotate
→ scale → visibility), space toggles visibility in visibility mode.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import mathx as mx

MODES = ("move", "rotate", "scale", "visibility")


def _slot(state, ei: int):
    """Index of entity slot ``ei`` in every env of ``state``."""
    return (slice(None), ei) if state.pos.dim() == 3 else (ei,)


def _put(x, idx, v):
    out = x.clone()
    out[idx] = v
    return out


def edit_entity(state, ei: int, pos=None, rot=None, scale=None,
                visible=None):
    """Pure edit: replace an entity slot's TRS/visibility and rebuild
    its world matrix (default_update's TRS rebuild, model.c:1670-1676,
    applied to one slot). ``pos`` / ``rot`` / ``scale`` / ``visible``:
    numbers, sequences or tensors (per env on a batched state)."""
    idx = _slot(state, ei)
    dev = state.pos.device

    def f32(x):
        return torch.as_tensor(x, device=dev).to(torch.float32)

    p = state.pos[idx] if pos is None else f32(pos).expand_as(state.pos[idx])
    q = state.rot[idx] if rot is None else f32(rot).expand_as(state.rot[idx])
    s = state.scale[idx] if scale is None \
        else f32(scale).expand_as(state.scale[idx])
    st = state._replace(pos=_put(state.pos, idx, p),
                        rot=_put(state.rot, idx, q),
                        scale=_put(state.scale, idx, s),
                        mx=_put(state.mx, idx, mx.mat4_compose_trs(p, q, s)))
    if visible is not None:
        v = torch.as_tensor(visible, device=dev).to(torch.bool)
        st = st._replace(visible=_put(st.visible, idx, v))
    return st


@dataclass
class SceneEditor:
    """Host-side editor session over a LoadedScene + live EngineState."""

    scene: object                    # loader.LoadedScene
    sel: int = 0
    mode_idx: int = 0
    step: float = 0.25
    rot_step: float = np.pi / 12.0
    active: bool = False
    dirty: set = field(default_factory=set)   # edited entity slots

    @property
    def mode(self) -> str:
        return MODES[self.mode_idx]

    @property
    def selected_name(self) -> str:
        names = self.scene.entity_names
        return names[self.sel] if self.sel < len(names) else f"#{self.sel}"

    def select_next(self, delta: int = 1) -> None:
        n = max(len(self.scene.entity_names), 1)
        self.sel = (self.sel + delta) % n

    def nudge(self, state, dx=0.0, dy=0.0, dz=0.0):
        d = torch.tensor([dx, dy, dz], dtype=torch.float32,
                         device=state.pos.device)
        self.dirty.add(self.sel)
        return edit_entity(state, self.sel,
                           pos=state.pos[_slot(state, self.sel)] + d)

    def rotate_yaw(self, state, dyaw: float):
        dev = state.pos.device
        dq = mx.quat_from_axis_angle(mx.const([0.0, 1.0, 0.0], dev),
                                     torch.tensor(dyaw, dtype=torch.float32,
                                                  device=dev))
        q = mx.qmul(dq, state.rot[_slot(state, self.sel)])
        self.dirty.add(self.sel)
        return edit_entity(state, self.sel, rot=q)

    def rescale(self, state, factor: float):
        # the product in double, rounded once, as float(scale) * factor
        s = state.scale[_slot(state, self.sel)].double() * factor
        self.dirty.add(self.sel)
        return edit_entity(state, self.sel, scale=s.float())

    def toggle_visible(self, state):
        self.dirty.add(self.sel)
        return edit_entity(state, self.sel,
                           visible=~state.visible[_slot(state, self.sel)])

    def handle_input(self, rec, state):
        """Route one InputRecord. Returns (state, consumed)."""
        if getattr(rec, "edit_toggle", False):
            self.active = not self.active
            return state, True
        if not self.active:
            return state, False
        if getattr(rec, "tab", False):
            self.select_next(-1 if getattr(rec, "shift", False) else 1)
            return state, True
        if getattr(rec, "enter", False):
            self.mode_idx = (self.mode_idx + 1) % len(MODES)
            return state, True
        m = self.mode
        dx = (1 if getattr(rec, "right", False) else 0) \
            - (1 if getattr(rec, "left", False) else 0)
        dz = (1 if getattr(rec, "down", False) else 0) \
            - (1 if getattr(rec, "up", False) else 0)
        dy = (1 if getattr(rec, "pitch_up", False) else 0) \
            - (1 if getattr(rec, "pitch_down", False) else 0)
        if m == "move" and (dx or dy or dz):
            return self.nudge(state, dx * self.step, dy * self.step,
                              dz * self.step), True
        if m == "rotate" and dx:
            return self.rotate_yaw(state, dx * self.rot_step), True
        if m == "scale" and dx:
            return self.rescale(state, 1.25 if dx > 0 else 0.8), True
        if m == "visibility" and getattr(rec, "space", False):
            return self.toggle_visible(state), True
        return state, False

    def status(self) -> dict:
        """Debug-UI panel payload (the editor's on-screen readout)."""
        return {"sel": f"{self.sel}:{self.selected_name}",
                "mode": self.mode, "step": self.step,
                "edited": len(self.dirty)}

    def save(self, state, env: int = 0) -> str:
        """scene_save with the live state of env ``env`` (of a batched
        state) written back: position, rotation and scale (the reference
        also only serializes transforms)."""
        if state.pos.dim() == 3:
            pos, rot, scl = (state.pos[env], state.rot[env],
                             state.scale[env])
        else:
            pos, rot, scl = state.pos, state.rot, state.scale
        pos, rot, scl = (x.detach().cpu().numpy() for x in (pos, rot, scl))
        doc = json.loads(json.dumps(self.scene.doc))
        ei = 0
        for mentry in doc.get("model", []):
            for key in ("entity", "character"):
                for e in mentry.get(key, []):
                    if ei < pos.shape[0]:
                        e["position"] = [float(x) for x in pos[ei]]
                        e["rotation"] = [float(x) for x in rot[ei]]
                        e["scale"] = float(scl[ei])
                    ei += 1
        return json.dumps(doc, indent=2)
