"""Carry state and tables between the JAX package and the port.

``from_numpy`` turns a JAX-package NamedTuple tree whose leaves are numpy
arrays (for example ``jax.tree.map(np.asarray, tb.state0)``) into the
port's NamedTuple of the same type name, with torch tensors on
``device``. ``to_numpy`` goes the other way: the port's types with numpy
leaves. Plain tuples and lists (the static-shadow triple) convert element
by element; ``None`` stays ``None``.

This module imports no JAX: the trees arrive as numpy already.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .anim.clips import AnimLibrary, Pose
from .anim.joints import Skeleton
from .anim.queue import AnimQueue
from .anim.system import AnimConfig, AnimInstance, AnimSfx
from .char.controller import CharParams, CharState
from .device import resolve_device
from .engine.game import GameSessionState, GameWorld
from .engine.gamelogic import GameConfig, GameState
from .engine.state import CameraState, EngineState, EntityParams, SceneConfig
from .engine.step import Inputs
from .ops.particles import ParticleParams
from .physics.heightfield import Heightfield
from .physics.narrowphase import StaticWorld
from .physics.world import BodyParams, PhysState
from .render.lights import Lights
from .render.pipeline import TextureSets
from .render.scenerender import RenderTables

_TYPES = {cls.__name__: cls for cls in (
    SceneConfig, EngineState, EntityParams, CameraState, StaticWorld,
    Heightfield, BodyParams, PhysState, CharParams, CharState, Inputs,
    RenderTables, Lights, AnimLibrary, Pose, Skeleton, AnimQueue,
    AnimConfig, AnimInstance, AnimSfx, GameConfig, GameState, ParticleParams,
    GameWorld, GameSessionState, TextureSets)}

# host-side (trace-time) flags that stay Python bools in the port
_PY_BOOL_FIELDS = {"any_material", "flat_eligible", "camera_occlusion"}


def _scene_host(tree):
    from .engine.state import scene_host

    return scene_host(tree.bodies, tree.char_params.body)


# port-only trailing fields (host-side, after the JAX package's fields) and
# how the bridge fills them from the JAX package's numpy tree
_PORT_ONLY = {("SceneConfig", "host"): _scene_host}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every non-None leaf of a NamedTuple/tuple/list/dict
    tree; host-side dataclasses (SceneHost) stay as they are. With
    ``rest``, trees of the same structure, ``fn`` takes the leaf and the
    leaves at the same place in each of them."""
    if tree is None or dataclasses.is_dataclass(tree):
        return tree
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree``, in ``tree_map``'s order (dicts by
    insertion); None, host values and dataclasses are passed over."""
    out = []
    tree_map(lambda x: out.append(x) if isinstance(x, torch.Tensor)
             else None, tree)
    return out


def _convert_node(tree, leaf):
    if tree is None or dataclasses.is_dataclass(tree):
        return tree
    if _is_namedtuple(tree):
        name = type(tree).__name__
        cls = _TYPES.get(name)
        if cls is None:
            raise TypeError(f"no port type named {name}")
        n = len(tree._fields)
        extra = cls._fields[n:]
        if tuple(cls._fields[:n]) != tuple(tree._fields) or any(
                (name, f) not in _PORT_ONLY for f in extra):
            raise TypeError(f"{name}: fields {tree._fields} do not match "
                            f"the port's {cls._fields}")
        vals = []
        for f, x in zip(tree._fields, tree):
            if f in _PY_BOOL_FIELDS and x is not None:
                vals.append(bool(np.asarray(x)))
            else:
                vals.append(_convert_node(x, leaf))
        vals += [_PORT_ONLY[(name, f)](tree) for f in extra]
        return cls(*vals)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_convert_node(x, leaf) for x in tree)
    return leaf(tree)


def from_numpy(tree, device=None):
    """JAX-package tree (numpy leaves) → port tree (torch leaves) on
    ``device``, the card unless named."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, (bool, int, float)):
            return x
        return torch.as_tensor(np.array(x), device=device)

    return _convert_node(tree, leaf)


def scene_parts_from_numpy(parts: dict, device=None) -> dict:
    """A JAX-package LoadedScene's pieces → the port's, on ``device`` (the
    card unless named): ``parts`` maps names to numpy trees (``cfg``,
    ``state0``, ``lights``, ``game``) or to a dict of arrays (the
    ``char_armature()`` arrays), which become tensors."""
    device = resolve_device(device)
    return {k: {n: torch.as_tensor(np.array(x), device=device)
                for n, x in v.items()} if isinstance(v, dict)
            else from_numpy(v, device) for k, v in parts.items()}


def to_numpy(tree):
    """Port tree (torch leaves) → port tree with numpy leaves."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return _convert_node(tree, leaf)
