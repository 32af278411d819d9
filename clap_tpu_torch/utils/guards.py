"""Numeric guards + error containment (counterpart of
clap_tpu/utils/guards.py; the sanitizer/cerr analogue, SURVEY §5.2/§5.3).

The reference leans on ASan/UBSan builds (CMakeLists.txt:17-18) and
cerr-style degrade-and-continue (pipeline failure masks, clap.c:627-648).
The tensor analogue is FINITENESS: a NaN/Inf that enters the state tree
silently poisons every later frame, and in a 4096-env batch one bad env
must not take down the other 4095. This module provides:

- ``finite_mask(tree)``: per-env validity over a batched state tree.
- ``quarantine(tree, reset_tree)``: per-env degrade-and-continue — bad
  envs reset to a known-good state, healthy envs untouched (no host read;
  safe to call every frame).
- ``assert_finite(tree)``: host-side watchdog for the Engine loop's
  1 Hz status tick; names the first offending leaf (the abort-on-error
  `-E` CLI path, clap.c:909-915). One reduction over every floating leaf
  on the device and one host read; the leaves are searched one by one
  only when that read says a value is bad.

A tree is a NamedTuple, tuple, list or dict of tensors; None leaves and
non-tensor leaves (host ints, flags, dataclasses) are passed over.
"""
from __future__ import annotations

import torch

from ..bridge import tree_leaves, tree_map


def _leaf_bad(x, env_axis):
    if not x.dtype.is_floating_point:
        return None
    bad = ~torch.isfinite(x)
    axes = tuple(a for a in range(x.ndim) if a != env_axis)
    return bad.any(dim=axes) if axes else bad


def finite_mask(tree, env_axis: int = 0):
    """(N,) bool: True where the env's state is entirely finite."""
    bads = [b for b in (_leaf_bad(x, env_axis) for x in tree_leaves(tree))
            if b is not None]
    bad = bads[0]
    for b in bads[1:]:
        bad = bad | b
    return ~bad


def quarantine(tree, reset_tree, env_axis: int = 0):
    """Reset non-finite envs to ``reset_tree`` (broadcast or batched).

    Returns (tree', ok_mask). The healthy envs pass through bit-exactly;
    this is the per-env pipeline-failure mask of clap.c:627-648 applied
    to simulation state."""
    ok = finite_mask(tree, env_axis)

    def fix(x, r):
        if not isinstance(x, torch.Tensor):
            return x
        r = r.expand(x.shape) if r.ndim < x.ndim else r
        shape = [1] * x.ndim
        shape[env_axis] = ok.shape[0]
        return torch.where(ok.reshape(shape), x, r.to(x.dtype))

    return tree_map(fix, tree, reset_tree), ok


def assert_finite(tree, name: str = "state"):
    """Host-side check; raises FloatingPointError naming the first bad
    leaf (its index among the tree's leaves, as the JAX package counts
    them: every tensor leaf, floating or not). One device reduction and
    one host read when the tree is finite."""
    leaves = tree_leaves(tree)
    floats = [x for x in leaves if x.dtype.is_floating_point]
    if not floats:
        return
    bad = torch.stack([(~torch.isfinite(x)).any() for x in floats]).any()
    if not bool(bad):                                  # the one host read
        return
    for i, leaf in enumerate(leaves):
        if leaf.dtype.is_floating_point and not bool(
                torch.isfinite(leaf).all()):
            raise FloatingPointError(
                f"non-finite values in {name} leaf #{i} "
                f"(shape {tuple(leaf.shape)})")

