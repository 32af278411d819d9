"""Simulation checkpoint/resume (counterpart of clap_tpu/utils/checkpoint.py;
SURVEY §5.4: the reference has none).

A state (EngineState, GameSessionState or any NamedTuple/tuple tree of
tensors) is one tree, so a full-state snapshot is a single save: its
tensor leaves, in order, as the arrays of one numpy ``.npz``. The JAX
package saves through orbax where it is installed; the port has only the
``.npz`` route.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bridge import tree_leaves, tree_map


def save_checkpoint(path: str, state) -> str:
    """Save the tensor leaves of ``state`` to ``path`` (``.npz`` added
    where missing); returns the file's path."""
    p = path if path.endswith(".npz") else path + ".npz"
    np.savez(p, *[x.detach().cpu().numpy() for x in tree_leaves(state)])
    return p


def load_checkpoint(path: str, template):
    """Restore into the structure of ``template``: each tensor leaf takes
    the template leaf's dtype and device; None leaves and host values
    (flags, dataclasses) come from the template."""
    p = path if path.endswith(".npz") else path + ".npz"
    with np.load(p) as data:
        arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
    n = len(tree_leaves(template))
    if n != len(arrays):
        raise ValueError(f"{p} holds {len(arrays)} arrays, the template "
                         f"{n} tensors")
    arrays = iter(arrays)

    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        return torch.as_tensor(next(arrays)).to(device=t.device,
                                                dtype=t.dtype)

    return tree_map(leaf, template)
