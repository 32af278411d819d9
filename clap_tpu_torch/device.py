"""The device a public builder of the port makes its tensors on.

The port runs on the CUDA card unless the caller asks for another device:
``resolve_device(None)`` is ``cuda``. On a machine without a card that
choice stands, so the builder fails where it makes its first tensor and
never builds on the CPU unasked. Pass ``device="cpu"`` for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` for ``None``; any other device (name, index or
    ``torch.device``) as ``torch.device`` of it."""
    return torch.device("cuda") if device is None else torch.device(device)
