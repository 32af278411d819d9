"""Light state + tiled light culling (counterpart of
clap_tpu/render/lights.py; reference: core/light.{c,h}).

SoA tensors for the scene's lights, shared by every env. ``light_grid``
projects each light's sphere to screen per env and marks the 64-px tiles
its radius touches (light_grid_compute light.c:88-153).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

LIGHT_TILE = 64


class Lights(NamedTuple):
    """(L,) SoA light tensors; L is the scene's static light capacity."""

    pos: torch.Tensor        # (L, 3)
    color: torch.Tensor      # (L, 3)
    attenuation: torch.Tensor  # (L, 3) constant, linear, quadratic
    direction: torch.Tensor  # (L, 3) for directional/spot
    cutoff: torch.Tensor     # (L,) cos inner cutoff; <=-1 → point light
    is_dir: torch.Tensor     # (L,) bool directional
    active: torch.Tensor     # (L,) bool


def lights_empty(n: int = 8, device=None) -> Lights:
    device = resolve_device(device)
    z3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    return Lights(
        pos=z3, color=z3.clone(),
        attenuation=torch.tensor([1.0, 0.0, 0.0], device=device).repeat(n, 1),
        direction=z3.clone(),
        cutoff=torch.full((n,), -2.0, dtype=torch.float32, device=device),
        is_dir=torch.zeros((n,), dtype=torch.bool, device=device),
        active=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def light_radius(lights: Lights, eps: float = 0.02):
    """Effective radius where attenuation drops below eps."""
    kc, kl, kq = (lights.attenuation[:, i] for i in range(3))
    inv_eps = 1.0 / eps
    disc = torch.clamp(kl * kl - 4 * kq * (kc - inv_eps), min=0.0)
    d_quad = (-kl + torch.sqrt(disc)) / torch.clamp(2 * kq, min=1e-9)
    d_lin = (inv_eps - kc) / torch.clamp(kl, min=1e-9)
    r = torch.where(kq > 1e-9, d_quad, torch.where(kl > 1e-9, d_lin, 1e4))
    return torch.where(lights.is_dir, 1e9, r)


def light_grid(lights: Lights, view, proj, width: int, height: int):
    """Per-tile light masks for every env: view (B, 4, 4), proj (4, 4).

    Returns (B, n_ty, n_tx, L) bool."""
    ntx = -(-width // LIGHT_TILE)
    nty = -(-height // LIGHT_TILE)
    L = lights.pos.shape[0]
    dev = view.device

    vpos = (view[:, None, :3, :3] @ lights.pos[None, :, :, None])[..., 0] \
        + view[:, None, :3, 3]                               # (B, L, 3)
    r = light_radius(lights)
    v4 = torch.cat([vpos, torch.ones_like(vpos[..., :1])], dim=-1)
    clip = (proj @ v4[..., None])[..., 0]                     # (B, L, 4)
    w = clip[..., 3]
    behind = w <= 1e-6
    ndc = clip[..., :2] / torch.where(behind, 1.0, w)[..., None]
    cx = (ndc[..., 0] * 0.5 + 0.5) * width
    cy = (0.5 - ndc[..., 1] * 0.5) * height
    sr = r * proj[0, 0] / torch.clamp(-vpos[..., 2], min=1e-3) * (width / 2)

    tx = (torch.arange(ntx, device=dev) + 0.5) * LIGHT_TILE
    ty = (torch.arange(nty, device=dev) + 0.5) * LIGHT_TILE
    dx = torch.abs(tx[None, None, None, :] - cx[..., None, None])
    dy = torch.abs(ty[None, None, :, None] - cy[..., None, None])
    half = LIGHT_TILE * 0.7072
    dist2 = torch.clamp(dx - half, min=0) ** 2 \
        + torch.clamp(dy - half, min=0) ** 2
    in_tile = dist2 <= (sr[..., None, None] ** 2)              # (B,L,ty,tx)
    act = lights.active[None, :, None, None]
    mask = torch.where(
        (lights.is_dir[None, :, None, None] | behind[..., None, None]) & act,
        True, in_tile & act & ~behind[..., None, None])
    mask = mask & act
    return mask.permute(0, 2, 3, 1)                           # (B,ty,tx,L)
