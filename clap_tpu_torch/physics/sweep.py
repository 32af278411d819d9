"""Swept-capsule queries (counterpart of clap_tpu/physics/sweep.py;
phys_body_sweep_capsule, physics.c:559-670).

The reference marches a probe capsule along the movement delta in steps of
≤ radius/2. Here all MAX_SWEEP_STEPS probe positions are evaluated at once
and the C early break (physics.c:655-656 stops once best_frac < t) is
replicated with a prefix-min over the probe axis — a fixed-trip masked
march, batched over envs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import mathx as mx
from .heightfield import SWEEP_PATCH, hf_patch
from .narrowphase import StaticWorld, capsule_world_contacts
from .shapes import closest_pt_segment_segment
from .world import BodyParams, capsule_segment

MAX_SWEEP_STEPS = 4
SWEEP_NDOT_CUTOFF = -0.1
SWEEP_HF_SAMPLES = 5
INF = float("inf")


class SweepResult(NamedTuple):
    frac: torch.Tensor       # (B,) fraction of delta safely travelable
    normal: torch.Tensor     # (B, 3) contact normal (obstacle → body)
    hit: torch.Tensor        # (B,) bool: anything hit
    hit_body: torch.Tensor   # (B,) int32: body index hit, -1 if static/none


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def sweep_capsule(world: StaticWorld, params: BodyParams, body_pos,
                  self_idx: int, delta,
                  max_steps: int = MAX_SWEEP_STEPS) -> SweepResult:
    """Sweep body ``self_idx``'s capsule along ``delta`` (B, 3) in every
    env. body_pos is the (B, N, 3) geom-center array; the probe starts at
    body_pos[:, self_idx]."""
    dev = body_pos.device
    radius = params.radius[self_idx]
    half_len = params.half_len[self_idx]
    start = body_pos[:, self_idx]
    delta_len = _norm(delta)                                   # (B,)
    direc = delta / torch.clamp(delta_len, min=1e-9)[:, None]

    nsteps = torch.clamp(
        torch.ceil(delta_len / torch.clamp(radius * 0.5, min=1e-6)
                   ).to(torch.int32), 2, max_steps)
    s = torch.arange(1, max_steps + 1, device=dev)
    ts = s.float()[None, :] / nsteps.float()[:, None]          # (B, S)
    live = s[None, :] <= nsteps[:, None]

    probe_pos = start[:, None, :] + delta[:, None, :] * ts[..., None]

    # one heightfield patch serves every probe and sample of a sweep
    mid = start + 0.5 * delta
    patch = hf_patch(world.hf, mid[:, 0], mid[:, 2], SWEEP_PATCH)

    p0, p1 = capsule_segment(probe_pos, half_len)              # (B, S, 3)
    c = capsule_world_contacts(world, p0, p1, radius, SWEEP_HF_SAMPLES,
                               patch=patch)
    sdep, snrm = c.depth, c.normal                             # (B, S, Ks)

    n_bodies = body_pos.shape[1]
    q0, q1 = capsule_segment(body_pos, params.half_len)
    ci, cj = closest_pt_segment_segment(p0[:, :, None], p1[:, :, None],
                                        q0[:, None], q1[:, None])
    diff = ci - cj
    dist = _norm(diff)                                         # (B, S, N)
    up = mx.const([0.0, 1.0, 0.0], dev)
    bnrm = torch.where((dist > 1e-9)[..., None],
                       diff / torch.clamp(dist, min=1e-9)[..., None], up)
    depth = radius + params.radius - dist
    ok = params.active & (torch.arange(n_bodies, device=dev) != self_idx)
    bdep = torch.where(ok, depth, -INF)

    def frac_of(depth, normal):
        ndot = torch.sum(direc[:, None, None, :] * normal, dim=-1)
        blocking = (depth > 0) & (ndot <= SWEEP_NDOT_CUTOFF) \
            & live[..., None]
        backup = depth / torch.clamp(-ndot, min=1e-6)
        safe = torch.clamp((ts * delta_len[:, None])[..., None] - backup,
                           min=0.0)
        return torch.where(blocking,
                           safe / torch.clamp(delta_len, min=1e-9
                                              )[:, None, None], INF)

    frac_s = frac_of(sdep, snrm)                               # (B, S, Ks)
    frac_b = frac_of(bdep, bnrm)                               # (B, S, N)

    step_min = torch.minimum(torch.amin(frac_s, dim=2),
                             torch.amin(frac_b, dim=2))        # (B, S)
    run_min = torch.cummin(step_min, dim=1).values
    stopped_before = torch.cat(
        [torch.zeros_like(live[:, :1]), (run_min < ts)[:, :-1]], dim=1)
    examined = ~torch.cumsum(stopped_before.int(), dim=1).bool()
    best_frac = torch.amin(torch.where(examined, step_min, INF), dim=1)
    hit = torch.isfinite(best_frac)

    def first_match(frac):
        m = (frac == best_frac[:, None, None]) & examined[..., None]
        flat = m.reshape(m.shape[0], -1)
        first = flat & (torch.cumsum(flat.int(), dim=1) == 1)
        return first.reshape(m.shape).float()

    m_s = first_match(frac_s)
    m_b = first_match(frac_b)
    s_won = m_s.sum(dim=(1, 2)) >= m_b.sum(dim=(1, 2))
    m_s = m_s * s_won[:, None, None]
    m_b = m_b * ~s_won[:, None, None]
    best_n = torch.sum(m_s[..., None] * snrm, dim=(1, 2)) \
        + torch.sum(m_b[..., None] * bnrm, dim=(1, 2))
    body_ids = torch.arange(n_bodies, device=dev, dtype=torch.float32)
    best_src = torch.where(s_won, -1.0,
                           torch.sum(m_b * body_ids, dim=(1, 2))
                           ).to(torch.int32)

    frac_out = torch.where(hit, best_frac, 1.0)
    frac_out = torch.where(delta_len < 1e-6, 1.0, frac_out)
    return SweepResult(
        frac=frac_out,
        normal=torch.where(hit[:, None], best_n, up),
        hit=hit & (delta_len >= 1e-6),
        hit_body=torch.where(hit, best_src, -1).to(torch.int32),
    )
