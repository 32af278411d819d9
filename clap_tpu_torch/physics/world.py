"""Batched rigid-body world (counterpart of clap_tpu/physics/world.py;
replaces ODE world + spaces, physics.c).

One fixed-capacity SoA body array per env; every per-env tensor carries a
leading env axis ``B`` (pos (B, N, 3)), and the body parameters are shared
(N,) tensors. All bodies are capsules (sphere = zero-length capsule);
characters are kinematic capsules moved by the controller.

Semantics replicated from the JAX package: gravity (0, -9.8, 0), linear
damping 1e-3, fixed 120 Hz substepping (≤ max_substeps per frame,
accumulator reset at the cap), penetration push-out before a λ-based
sequential-impulse solve over static contact slots plus one Jacobi pass
over the i<j body-pair list per solver pass, Coulomb friction, and
auto-disable at rest.

The JAX package selects per-pair body rows and scatters pair impulses
back with one-hot matmuls (a TPU gather workaround); here they are
indexing and ``index_add``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import mathx as mx
from ..device import resolve_device
from .narrowphase import StaticWorld, capsule_world_contacts
from .shapes import closest_pt_segment_segment

FIXED_DT = 1.0 / 120.0
MAX_SUBSTEPS = 5
GRAVITY = (0.0, -9.8, 0.0)
LINEAR_DAMPING = 1e-3
AUTO_DISABLE_VEL = 0.05
AUTO_DISABLE_ANGVEL = 0.25
AUTO_DISABLE_STEPS = 30
N_SOLVER_PASSES = 4
CONTACT_MARGIN = 1e-3
INF = float("inf")


class BodyParams(NamedTuple):
    """Static per-body-slot parameters, (N,) tensors shared by all envs."""

    active: torch.Tensor      # bool: slot used
    kinematic: torch.Tensor   # bool: character (controller-driven)
    radius: torch.Tensor      # f32
    half_len: torch.Tensor    # f32 capsule segment half-length (0 → sphere)
    yoffset: torch.Tensor     # f32 geom center above entity origin
    ray_off: torch.Tensor     # f32 ground-ray origin offset (r + length/2)
    mass: torch.Tensor        # f32
    bounce: torch.Tensor      # f32
    bounce_vel: torch.Tensor  # f32
    mu: torch.Tensor          # f32
    inertia: torch.Tensor = None  # (N, 3) body-frame principal inertia


class PhysState(NamedTuple):
    """Dynamic per-env physics state (leading env axis B)."""

    pos: torch.Tensor        # (B, N, 3) geom centers
    vel: torch.Tensor        # (B, N, 3)
    quat: torch.Tensor       # (B, N, 4) body orientation (x, y, z, w)
    angvel: torch.Tensor     # (B, N, 3) world-frame angular velocity
    time_acc: torch.Tensor   # (B,) accumulator
    disable_count: torch.Tensor  # (B, N) int32 steps below threshold
    disabled: torch.Tensor   # (B, N) bool at-rest


def capsule_inertia_np(mass, radius, half_len):
    """Principal inertia of a solid capsule about its center (y = long
    axis), dMassSetCapsuleTotal (ODE mass.cpp). numpy float32 in and out
    (host-side scene building); returns (..., 3) [Ixx, Iyy, Izz]. The
    float32 operation order is the JAX package's, so the result is
    bit-identical."""
    f = np.float32
    r = np.maximum(np.asarray(radius, f), f(1e-6))
    L = f(2.0) * np.asarray(half_len, f)
    v_cyl = f(math.pi) * r * r * L
    v_sph = f((4.0 / 3.0) * math.pi) * (r * r * r)
    rho = np.asarray(mass, f) / np.maximum(v_cyl + v_sph, f(1e-12))
    m_c = rho * v_cyl
    m_s = rho * v_sph
    iyy = m_c * r * r / f(2.0) + m_s * f(2.0 / 5.0) * r * r
    ixx = m_c * (L * L / f(12.0) + r * r / f(4.0)) \
        + m_s * (f(2.0 / 5.0) * r * r + L * L / f(4.0)
                 + f(3.0 / 8.0) * L * r)
    return np.stack([ixx, iyy, ixx], axis=-1).astype(f)


def capsule_inertia(mass, radius, half_len):
    """``capsule_inertia_np`` on tensors (the JAX package's
    capsule_inertia): principal inertia (..., 3) [Ixx, Iyy, Izz] of solid
    capsules about their centres, y the long axis, in float32."""
    r = torch.clamp(radius, min=1e-6)
    L = 2.0 * half_len
    v_cyl = math.pi * r * r * L
    v_sph = (4.0 / 3.0) * math.pi * r ** 3
    rho = mass / torch.clamp(v_cyl + v_sph, min=1e-12)
    m_c = rho * v_cyl
    m_s = rho * v_sph
    iyy = m_c * r * r / 2.0 + m_s * (2.0 / 5.0) * r * r
    ixx = m_c * (L * L / 12.0 + r * r / 4.0) \
        + m_s * ((2.0 / 5.0) * r * r + L * L / 4.0 + (3.0 / 8.0) * L * r)
    return torch.stack([ixx, iyy, ixx], dim=-1)


def phys_state_init(n: int, device=None) -> PhysState:
    """Unbatched initial state of ``n`` bodies on ``device`` (the card
    unless named): at rest at the origin, identity orientation."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return PhysState(
        pos=torch.zeros(n, 3, **f32), vel=torch.zeros(n, 3, **f32),
        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], **f32).repeat(n, 1),
        angvel=torch.zeros(n, 3, **f32), time_acc=torch.zeros((), **f32),
        disable_count=torch.zeros(n, dtype=torch.int32, device=dev),
        disabled=torch.zeros(n, dtype=torch.bool, device=dev))


def body_params_empty(n: int) -> BodyParams:
    """``n`` empty body slots on the host: BodyParams of numpy arrays,
    filled by a scene builder and then moved to a device
    (``bridge.tree_map``)."""
    z = np.zeros(n, np.float32)
    return BodyParams(
        active=np.zeros(n, bool), kinematic=np.zeros(n, bool),
        radius=z.copy(), half_len=z.copy(), yoffset=z.copy(),
        ray_off=z.copy(), mass=np.ones(n, np.float32), bounce=z.copy(),
        bounce_vel=z.copy(), mu=np.ones(n, np.float32),
        inertia=np.ones((n, 3), np.float32))


def finalize_inertia(params: BodyParams) -> BodyParams:
    """Host BodyParams with each slot's inertia derived from its capsule
    geometry (after the slots' mass / radius / half_len are filled)."""
    return params._replace(inertia=capsule_inertia_np(
        params.mass, params.radius, params.half_len))


def capsule_auto_size(aabb_x: float, aabb_y: float, aabb_z: float,
                      geom_radius: float = 0.0, geom_offset: float = 0.0):
    """Upright auto-capsule from entity AABB (phys_geom_capsule_new,
    physics.c:814-880). Returns (radius, half_len, yoffset, ray_off)."""
    r = geom_radius if geom_radius else min(aabb_x, aabb_y, aabb_z) / 2
    length = max(aabb_y / 2 - r * 2, 0.0)
    yoffset = geom_offset if geom_offset else aabb_y / 2
    ray_off = r + length / 2
    return r, length / 2, yoffset, ray_off


def capsule_segment(pos, half_len, quat=None):
    """(p_bot, p_top) of the capsule segment for geom-center pos (..., 3);
    quat rotates the body-frame +y axis."""
    hl = torch.as_tensor(half_len, dtype=pos.dtype, device=pos.device)
    z = torch.zeros_like(pos[..., 0])
    up = torch.stack([z, z + hl, z], dim=-1)
    if quat is not None:
        up = mx.qrot(quat, up)
    return pos - up, pos + up


@dataclass(frozen=True)
class BodyFlags:
    """Static facts of a body set that pick the solver's code path, decided
    once on the host where the BodyParams are built (the JAX package
    resolves them at trace time from the same host arrays).

    two_ended: some dynamic body is a real capsule (its contacts must cover
    both segment ends); iso: every dynamic body is a sphere (isotropic
    inertia, the solver skips the 3×3 inertia work)."""

    two_ended: bool
    iso: bool


def body_flags(half_len, kinematic) -> BodyFlags:
    """BodyFlags of a body set from its host arrays: half_len (N,) and
    kinematic (N,) bool."""
    tumbling = np.asarray(half_len) * ~np.asarray(kinematic)
    return BodyFlags(two_ended=bool(np.any(tumbling > 0)),
                     iso=bool(np.all(tumbling == 0)))


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


# ---------------------------------------------------------------------------
# contact generation
# ---------------------------------------------------------------------------

def _body_patches(world: StaticWorld, pos, two_ended: bool):
    """Per-body heightfield corner patches, extracted once per frame."""
    from .heightfield import CONTACT_PATCH, hf_patch

    p = 8 if two_ended else CONTACT_PATCH
    return hf_patch(world.hf, pos[..., 0], pos[..., 2], p)


def _static_contacts(world: StaticWorld, params: BodyParams, pos, quat,
                     patches, two_ended: bool):
    """All static-world contact slots per body, duplicate planes masked to
    -inf keeping the deepest contact of each normal direction.

    Returns (depth (B, N, K), normal (B, N, K, 3), point (B, N, K, 3))."""
    p0, p1 = capsule_segment(pos, params.half_len, quat)
    c = capsule_world_contacts(world, p0, p1, params.radius, n_samples=5,
                               patch=patches, two_ended=two_ended)
    d, n = c.depth, c.normal
    K = d.shape[-1]
    dots = torch.einsum("...ic,...jc->...ij", n, n)
    same = dots > 0.995
    ar = torch.arange(K, device=d.device)
    deeper = (d[..., :, None] > d[..., None, :]) | (
        (d[..., :, None] == d[..., None, :])
        & (ar[:, None] < ar[None, :]))
    dup = (same & deeper).any(dim=-2)   # j loses to a deeper/earlier i
    return torch.where(dup, -INF, d), n, c.point


@functools.lru_cache(maxsize=None)
def _pair_indices(n: int, device=None):
    """Static i<j pair list: (I, J) long tensors of length n(n−1)/2, made
    once per (n, device)."""
    iu = np.triu_indices(n, k=1)
    return (torch.as_tensor(iu[0], dtype=torch.long, device=device),
            torch.as_tensor(iu[1], dtype=torch.long, device=device))


def _pair_contacts(params: BodyParams, pos, quat, I, J):
    """Capsule-capsule contacts for the i<j pair list. Returns (depth
    (B, P), normal (B, P, 3) from body J toward I, point (B, P, 3))."""
    p0, p1 = capsule_segment(pos, params.half_len, quat)
    ci, cj = closest_pt_segment_segment(p0[:, I], p1[:, I], p0[:, J],
                                        p1[:, J])
    diff = ci - cj
    dist = _norm(diff)
    normal = diff / torch.clamp(dist, min=1e-9)[..., None]
    up = mx.const([0.0, 1.0, 0.0], pos.device)
    normal = torch.where((dist > 1e-9)[..., None], normal, up)
    ri = params.radius[I]
    rj = params.radius[J]
    depth = ri + rj - dist
    point = 0.5 * ((ci - normal * ri[:, None]) + (cj + normal * rj[:, None]))
    ok = params.active[I] & params.active[J]
    return torch.where(ok, depth, -INF), normal, point


# ---------------------------------------------------------------------------
# substep
# ---------------------------------------------------------------------------

def _substep(world: StaticWorld, params: BodyParams, state: PhysState, dt,
             patches, two_ended: bool, iso: bool,
             solver_passes: int = N_SOLVER_PASSES) -> PhysState:
    """__phys_step (physics.c:746-771): collide → push-out → solve."""
    pos, vel = state.pos, state.vel
    quat, angvel = state.quat, state.angvel
    dev = pos.device
    B, n_b = pos.shape[:2]
    solve_mask = params.active & ~params.kinematic & ~state.disabled  # (B,N)

    inv_mass = torch.where(solve_mask, 1.0 / torch.clamp(params.mass,
                                                         min=1e-6), 0.0)
    inv_d = torch.where(solve_mask[..., None],
                        1.0 / torch.clamp(params.inertia, min=1e-9), 0.0)
    if iso:
        inv_i = inv_d[..., 0]                                # (B, N)

        def invI_apply(x):
            return x * inv_i[..., None]
    else:
        R = mx.mat3_from_quat(quat)                          # (B, N, 3, 3)
        inv_I = torch.einsum("bnac,bnc,bndc->bnad", R, inv_d, R)

        def invI_apply(x):
            return torch.einsum("bnac,bnc->bna", inv_I, x)

    # --- contacts
    sd, sn, sp = _static_contacts(world, params, pos, quat, patches,
                                  two_ended)                 # (B,N,K)
    I, J = _pair_indices(n_b, dev)
    pd, pn, ppt = _pair_contacts(params, pos, quat, I, J)    # (B,P)
    hot = pd > 0

    def scat(xi, xj):
        """Signed pair→body sums: Σ_{p: I=b} xi − Σ_{p: J=b} xj."""
        z = torch.zeros((B, n_b) + xi.shape[2:], dtype=xi.dtype, device=dev)
        return z.index_add(1, I, xi) - z.index_add(1, J, xj)

    # --- penetration push-out (physics.c:755-766), dynamic bodies only
    push_static = torch.sum(
        torch.where(sd[..., None] > 0, sd[..., None] * sn, 0.0), dim=2)
    imp = torch.where(hot[..., None], pd[..., None] * pn, 0.0)
    push_pairs = scat(imp, imp)
    pos = pos + torch.where(solve_mask[..., None], push_static + push_pairs,
                            0.0)

    # wake bodies touched by an enabled body or by a kinematic character
    waker = solve_mask | (params.kinematic & params.active)
    t_i = (hot & waker[:, J]).float()
    t_j = (hot & waker[:, I]).float()
    zb = torch.zeros((B, n_b), device=dev)
    touched = (zb.index_add(1, I, t_i) + zb.index_add(1, J, t_j)) > 0
    disabled = state.disabled & ~touched
    solve_mask = params.active & ~params.kinematic & ~disabled

    # --- gravity
    g = mx.const(GRAVITY, dev)
    vel = vel + torch.where(solve_mask[..., None], g * dt, 0.0)

    bounce_s = params.bounce
    bv_s = params.bounce_vel
    mu_s = params.mu
    b_pair = torch.maximum(params.bounce[I], params.bounce[J])
    bv_pair = 0.5 * (params.bounce_vel[I] + params.bounce_vel[J])
    mu_pair = torch.sqrt(params.mu[I] * params.mu[J])

    # static contact offsets and restitution targets
    sr = sp - pos[:, :, None, :]                             # (B, N, K, 3)
    vpt_pre = vel[:, :, None, :] + mx.cross(angvel[:, :, None, :], sr)
    vn_pre_s = torch.sum(sn * vpt_pre, dim=-1)
    target_s = torch.where(
        (bounce_s[:, None] > 0) & (vn_pre_s < -bv_s[:, None]),
        -bounce_s[:, None] * vn_pre_s, 0.0)
    contact_s = sd > -CONTACT_MARGIN

    # pair contact-point offsets + full effective mass
    moves = ~params.kinematic & params.active
    i_moves = moves[I]
    j_moves = moves[J]
    posI, posJ = pos[:, I], pos[:, J]
    imI, imJ = inv_mass[:, I], inv_mass[:, J]
    if iso:
        iiI, iiJ = inv_i[:, I], inv_i[:, J]

        def iiI_apply(x):
            return x * iiI[..., None]

        def iiJ_apply(x):
            return x * iiJ[..., None]
    else:
        iI, iJ = inv_I[:, I], inv_I[:, J]

        def iiI_apply(x):
            return torch.einsum("bpac,bpc->bpa", iI, x)

        def iiJ_apply(x):
            return torch.einsum("bpac,bpc->bpa", iJ, x)

    pr_i = ppt - posI
    pr_j = ppt - posJ
    vpt_i_pre = vel[:, I] + mx.cross(angvel[:, I], pr_i)
    vpt_j_pre = vel[:, J] + mx.cross(angvel[:, J], pr_j)
    vrel_pre = torch.where(i_moves[:, None], vpt_i_pre, 0.0) \
        - torch.where(j_moves[:, None], vpt_j_pre, 0.0)
    vn_pre_p = torch.sum(pn * vrel_pre, dim=-1)
    target_p = torch.where((b_pair > 0) & (vn_pre_p < -bv_pair),
                           -b_pair * vn_pre_p, 0.0)

    rxn_i = mx.cross(pr_i, pn)
    rxn_j = mx.cross(pr_j, pn)
    ii_rxn_i = iiI_apply(rxn_i)
    ii_rxn_j = iiJ_apply(rxn_j)
    K_pair = (imI + imJ
              + torch.sum(mx.cross(ii_rxn_i, pr_i) * pn, dim=-1)
              + torch.sum(mx.cross(ii_rxn_j, pr_j) * pn, dim=-1))

    def static_slot(v, w, k):
        """λ-based sequential impulse at static contact slot k, plus
        Coulomb friction ≤ μ·λ."""
        n_k = sn[:, :, k]
        r_k = sr[:, :, k]
        act = contact_s[:, :, k] & solve_mask
        vpt = v + mx.cross(w, r_k)
        vn = torch.sum(n_k * vpt, dim=-1)
        rxn = mx.cross(r_k, n_k)
        iirxn = invI_apply(rxn)
        K = inv_mass + torch.sum(mx.cross(iirxn, r_k) * n_k, dim=-1)
        lam = torch.where(act, torch.clamp(target_s[:, :, k] - vn, min=0.0)
                          / torch.clamp(K, min=1e-9), 0.0)
        v = v + (lam * inv_mass)[..., None] * n_k
        w = w + lam[..., None] * iirxn
        vpt = v + mx.cross(w, r_k)
        vt = vpt - torch.sum(n_k * vpt, dim=-1, keepdim=True) * n_k
        vt_len = _norm(vt)
        t_dir = vt / torch.clamp(vt_len, min=1e-9)[..., None]
        rxt = mx.cross(r_k, t_dir)
        iirxt = invI_apply(rxt)
        Kt = inv_mass + torch.sum(mx.cross(iirxt, r_k) * t_dir, dim=-1)
        lam_t = torch.where(act & (vt_len > 1e-9),
                            torch.minimum(vt_len / torch.clamp(Kt, min=1e-9),
                                          mu_s * lam), 0.0)
        v = v - (lam_t * inv_mass)[..., None] * t_dir
        w = w - lam_t[..., None] * iirxt
        return v, w

    def pair_pass(v, w):
        """One Jacobi pass over the pair list with the full contact
        Jacobian and Coulomb friction."""
        vpt_i = v[:, I] + mx.cross(w[:, I], pr_i)
        vpt_j = v[:, J] + mx.cross(w[:, J], pr_j)
        vrel = torch.where(i_moves[:, None], vpt_i, 0.0) \
            - torch.where(j_moves[:, None], vpt_j, 0.0)
        vn_p = torch.sum(pn * vrel, dim=-1)
        lam = torch.where(hot, torch.clamp(target_p - vn_p, min=0.0)
                          / torch.clamp(K_pair, min=1e-9), 0.0)
        vt = vrel - vn_p[..., None] * pn
        vt_len = _norm(vt)
        t_dir = vt / torch.clamp(vt_len, min=1e-9)[..., None]
        rxt_i = mx.cross(pr_i, t_dir)
        rxt_j = mx.cross(pr_j, t_dir)
        ii_rxt_i = iiI_apply(rxt_i)
        ii_rxt_j = iiJ_apply(rxt_j)
        Kt = (imI + imJ
              + torch.sum(mx.cross(ii_rxt_i, pr_i) * t_dir, dim=-1)
              + torch.sum(mx.cross(ii_rxt_j, pr_j) * t_dir, dim=-1))
        lam_t = torch.where(hot & (vt_len > 1e-9),
                            torch.minimum(vt_len / torch.clamp(Kt, min=1e-9),
                                          mu_pair * lam), 0.0)
        plin = lam[..., None] * pn - lam_t[..., None] * t_dir
        dwi = lam[..., None] * ii_rxn_i - lam_t[..., None] * ii_rxt_i
        dwj = lam[..., None] * ii_rxn_j - lam_t[..., None] * ii_rxt_j
        dv = scat(plin, plin) * inv_mass[..., None]
        dw = scat(dwi, dwj)
        return (v + torch.where(solve_mask[..., None], dv, 0.0),
                w + torch.where(solve_mask[..., None], dw, 0.0))

    for _ in range(solver_passes):
        for k in range(sd.shape[2]):
            vel, angvel = static_slot(vel, angvel, k)
        vel, angvel = pair_pass(vel, angvel)

    # --- damping + integrate (linear damping only, physics.c:1126-1130)
    vel = vel * torch.where(solve_mask[..., None], 1.0 - LINEAR_DAMPING, 1.0)
    pos = pos + torch.where(solve_mask[..., None], vel * dt, 0.0)
    wq = torch.cat([angvel, torch.zeros_like(angvel[..., :1])], dim=-1)
    dq = 0.5 * mx.qmul(wq, quat)
    quat = mx.qnormalize(
        torch.where(solve_mask[..., None], quat + dq * dt, quat))

    # --- auto-disable bookkeeping (physics.c:1033-1043)
    slow = (_norm(vel) < AUTO_DISABLE_VEL) \
        & (_norm(angvel) < AUTO_DISABLE_ANGVEL)
    cnt = torch.where(slow, state.disable_count + 1, 0).to(torch.int32)
    disabled = disabled | (solve_mask & (cnt >= AUTO_DISABLE_STEPS))
    vel = torch.where(disabled[..., None], 0.0, vel)
    angvel = torch.where((disabled | ~solve_mask)[..., None], 0.0, angvel)

    return PhysState(pos=pos, vel=vel, quat=quat, angvel=angvel,
                     time_acc=state.time_acc,
                     disable_count=cnt, disabled=disabled)


def _where_env(do, new, old):
    """Per-env select over a NamedTuple of (B, ...) tensors."""
    return type(old)(*(
        torch.where(do.reshape(do.shape + (1,) * (o.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def phys_step(world: StaticWorld, params: BodyParams, state: PhysState,
              dt, max_substeps: int = MAX_SUBSTEPS,
              solver_passes: int = N_SOLVER_PASSES, *,
              flags: BodyFlags) -> PhysState:
    """phys_step (physics.c:773-787): fixed-dt accumulator, ≤ max_substeps
    masked substeps per frame. ``flags``: the body set's BodyFlags, decided
    on the host where the params were built (SceneConfig.host)."""
    two_ended, iso = flags.two_ended, flags.iso
    acc = state.time_acc + dt
    patches = _body_patches(world, state.pos, two_ended)
    for _ in range(max_substeps):
        do = acc >= FIXED_DT
        st2 = _substep(world, params, state, FIXED_DT, patches, two_ended,
                       iso, solver_passes=solver_passes)
        state = _where_env(do, st2, state)
        acc = torch.where(do, acc - FIXED_DT, acc)
    acc = torch.where(acc >= FIXED_DT, 0.0, acc)
    return state._replace(time_acc=acc)
