"""Input fuzzer / replay (counterpart of clap_tpu/engine/fuzzer.py;
reference: core/input-fuzzer.c:17-91).

The reference injects randomized synthetic ``message_input`` records
every frame once toggled (fuzzer_input_step, clap.c:578) as its soak
test. Here the fuzzer is a pure function of (seed, env, frame) → Inputs,
so a seeded stream is deterministic and replayable by construction — the
soak test and the input-replay system are the same thing.

The JAX package draws from ``jax.random`` (fold_in of the frame, then of
the env), which torch cannot reproduce. The port draws from a
counter-based integer hash of (seed, env, frame, draw index), in int64
tensor arithmetic on the caller's device: env *i*'s stream does not
depend on the batch size, the card and the CPU draw the same uniforms bit
for bit, and a frame's draw makes no host read. ``fuzz_inputs(...,
draws=)`` takes a caller's draws instead (the JAX package's, in the
tests).
"""
from __future__ import annotations

import math

import torch

from .. import mathx as mx
from ..device import resolve_device
from .step import Inputs

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """The low 32 bits of ``x`` · ``c`` for 32-bit ``x`` (int64 tensor) and
    a 32-bit constant, without overflowing int64: split ``x`` in halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _M32


def _hash32(x):
    """lowbias32 (a 32-bit integer finalizer) of an int64 tensor holding
    values in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def n_draws(n_chars: int) -> int:
    """Uniform draws per env and frame: angle, magnitude and jump per
    character, then four for the three camera normals (two Box-Muller
    pairs)."""
    return 3 * n_chars + 4


def fuzz_draws(seed: int, frame, envs, n_chars: int = 1, device=None):
    """The raw uniforms in [0, 1) of ``envs`` (an int, or a tensor of env
    ids) at ``frame`` (an int or a 0-d tensor): float32 (..., n_draws),
    each a multiple of 2⁻²⁴ — integer arithmetic, the same bits on every
    device."""
    dev = resolve_device(device)
    if isinstance(envs, torch.Tensor):
        env = envs.to(torch.int64) & _M32
    else:                       # a fill, not a copy from the host
        env = torch.full((), int(envs) & _M32, dtype=torch.int64,
                         device=dev)
    if isinstance(frame, torch.Tensor):
        frame = frame.to(device=dev, dtype=torch.int64)
    idx = torch.arange(n_draws(n_chars), device=dev, dtype=torch.int64)
    h = _hash32(torch.full_like(env, seed & _M32))
    h = _hash32(h ^ env)
    h = _hash32(h ^ (frame & _M32))
    h = _hash32(h[..., None] ^ idx)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _normals(u):
    """Box-Muller: (..., 4) uniforms → (..., 3) standard normals."""
    r = torch.sqrt(-2.0 * torch.log(1.0 - u[..., 0::2]))   # 1 - u in (0, 1]
    t = (2 * math.pi) * u[..., 1::2]
    return torch.cat([r * torch.cos(t), r * torch.sin(t)], -1)[..., :3]


def fuzz_inputs(seed: int, frame, n_chars: int = 1,
                jump_prob: float = 0.02, turn_scale: float = 1.0,
                draws=None, device=None, env=0) -> Inputs:
    """Deterministic per-frame random inputs of stream (``seed``,
    ``env``).

    Mirrors the distribution shape of input-fuzzer.c: a wandering motion
    direction, occasional jumps, slow camera drift. ``draws``: (angle
    uniforms (..., C), magnitude uniforms (..., C), jump uniforms (..., C),
    camera normals (..., 3)) in place of the stream's."""
    if draws is None:
        u = fuzz_draws(seed, frame, env, n_chars, device)
        C = n_chars
        draws = (u[..., :C], u[..., C:2 * C], u[..., 2 * C:3 * C],
                 _normals(u[..., 3 * C:]))
    u_ang, u_mag, u_jump, normal = draws
    ang = u_ang * (2 * math.pi)
    motion = torch.stack([torch.cos(ang) * u_mag, torch.sin(ang) * u_mag],
                         dim=-1)
    scale = mx.const([0.01, 0.03, 0.05], normal.device)
    return Inputs(motion=motion.to(torch.float32), jump=u_jump < jump_prob,
                  cam_delta=(normal * scale * turn_scale).to(torch.float32))


def fuzz_batch(seed: int, frame, n_envs: int, n_chars: int = 1,
               device=None) -> Inputs:
    """Per-env independent streams: env *i* of the batch is
    ``fuzz_inputs(seed, frame, env=i)`` whatever ``n_envs`` is."""
    dev = resolve_device(device)
    return fuzz_inputs(seed, frame, n_chars, device=dev,
                       env=torch.arange(n_envs, device=dev))
