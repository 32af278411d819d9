"""Env-axis sharding over a list of devices (counterpart of
clap_tpu/parallel/sharding.py).

Envs are independent scenes, so the env axis is the one sharding
dimension: each mesh entry gets a contiguous slice of every per-env
tensor and its own copy of the shared tables, and the only collectives
are metric reductions. JAX's ``jit`` runs a function over a sharded tree
implicitly; here it is explicit: ``map_shards`` runs a function on each
entry's shard, ``gather_envs`` joins per-shard results into one batch and
``env_mean`` reduces across the shards from per-shard sums and counts.

A mesh may name one device several times (``devices=["cpu"] * 8``), the
counterpart of the JAX tests' virtual CPU devices. ``map_shards``
dispatches the shards one after another from the calling thread.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch
from torch import nn

from ..bridge import tree_leaves, tree_map


class EnvMesh(NamedTuple):
    """An ordered list of devices along one named axis."""
    devices: tuple
    axis: str = "env"

    @property
    def size(self) -> int:
        return len(self.devices)


def env_mesh(n_devices: int | None = None, axis: str = "env",
             devices=None) -> EnvMesh:
    """The mesh of ``devices`` (names or ``torch.device``s, repeats
    allowed), by default every CUDA card, cut to the first ``n_devices``.
    Without a card and without ``devices`` it raises: it never builds a
    CPU mesh unasked."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("env_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu'] * 8) for another mesh")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("env_mesh: a mesh needs at least one device")
    return EnvMesh(devs, axis)


def shard_envs(tree, mesh: EnvMesh, axis: str = "env") -> list:
    """One tree per mesh entry: every tensor leaf with ``ndim >= 1`` gives
    entry i the i-th contiguous slice of its leading env axis, copied to
    the entry's device; zero-dim tensors are copied to every entry's
    device; host values (flags, dataclasses, numbers) are shared. A
    leading axis that the mesh's size does not divide raises ValueError,
    as JAX's ``NamedSharding`` does."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's ({mesh.axis!r})")
    n = mesh.size
    for x in tree_leaves(tree):
        if x.dim() >= 1 and x.shape[0] % n:
            raise ValueError(f"the env axis of a {tuple(x.shape)} tensor "
                             f"does not divide over {n} mesh entries")

    def shard(i, dev):
        def put(x):
            if not isinstance(x, torch.Tensor):
                return x
            if x.dim() >= 1:
                k = x.shape[0] // n
                x = x[i * k:(i + 1) * k]
            return x.to(dev, copy=True)
        return tree_map(put, tree)

    return [shard(i, dev) for i, dev in enumerate(mesh.devices)]


def replicate(tree, mesh: EnvMesh) -> list:
    """One copy of ``tree`` per mesh entry, made once per distinct device:
    where a device already holds a tensor, its entries get the tensor
    itself. An ``nn.Module`` (a SceneRenderer's tables) moves as a whole:
    the module itself on its own device, a copy on each other."""
    copies = {}
    for dev in dict.fromkeys(mesh.devices):
        if isinstance(tree, nn.Module):
            bufs = list(tree.buffers()) + list(tree.parameters())
            home = {b.device for b in bufs}
            copies[dev] = tree if home <= {dev} else \
                copy.deepcopy(tree).to(dev)
        else:
            copies[dev] = tree_map(
                lambda x, d=dev: x.to(d) if isinstance(x, torch.Tensor)
                else x, tree)
    return [copies[dev] for dev in mesh.devices]


def map_shards(fn, mesh: EnvMesh, *shards) -> list:
    """``fn`` on each mesh entry's shard: ``fn(*args_i)`` for the i-th
    element of each per-entry list in ``shards`` (from ``shard_envs`` or
    ``replicate``), with entry i's card current while it runs. The calls
    run one after another from this thread."""
    out = []
    for dev, args in zip(mesh.devices, zip(*shards)):
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                out.append(fn(*args))
        else:
            out.append(fn(*args))
    return out


def gather_envs(shards: list):
    """One batched tree from per-entry trees: tensor leaves with
    ``ndim >= 1`` concatenated along the env axis on the first shard's
    device, others taken from the first shard."""
    def cat(*xs):
        x0 = xs[0]
        if not isinstance(x0, torch.Tensor) or x0.dim() == 0:
            return x0
        return torch.cat([x.to(x0.device) for x in xs])

    return tree_map(cat, shards[0], *shards[1:])


def env_mean(shards: list) -> torch.Tensor:
    """The mean over every element of per-entry tensors (a cross-env
    metric): the shards' sums (float64) and element counts added on the
    first shard's device, so the mean weighs every element once, whatever
    the shards' sizes. Returned in the shards' dtype."""
    dev = shards[0].device
    total = sum(s.sum(dtype=torch.float64).to(dev) for s in shards)
    count = sum(s.numel() for s in shards)
    return (total / count).to(shards[0].dtype)
