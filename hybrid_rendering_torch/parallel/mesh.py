"""The device mesh of a multi-device frame.

Port of ``hybrid_rendering_tpu/parallel/mesh.py``. The frame shards over
one axis, ``tiles``: image rows and ray batches split over it while the
scene and its acceleration structure are replicated on every device. JAX
builds a ``jax.sharding.Mesh``; PyTorch has no GSPMD, so here a mesh is an
ordered tuple of ``torch.device``s. It may repeat a device: on one card
every shard is ``cuda:0`` and runs on its current stream, in order. A
"sharding" only names a layout (``.spec``), as ``NamedSharding``'s
``PartitionSpec`` does; nothing is placed by it.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

TILE_AXIS = "tiles"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the frame-tile axis: ``devices[i]`` runs shard i."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: len(self.devices)}


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over `mesh`: ``spec == (TILE_AXIS,)`` splits the leading
    dim over the tiles axis, ``()`` replicates."""

    mesh: Mesh
    spec: Tuple[str, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the frame-tile axis. Without `devices`: every CUDA
    device, the first `n_devices` of them when given; with no GPU that
    raises (the card is never silently replaced by the CPU). `devices` is
    taken as it is, repeats included (``["cuda:0"] * 3`` is three shards on
    one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices= "
                               "(e.g. [\"cpu\"] * n) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = tuple(canonical(d) for d in devices)
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devices)


def canonical(device) -> torch.device:
    """`device` as a ``torch.device`` with its index where it is a card
    (``"cuda"`` is the current card), so that equal devices compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def tree_map(fn, tree):
    """`fn` on every leaf of a tree of dataclasses, dicts, lists and tuples,
    the structure kept. A dataclass is copied field by field (no
    ``__post_init__`` runs, so nothing derived is recomputed)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(out, f.name, tree_map(fn, getattr(tree, f.name)))
        return out
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_device(tree, device, non_blocking=False):
    """`tree` with every tensor on `device` (a tensor already there is the
    same tensor); any other leaf is kept."""
    return tree_map(lambda leaf: leaf.to(device, non_blocking=non_blocking)
                    if isinstance(leaf, torch.Tensor) else leaf, tree)


def row_sharding(mesh: Mesh) -> Sharding:
    """Shard an (H, ...) image over rows."""
    return Sharding(mesh, (TILE_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_rows(h: int, n: int) -> int:
    """Rows padded to a multiple of the tile-axis size."""
    return (h + n - 1) // n * n
