"""The device mesh over the ranks of the default process group (port of
``paddle_tpu/parallel/mesh.py:33-159``).

The JAX mesh is a grid of devices that one process drives. Here it is a
grid of ranks, one process each: ``create_mesh({"dp": 2, "sp": 2})``
lays the ranks of the default group out row-major over the named axes
(rank = dp_index * 2 + sp_index) and gives every axis its own process
group, the ranks that differ only in that axis, so a collective over an
axis (``parallel.collectives``) runs in that group. Axes of size 1 are
dropped, as in JAX; unlike JAX the product of the sizes must equal the
world size (no folding of leftover devices into ``dp``: the ranks are
processes that already exist). ``PartitionSpec`` is a plain tuple of
axis names (or tuples of them, or None) per tensor dimension.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from ..distributed.parallel import get_rank, get_world_size

__all__ = ["AXES", "Mesh", "PartitionSpec", "create_mesh", "get_mesh",
           "set_mesh", "axis_size"]

AXES = ("dp", "pp", "tp", "sp", "ep")

_global_mesh: list = [None]


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``PartitionSpec("dp", None)``
    shards dim 0 over ``dp``; an entry may be a tuple of axes."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """Named axes over ranks: ``axis_names``, ``shape`` ({axis: size}),
    this process's ``rank`` and ``coords`` ({axis: index}), and per axis
    the global ``ranks`` of this rank's line along it (ordered by index)
    and its process ``group``."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 lines: Dict[str, List[int]], groups: Dict[str, object]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.rank = rank
        idx = np.unravel_index(rank, tuple(self.shape.values())) \
            if self.shape else ()
        self.coords = {a: int(i) for a, i in zip(self.axis_names, idx)}
        self._lines = lines
        self._groups = groups

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def ranks(self, axis: str) -> List[int]:
        return self._lines[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def create_mesh(mesh_shape: Optional[Dict[str, int]] = None) -> Mesh:
    """``create_mesh({"dp": a, "sp": b})`` over the ranks of the default
    group (every rank calls it, in the same order: each axis line's
    ``new_group`` is collective). Sets and returns the global mesh."""
    sized = {str(k): int(v) for k, v in (mesh_shape or {}).items()
             if v and int(v) > 1}
    world = get_world_size()
    total = int(np.prod(list(sized.values()))) if sized else 1
    if total != world:
        raise ValueError(f"mesh {sized} holds {total} ranks, the world "
                         f"has {world}")
    rank = get_rank()
    sizes = tuple(sized.values())
    grid = np.arange(total).reshape(sizes) if sized else None
    lines, groups = {}, {}
    for ax, name in enumerate(sized):
        others = [range(s) for i, s in enumerate(sizes) if i != ax]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(ax, slice(None))
            ranks = [int(r) for r in grid[tuple(index)]]
            group = dist.new_group(ranks)
            if rank in ranks:
                lines[name], groups[name] = ranks, group
    mesh = Mesh(sized, rank, lines, groups)
    _global_mesh[0] = mesh
    return mesh


def get_mesh() -> Optional[Mesh]:
    return _global_mesh[0]


def set_mesh(mesh: Optional[Mesh]) -> None:
    _global_mesh[0] = mesh


def axis_size(mesh: Optional[Mesh], name: str) -> int:
    return mesh.axis_size(name) if mesh is not None else 1
