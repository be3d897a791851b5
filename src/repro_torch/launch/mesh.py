"""The serving mesh (the port of ``repro/launch/mesh.py``): ``data x model``
ranks, rank = ``d * model + m``.

``make_host_mesh(data, model)`` gives a **physical** mesh where the
default ``torch.distributed`` process group holds exactly ``data * model``
ranks (one card a rank over NCCL, or ``gloo`` ranks on the CPU): this
process is one rank, and it builds the subgroups its collectives run over
(the ``model`` ranks of its data row and the ``data`` ranks of its model
column; every rank builds every subgroup, in one order, as
``torch.distributed.new_group`` requires).  With no group the mesh is
**emulated**: every rank in turn, in this one process, on one device
(``distribution.tensor_parallel.run_ranks``), bitwise the physical mesh.

The reference's ``make_production_mesh`` (a 256- or 512-chip TPU pod)
waits for the port's dry-run launcher, its only caller (ROADMAP queue 1
item 17).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

AXES = ("data", "model")


class ServingMesh:
    """A ``(data, model)`` mesh of ranks: physical (this process is rank
    ``rank`` of a group of ``data * model``) or emulated (``rank`` None:
    every rank in turn in this process)."""

    def __init__(self, data: int, model: int, *, rank: Optional[int] = None,
                 model_group=None, data_group=None):
        if data < 1 or model < 1:
            raise ValueError(f"mesh {data}x{model}: both axes need >= 1 rank")
        self.data, self.model = data, model
        self.rank = rank
        self.groups = {"model": model_group, "data": data_group}

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXES

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def physical(self) -> bool:
        return self.rank is not None

    @property
    def local_ranks(self) -> Sequence[int]:
        """The ranks this process runs: its own, or all of them in turn."""
        return [self.rank] if self.physical else list(range(self.size))

    def coords(self, rank: int) -> Tuple[int, int]:
        """(d, m) of a rank."""
        return rank // self.model, rank % self.model

    def __repr__(self):
        kind = f"rank {self.rank}" if self.physical else "emulated"
        return f"ServingMesh(data={self.data}, model={self.model}, {kind})"


def _world() -> Tuple[int, int]:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0, -1
    return dist.get_world_size(), dist.get_rank()


def make_host_mesh(data: int = 1, model: int = 1, *,
                   emulate: bool = False) -> ServingMesh:
    """The serving mesh: physical over the default process group when it
    holds ``data * model`` ranks, emulated when there is no group (or
    ``emulate=True``).  A group of another size raises: its ranks would
    each run the whole emulated mesh."""
    size, rank = _world()
    if emulate or size == 0:
        return ServingMesh(data, model)
    if size != data * model:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} ranks, the process "
            f"group holds {size}; start {data * model} ranks, or pass "
            "emulate=True to run every rank in this process")
    dist = torch.distributed
    mine = {}
    for d in range(data):                 # the model ranks of each data row
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            mine["model"] = g
    for m in range(model):                # the data ranks of each column
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            mine["data"] = g
    return ServingMesh(data, model, rank=rank, model_group=mine["model"],
                       data_group=mine["data"])


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The axes that carry the batch (and the FL devices): ('data',)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def num_fl_devices(mesh, aggregation_axes: Optional[Tuple[str, ...]] = None
                   ) -> int:
    axes = aggregation_axes or dp_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
