"""The serving and training mesh (the port of ``repro/launch/mesh.py``):
``(data, model)`` ranks, rank = ``d * model + m``, or with a ``pod`` axis in
front ``(pod, data, model)`` ranks, rank = ``(p * data + d) * model + m``.

``make_host_mesh(data, model, pod=1)`` gives a **physical** mesh where the
default ``torch.distributed`` process group holds exactly ``pod * data *
model`` ranks (one card a rank over NCCL, ``gloo`` ranks on the CPU, or
the dry run's fake group, ``launch.dryrun``): this process is one rank,
and it builds the subgroups its collectives run over (every rank builds
every subgroup, in one order, as ``torch.distributed.new_group``
requires).  With no group the mesh is **emulated**: every rank in turn,
in this one process, on one device (``distribution.tensor_parallel.
run_ranks``), bitwise the physical mesh.

``make_production_mesh`` is the reference's production mesh: (16, 16), or
(2, 16, 16) with ``multi_pod``; physical where the default group holds 256
or 512 ranks.

An axis of a collective is a name or a tuple of names: the tuple
``("pod", "data")`` is the flattened axis of ``pod * data`` ranks, in
rank order (index ``p * data + d``), so a fold over it on a (2, 2, M) mesh
is a fold over ``data`` on a (4, 1, M) mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
DP = ("pod", "data")

Axis = Union[str, Tuple[str, ...]]


class ServingMesh:
    """A ``(data, model)`` or ``(pod, data, model)`` mesh of ranks: physical
    (this process is rank ``rank`` of a group of ``size``) or emulated
    (``rank`` None: every rank in turn in this process).  ``groups`` maps
    an axis (``canonical``) to this rank's process group along it."""

    def __init__(self, data: int, model: int, *, pod: int = 1,
                 rank: Optional[int] = None, groups=None):
        if data < 1 or model < 1 or pod < 1:
            raise ValueError(f"mesh {pod}x{data}x{model}: every axis needs "
                             ">= 1 rank")
        self.pod, self.data, self.model = pod, data, model
        self.rank = rank
        self.groups = dict(groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"pod": self.pod, "data": self.data, "model": self.model}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return POD_AXES if self.pod > 1 else AXES

    @property
    def size(self) -> int:
        return self.pod * self.data * self.model

    @property
    def physical(self) -> bool:
        return self.rank is not None

    @property
    def local_ranks(self) -> Sequence[int]:
        """The ranks this process runs: its own, or all of them in turn."""
        return [self.rank] if self.physical else list(range(self.size))

    def coords(self, rank: int) -> Tuple[int, int]:
        """(d, m) of a rank."""
        return (rank // self.model) % self.data, rank % self.model

    def axis_coords(self, rank: int) -> Dict[str, int]:
        """Axis name -> the rank's index along it (``pod`` 0 on a mesh
        without one)."""
        return {"pod": rank // (self.data * self.model),
                "data": (rank // self.model) % self.data,
                "model": rank % self.model}

    def canonical(self, axis: Axis) -> Axis:
        """An axis as the mesh names it: a tuple's names that the mesh does
        not have dropped (``("pod", "data")`` is ``"data"`` without a pod
        axis), a one-name tuple the name.  An unknown single name raises."""
        names = axis if isinstance(axis, tuple) else (axis,)
        for a in names:
            if a not in POD_AXES:
                raise ValueError(f"unknown mesh axis {a!r}; one of "
                                 f"{POD_AXES}")
        kept = tuple(a for a in names if a in self.axis_names)
        if not kept:
            raise ValueError(f"axis {axis!r}: the mesh's axes are "
                             f"{self.axis_names}")
        return kept[0] if len(kept) == 1 else kept

    def axis_size(self, axis: Axis) -> int:
        """Ranks along an axis (a tuple: the product)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        sizes = {"pod": self.pod, "data": self.data, "model": self.model}
        n = 1
        for a in names:
            n *= sizes[a]
        return n

    def axis_index(self, rank: int, axis: Axis) -> int:
        """A rank's index along an axis (a tuple: row-major over its
        names)."""
        names = axis if isinstance(axis, tuple) else (axis,)
        c, i = self.axis_coords(rank), 0
        for a in names:
            i = i * self.axis_size(a) + c[a]
        return i

    def members(self, rank: int, axis: Axis) -> Tuple[int, ...]:
        """The ranks of ``rank``'s group along ``axis`` (its coordinates on
        the other axes fixed), in index order."""
        names = axis if isinstance(axis, tuple) else (axis,)
        c = self.axis_coords(rank)
        out = []
        for i in range(self.axis_size(axis)):
            cc, rest = dict(c), i
            for a in reversed(names):
                cc[a], rest = rest % self.axis_size(a), rest // self.axis_size(a)
            out.append((cc["pod"] * self.data + cc["data"]) * self.model
                       + cc["model"])
        return tuple(out)

    def __repr__(self):
        kind = f"rank {self.rank}" if self.physical else "emulated"
        pod = f"pod={self.pod}, " if self.pod > 1 else ""
        return (f"ServingMesh({pod}data={self.data}, model={self.model}, "
                f"{kind})")


def _world() -> Tuple[int, int]:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0, -1
    return dist.get_world_size(), dist.get_rank()


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int = 1,
                   emulate: bool = False) -> ServingMesh:
    """The mesh: physical over the default process group when it holds
    ``pod * data * model`` ranks, emulated when there is no group (or
    ``emulate=True``).  A group of another size raises: its ranks would
    each run the whole emulated mesh."""
    size, rank = _world()
    mesh = ServingMesh(data, model, pod=pod)
    if emulate or size == 0:
        return mesh
    if size != mesh.size:
        raise ValueError(
            f"mesh {pod}x{data}x{model} needs {mesh.size} ranks, the process "
            f"group holds {size}; start {mesh.size} ranks, or pass "
            "emulate=True to run every rank in this process")
    # every rank builds every group, in this order: pod, data, model, then
    # the flattened (pod, data)
    axes = (["pod"] if pod > 1 else []) + ["data", "model"] + (
        [DP] if pod > 1 else [])
    groups = {}
    for axis in axes:
        done = set()
        for r in range(mesh.size):
            members = mesh.members(r, axis)
            if members in done:
                continue
            done.add(members)
            g = torch.distributed.new_group(list(members))
            if rank in members:
                groups[axis] = g
    return ServingMesh(data, model, pod=pod, rank=rank, groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> ServingMesh:
    """The reference's production mesh: (data 16, model 16), 256 ranks, or
    (pod 2, data 16, model 16), 512 ranks.  Physical where the default
    process group holds that many ranks (a real job, or the dry run's fake
    group), else emulated."""
    return make_host_mesh(16, 16, pod=2 if multi_pod else 1)


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The axes that carry the batch (and the FL devices): ('pod', 'data')
    or ('data',)."""
    return tuple(a for a in mesh.axis_names if a in DP)


def num_fl_devices(mesh, aggregation_axes: Optional[Tuple[str, ...]] = None
                   ) -> int:
    axes = aggregation_axes or dp_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n
