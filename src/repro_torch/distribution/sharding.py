"""The FL-device mesh of the sharded streaming engine (port of the
FL-device half of ``repro/distribution/sharding.py``).

``device_mesh`` / ``shard_device_axis`` serve ``FLConfig.device_mesh`` and
``OTAConfig.device_mesh``: the K-blocked round partitions its blocks over D
shards, each shard left-folds its own contiguous run of blocks, and one
deterministic cross-shard combine (``ota_collectives.fold_shards``) closes
eq. (10).  In the port a shard is one rank of a ``torch.distributed``
process group, each rank on the device its caller puts it on (one card a
rank, or the CPU under ``gloo``); the mesh never picks a device itself.

``device_mesh(D)`` hands out the default process group when it holds
exactly D ranks, and None otherwise: the caller then runs the same shards
one after another in one process (the emulated path), bitwise the same
result, since the blocking and the combine order are the config's.  The
reference asks for at least D local devices instead; one rank a shard is
what ``torch.distributed`` gives.
"""
from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import torch

FL_DEVICE_AXIS = "fldev"

# REPRO_FL_MESH=emulate forces the emulated path even where a group of D
# ranks exists (the parity tests' lever).  Read when a round body or an
# aggregate is built: flip it before a config's first run, or call
# ``runtime.clear_compile_caches()`` after
_EMULATE_ENV = "REPRO_FL_MESH"


class DeviceMesh(NamedTuple):
    """A 1-D mesh of D ranks over the FL-device axis: the process group,
    its size and this process's rank in it."""
    group: Any
    size: int
    rank: int
    axis_name: str = FL_DEVICE_AXIS


def _world_size() -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 0
    return dist.get_world_size()


def device_mesh(num_shards: int, *,
                axis_name: str = FL_DEVICE_AXIS) -> Optional[DeviceMesh]:
    """The mesh of the default process group when it holds exactly
    ``num_shards`` ranks, else None (one shard, no group, a group of another
    size, or ``REPRO_FL_MESH=emulate``): the caller then runs the emulated
    path, bitwise the same."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if os.environ.get(_EMULATE_ENV, "") == "emulate":
        return None
    if num_shards == 1 or _world_size() != num_shards:
        return None
    dist = torch.distributed
    return DeviceMesh(dist.group.WORLD, num_shards, dist.get_rank(),
                      axis_name)


def shard_device_axis(tree: Any, mesh: DeviceMesh) -> Any:
    """This rank's shard of every leaf of ``tree``: row ``mesh.rank`` of the
    leading (shard) axis, which every leaf carries (the [D, nb/D, ...]
    blocked inputs of the sharded round); 0-d leaves are replicated and
    pass as they are."""
    if isinstance(tree, torch.Tensor):
        return tree if tree.dim() == 0 else tree[mesh.rank]
    if isinstance(tree, dict):
        return {k: shard_device_axis(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_device_axis(v, mesh) for v in tree)
    return tree
