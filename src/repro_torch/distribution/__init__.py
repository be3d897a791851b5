"""The FL-device mesh (port of the FL-device half of
``repro/distribution/``): ``ota_psum`` and the ``mesh`` backend over a
``torch.distributed`` group, and the sharded streaming round's mesh and
cross-shard combine.  The placement half (parameter and batch specs, the
experiment mesh) waits for ROADMAP queue 1 item 15."""
from repro_torch.distribution.ota_collectives import (aggregate_mesh,
                                                      client_index,
                                                      fold_shards,
                                                      gather_shards,
                                                      ota_psum,
                                                      stack_shards,
                                                      tree_sq_norm)
from repro_torch.distribution.sharding import (FL_DEVICE_AXIS, DeviceMesh,
                                               device_mesh,
                                               shard_device_axis)

__all__ = ["FL_DEVICE_AXIS", "DeviceMesh", "aggregate_mesh", "client_index",
           "device_mesh", "fold_shards", "gather_shards", "ota_psum",
           "shard_device_axis", "stack_shards", "tree_sq_norm"]
