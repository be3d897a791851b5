"""The port of ``repro/distribution/``: the FL-device mesh (``ota_psum``
and the ``mesh`` backend over a ``torch.distributed`` group, the sharded
streaming round's mesh and cross-shard combine), the experiment axis of
the batched sweep engine, and the placement of a model on a ``(data,
model)`` serving mesh (the specs, the cut of a full tensor to a rank's
shard, and the tensor-parallel rank program, ``tensor_parallel``)."""
from repro_torch.distribution.ota_collectives import (aggregate_mesh,
                                                      client_index,
                                                      fold_shards,
                                                      gather_shards,
                                                      ota_psum,
                                                      stack_shards,
                                                      tree_sq_norm)
from repro_torch.distribution.sharding import (EXPERIMENT_AXIS,
                                               FL_DEVICE_AXIS, CutLayout,
                                               DeviceMesh, ExperimentMesh,
                                               Spec, batch_specs,
                                               cache_specs,
                                               device_mesh, experiment_mesh,
                                               gather_params,
                                               named_shardings, param_specs,
                                               sanitize_spec, shard_cache,
                                               shard_device_axis,
                                               shard_experiment_axis,
                                               shard_params, tp_plan)
from repro_torch.distribution.tensor_parallel import RankContext, run_ranks

__all__ = ["EXPERIMENT_AXIS", "FL_DEVICE_AXIS", "CutLayout", "DeviceMesh",
           "ExperimentMesh", "RankContext", "Spec", "aggregate_mesh",
           "batch_specs", "cache_specs", "client_index", "device_mesh",
           "experiment_mesh", "fold_shards", "gather_params",
           "gather_shards",
           "named_shardings", "ota_psum", "param_specs", "run_ranks",
           "sanitize_spec", "shard_cache", "shard_device_axis",
           "shard_experiment_axis", "shard_params", "stack_shards",
           "tp_plan", "tree_sq_norm"]
