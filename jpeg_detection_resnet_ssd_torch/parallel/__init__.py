"""Data and tensor parallelism across `torch.distributed` ranks
(counterpart of the JAX package's `parallel/`)."""

from jpeg_detection_resnet_ssd_torch.parallel.mesh import (
    Mesh,
    ModelShard,
    active_mesh,
    data_parallel,
    make_mesh,
    model_shards,
    scale_learning_rate,
    shard_batch,
    shard_parameters,
    tensor_parallel_rule,
)

__all__ = [
    "Mesh",
    "ModelShard",
    "active_mesh",
    "data_parallel",
    "make_mesh",
    "model_shards",
    "scale_learning_rate",
    "shard_batch",
    "shard_parameters",
    "tensor_parallel_rule",
]
