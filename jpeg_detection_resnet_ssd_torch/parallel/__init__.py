"""Data parallelism across `torch.distributed` ranks (counterpart of the
JAX package's `parallel/`)."""

from jpeg_detection_resnet_ssd_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    data_parallel,
    make_mesh,
    scale_learning_rate,
    shard_batch,
    tensor_parallel_rule,
)

__all__ = [
    "Mesh",
    "active_mesh",
    "data_parallel",
    "make_mesh",
    "scale_learning_rate",
    "shard_batch",
    "tensor_parallel_rule",
]
