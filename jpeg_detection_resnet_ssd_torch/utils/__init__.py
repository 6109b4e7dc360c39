"""Device resolution, CUDA-event timing, profiling and process-group
bring-up."""

from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device
from jpeg_detection_resnet_ssd_torch.utils.distributed import (
    is_primary_process,
    maybe_initialize_distributed,
    process_count,
    process_index,
)
from jpeg_detection_resnet_ssd_torch.utils.profiling import StepTimer, profile_trace
from jpeg_detection_resnet_ssd_torch.utils.timing import cuda_times_ms

__all__ = [
    "StepTimer",
    "cuda_times_ms",
    "is_primary_process",
    "maybe_initialize_distributed",
    "process_count",
    "process_index",
    "profile_trace",
    "resolve_device",
]
