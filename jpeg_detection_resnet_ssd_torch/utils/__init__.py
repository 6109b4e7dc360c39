"""Device resolution and CUDA-event timing."""

from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device
from jpeg_detection_resnet_ssd_torch.utils.timing import cuda_times_ms

__all__ = ["cuda_times_ms", "resolve_device"]
