"""Hand-written CUDA kernels and their plain PyTorch versions.

Sources live in `csrc/` and are built by `_build` with nvcc at first use.
"""

from jpeg_detection_resnet_ssd_torch.ops.batched_nms import (
    batched_nms_mask,
    batched_nms_mask_reference,
)

__all__ = ["batched_nms_mask", "batched_nms_mask_reference"]
