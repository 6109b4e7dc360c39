"""Hand-written CUDA kernels and their plain PyTorch versions.

Sources live in `csrc/` and are built by `_build` with nvcc at first use.
"""

from jpeg_detection_resnet_ssd_torch.ops.batched_nms import (
    batched_nms_mask,
    batched_nms_mask_reference,
)
# `ops.bipartite_match` is the module (its function of the same name is not
# re-exported here, so the module and its LAUNCHES stay reachable).
from jpeg_detection_resnet_ssd_torch.ops.conv_grad import (
    conv3x3_filter_grad,
    conv3x3_filter_grad_reference,
    conv3x3_same_wgrad,
)

__all__ = [
    "batched_nms_mask",
    "batched_nms_mask_reference",
    "conv3x3_filter_grad",
    "conv3x3_filter_grad_reference",
    "conv3x3_same_wgrad",
]
