"""SSD multibox loss and the selective L2 penalty (torch)."""

from jpeg_detection_resnet_ssd_torch.losses.classification import (
    default_ssd_reg_filter,
    l2_regularization_loss,
    regularized_parameters,
)
from jpeg_detection_resnet_ssd_torch.losses.ssd_loss import (
    SSDLoss,
    smooth_l1,
    softmax_log_loss,
    top_k_sum,
)

__all__ = [
    "SSDLoss",
    "default_ssd_reg_filter",
    "l2_regularization_loss",
    "regularized_parameters",
    "smooth_l1",
    "softmax_log_loss",
    "top_k_sum",
]
