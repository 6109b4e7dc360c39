"""The `ssd_custom` DCT-SSD300 detector in PyTorch (NHWC contracts)."""

from jpeg_detection_resnet_ssd_torch.models.layers import L2Normalization
from jpeg_detection_resnet_ssd_torch.models.resnet import ResNetBlocks
from jpeg_detection_resnet_ssd_torch.models.ssd import (
    SSDResNetCustom,
    make_inference_fn,
    ssd_predictor_sizes,
)
from jpeg_detection_resnet_ssd_torch.models.zoo import build_model

__all__ = [
    "L2Normalization",
    "ResNetBlocks",
    "SSDResNetCustom",
    "build_model",
    "make_inference_fn",
    "ssd_predictor_sizes",
]
