"""The `ssd_custom` DCT-SSD300 detector and the ResNet-50 classifiers (the 7
DCT stems and the RGB baseline) in PyTorch (NHWC contracts)."""

from jpeg_detection_resnet_ssd_torch.models.layers import L2Normalization
from jpeg_detection_resnet_ssd_torch.models.resnet import (
    CLASSIFICATION_ARCHIS,
    DCTStem,
    ResNet50DCT,
    ResNet50RGB,
    ResNetBlocks,
)
from jpeg_detection_resnet_ssd_torch.models.ssd import (
    SSDResNetCustom,
    make_inference_fn,
    ssd_predictor_sizes,
)
from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY, build_model

__all__ = [
    "CLASSIFICATION_ARCHIS",
    "DCTStem",
    "L2Normalization",
    "MODEL_REGISTRY",
    "ResNet50DCT",
    "ResNet50RGB",
    "ResNetBlocks",
    "SSDResNetCustom",
    "build_model",
    "make_inference_fn",
    "ssd_predictor_sizes",
]
