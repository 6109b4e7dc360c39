"""The SSD300 detector families and the ResNet-50 and VGG classifiers in
PyTorch (NHWC contracts)."""

from jpeg_detection_resnet_ssd_torch.models.layers import L2Normalization
from jpeg_detection_resnet_ssd_torch.models.resnet import (
    CLASSIFICATION_ARCHIS,
    DCTStem,
    ResNet50DCT,
    ResNet50RGB,
    ResNetBlocks,
)
from jpeg_detection_resnet_ssd_torch.models.ssd import (
    SSDVGG,
    SSDVGGDCT,
    SSDResNetCustom,
    SSDResNetIdentical,
    SSDVGGDCTImage,
    make_inference_fn,
    ssd_predictor_sizes,
)
from jpeg_detection_resnet_ssd_torch.models.vgg import VGG, VGGDCT, VGGDCT8x8
from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY, build_model, ssd_family

__all__ = [
    "CLASSIFICATION_ARCHIS",
    "DCTStem",
    "L2Normalization",
    "MODEL_REGISTRY",
    "ResNet50DCT",
    "ResNet50RGB",
    "ResNetBlocks",
    "SSDResNetCustom",
    "SSDResNetIdentical",
    "SSDVGG",
    "SSDVGGDCT",
    "SSDVGGDCTImage",
    "VGG",
    "VGGDCT",
    "VGGDCT8x8",
    "build_model",
    "make_inference_fn",
    "ssd_family",
    "ssd_predictor_sizes",
]
