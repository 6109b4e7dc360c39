"""Hand-written CUDA kernels with their plain PyTorch versions, and the
device DCT augmentation chain.

Kernel sources live in `csrc/` and are built by `_build` with nvcc at first
use.  The names below are those the JAX package's `ops/__init__.py` exports.
"""

from jpeg_detection_resnet_ssd_torch.ops.batched_nms import (
    batched_nms_mask,
    batched_nms_mask_reference,
)
from jpeg_detection_resnet_ssd_torch.ops.block_dct import (
    DCT_BASIS_8,
    dct2_8x8,
    idct2_8x8,
)
# `ops.bipartite_match` is the module (its function of the same name is not
# re-exported here, so the module and its LAUNCHES stay reachable).
from jpeg_detection_resnet_ssd_torch.ops.conv_grad import (
    conv3x3_filter_grad,
    conv3x3_filter_grad_reference,
    conv3x3_same_wgrad,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_augment import (
    dct_brightness_contrast,
    dct_chroma_hue_saturation,
    dct_crop_blocks,
    dct_downscale_2x,
    dct_flip_horizontal,
    dct_flip_vertical,
    dct_random_crop_flip,
    dct_random_photometric,
    make_dct_classification_augment,
    make_dct_classification_augment_v2,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_detect_augment import (
    dct_detection_crop_flip,
    dct_detection_expand,
    dct_detection_min_iou_crop_flip,
    dct_detection_random_resized_crop,
    make_dct_detection_augment,
    make_dct_detection_augment_v2,
    make_dct_detection_augment_v3,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_resize import (
    dct_crop_resize,
    dct_resample,
    interp_matrix,
)
from jpeg_detection_resnet_ssd_torch.ops.jpeg_quant import (
    jpeg_requantize,
    quant_tables,
)
from jpeg_detection_resnet_ssd_torch.ops.pixel_photometric import (
    dct_pixel_photometric,
    dct_pixel_photometric_apply,
)

__all__ = [
    "DCT_BASIS_8",
    "batched_nms_mask",
    "batched_nms_mask_reference",
    "conv3x3_filter_grad",
    "conv3x3_filter_grad_reference",
    "conv3x3_same_wgrad",
    "dct2_8x8",
    "dct_brightness_contrast",
    "dct_chroma_hue_saturation",
    "dct_crop_blocks",
    "dct_crop_resize",
    "dct_detection_crop_flip",
    "dct_detection_expand",
    "dct_detection_min_iou_crop_flip",
    "dct_detection_random_resized_crop",
    "dct_downscale_2x",
    "dct_flip_horizontal",
    "dct_flip_vertical",
    "dct_pixel_photometric",
    "dct_pixel_photometric_apply",
    "dct_random_crop_flip",
    "dct_random_photometric",
    "dct_resample",
    "idct2_8x8",
    "interp_matrix",
    "jpeg_requantize",
    "make_dct_classification_augment",
    "make_dct_classification_augment_v2",
    "make_dct_detection_augment",
    "make_dct_detection_augment_v2",
    "make_dct_detection_augment_v3",
    "quant_tables",
]
