"""Datasets, the JPEG -> DCT input transform and the detection pipeline.

The names of the JAX package's `data/__init__.py` that are ported; the
classification pipeline, `prefetch_to_device` and the packed DCT corpus are
ROADMAP A10b.  Nothing here imports PIL, cv2 or h5py at module level.
"""

from jpeg_detection_resnet_ssd_torch.data.datasets import (
    VOC_CLASSES,
    DetectionDataset,
    ImageFolderDataset,
    parse_coco_json,
    parse_detection_csv,
    parse_voc_xml,
)
from jpeg_detection_resnet_ssd_torch.data.dct_convert import (
    rgb_to_dct_image,
    rgb_to_dct_tensors,
    split_cbcr,
)
from jpeg_detection_resnet_ssd_torch.data.pipeline import DetectionPipeline

__all__ = [
    "VOC_CLASSES",
    "DetectionDataset",
    "DetectionPipeline",
    "ImageFolderDataset",
    "parse_coco_json",
    "parse_detection_csv",
    "parse_voc_xml",
    "rgb_to_dct_image",
    "rgb_to_dct_tensors",
    "split_cbcr",
]
