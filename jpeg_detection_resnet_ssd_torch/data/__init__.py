"""Datasets, the JPEG -> DCT input transform, the detection and
classification pipelines with their host augmentation, and the packed DCT
corpus.

The names of the JAX package's `data/__init__.py`.  Nothing here imports
PIL, cv2 or h5py at module level.
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
from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset, PackedDctPipeline
from jpeg_detection_resnet_ssd_torch.data.pipeline import (
    ClassificationPipeline,
    DetectionPipeline,
    DeviceDCTAugmentedPipeline,
    prefetch_to_device,
)

__all__ = [
    "VOC_CLASSES",
    "ClassificationPipeline",
    "DetectionDataset",
    "DetectionPipeline",
    "DeviceDCTAugmentedPipeline",
    "ImageFolderDataset",
    "PackedDctDataset",
    "PackedDctPipeline",
    "parse_coco_json",
    "parse_detection_csv",
    "parse_voc_xml",
    "prefetch_to_device",
    "rgb_to_dct_image",
    "rgb_to_dct_tensors",
    "split_cbcr",
]
