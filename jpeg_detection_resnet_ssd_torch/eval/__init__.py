"""Detection mAP evaluation, result writers and the classification
evaluator: the names of the JAX package's `eval/__init__.py`."""

from jpeg_detection_resnet_ssd_torch.eval.imagenet_eval import (
    ClassificationEvaluator,
    count_params,
    timed_runs,
)
from jpeg_detection_resnet_ssd_torch.eval.map_eval import (
    DetectionEvaluator,
    average_precision,
    match_predictions,
    num_gt_per_class,
)
from jpeg_detection_resnet_ssd_torch.eval.voc_writer import (
    read_voc_detection_files,
    write_voc_detection_files,
)

__all__ = [
    "ClassificationEvaluator",
    "DetectionEvaluator",
    "average_precision",
    "count_params",
    "match_predictions",
    "num_gt_per_class",
    "read_voc_detection_files",
    "timed_runs",
    "write_voc_detection_files",
]
