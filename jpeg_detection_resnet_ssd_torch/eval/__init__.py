"""Detection mAP evaluation and result writers.

The names of the JAX package's `eval/__init__.py` that are ported; the
classification evaluator (`ClassificationEvaluator`, `timed_runs`) is
ROADMAP A12.
"""

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
    "DetectionEvaluator",
    "average_precision",
    "match_predictions",
    "num_gt_per_class",
    "read_voc_detection_files",
    "write_voc_detection_files",
]
