"""Pascal VOC detection result files (`comp3_det_test_<class>.txt`).

Role of `Evaluator.write_predictions_to_txt`
(`eval_utils/average_precision_evaluator.py:429-492`) and the offline
reader side of `compute_map.py`.  Format: one line per detection,
`<image_id> <confidence> <xmin> <ymin> <xmax> <ymax>`.

Unlike the reference (which WIPES the output directory, `:468-471`), existing
unrelated files are left alone; only the per-class files are rewritten.
"""

from __future__ import annotations

import os

from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES


def write_voc_detection_files(
    predictions_per_class: list,
    out_dir: str,
    classes=VOC_CLASSES,
    prefix: str = "comp3_det_test_",
):
    """predictions_per_class: index 1..n of lists of
    (image_id, conf, xmin, ymin, xmax, ymax)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for class_id, name in enumerate(classes, start=1):
        path = os.path.join(out_dir, f"{prefix}{name}.txt")
        with open(path, "w") as f:
            for image_id, conf, xmin, ymin, xmax, ymax in (
                predictions_per_class[class_id]
            ):
                f.write(
                    f"{image_id} {conf:.6f} {xmin:.1f} {ymin:.1f} "
                    f"{xmax:.1f} {ymax:.1f}\n"
                )
        paths.append(path)
    return paths


def read_voc_detection_files(
    result_dir: str,
    classes=VOC_CLASSES,
    prefix: str = "comp3_det_test_",
):
    """Inverse of `write_voc_detection_files` (for offline mAP computation,
    the `compute_map.py` entry point)."""
    preds = [[] for _ in range(len(classes) + 1)]
    for class_id, name in enumerate(classes, start=1):
        path = os.path.join(result_dir, f"{prefix}{name}.txt")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 6:
                    continue
                preds[class_id].append(
                    (
                        parts[0],
                        float(parts[1]),
                        float(parts[2]),
                        float(parts[3]),
                        float(parts[4]),
                        float(parts[5]),
                    )
                )
    return preds
