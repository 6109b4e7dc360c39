"""MS COCO results-JSON writer.

Role of `localisation_part/eval_utils/coco_utils.py:62+`
(`predict_all_to_json`): serialize detections in the COCO results format
`[{image_id, category_id, bbox: [x, y, w, h], score}, ...]`, mapping our
contiguous class ids back to original COCO category ids.
"""

from __future__ import annotations

import json


def detections_to_coco_json(
    predictions_per_class: list,
    out_path: str,
    contiguous_to_cat: dict[int, int] | None = None,
):
    """predictions_per_class: index 1..n of (image_id, conf, xmin, ymin,
    xmax, ymax) tuples (the evaluator's accumulation format).

    `contiguous_to_cat` maps our 1-based contiguous ids to COCO category ids
    (inverse of `parse_coco_json`'s mapping); identity when None.
    """
    results = []
    for cls in range(1, len(predictions_per_class)):
        cat_id = (
            contiguous_to_cat[cls] if contiguous_to_cat is not None else cls
        )
        for image_id, conf, xmin, ymin, xmax, ymax in (
            predictions_per_class[cls]
        ):
            try:
                image_id = int(image_id)
            except (TypeError, ValueError):
                pass
            results.append(
                {
                    "image_id": image_id,
                    "category_id": int(cat_id),
                    "bbox": [
                        round(float(xmin), 2),
                        round(float(ymin), 2),
                        round(float(xmax - xmin), 2),
                        round(float(ymax - ymin), 2),
                    ],
                    "score": round(float(conf), 5),
                }
            )
    with open(out_path, "w") as f:
        json.dump(results, f)
    return results
