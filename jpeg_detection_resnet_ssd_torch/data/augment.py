"""Label-aware image ops of the evaluation path.

The part of the JAX package's `data/augment.py` that evaluation and `infer`
use: `to_3_channels` and `resize` with its inverter (a callable mapping
predicted boxes back to original image coordinates).  The host training
chain (`SSDDataAugmentation` and its photometric, expand and crop ops) is
ROADMAP A10b.  cv2 is imported inside `resize`, so the package imports where
OpenCV is not installed.

Labels layout: (class_id, xmin, ymin, xmax, ymax) absolute pixel corners.
"""

from __future__ import annotations

import numpy as np


def to_3_channels(image):
    if image.ndim == 2:
        return np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 1:
        return np.concatenate([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        return image[..., :3]
    return image


def resize(image, labels, height, width, interpolation=None,
           filter_degenerate=True, return_inverter=False):
    """Resize + box rescale + optional degenerate-box drop (`Resize`).

    `interpolation` None means `cv2.INTER_LINEAR`."""
    import cv2

    h0, w0 = image.shape[:2]
    interp = interpolation if interpolation is not None else cv2.INTER_LINEAR
    out = cv2.resize(image, (width, height), interpolation=interp)
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        labels[:, [1, 3]] *= width / w0
        labels[:, [2, 4]] *= height / h0
        if filter_degenerate:
            keep = (labels[:, 3] - labels[:, 1] > 0) & (
                labels[:, 4] - labels[:, 2] > 0
            )
            labels = labels[keep]

    def inverter(boxes):
        """boxes (m, >=5) with coords in the last four columns."""
        boxes = np.asarray(boxes, np.float32).copy()
        boxes[:, -4] *= w0 / width
        boxes[:, -2] *= w0 / width
        boxes[:, -3] *= h0 / height
        boxes[:, -1] *= h0 / height
        return boxes

    if return_inverter:
        return out, labels, inverter
    return out, labels
