"""Pascal VOC mAP evaluation: prediction matching, PR curves, AP, mAP.

Counterpart of the JAX package's `eval/map_eval.py`: the same NumPy matching
and AP code (greedy confidence-sorted matching per class; 'difficult' GT is
evaluation-neutral; 'include' border IoU, with the reference evaluator's
mixed formula under `intersection_border='half'`; 11-point 'sample' and
'integrate' AP; mAP the unweighted class mean), and an evaluator whose
inference function runs on the card: forward + decode return a tensor,
which `predict_on_dataset` waits for and takes to the host.
"""

from __future__ import annotations

import numpy as np
import torch


_BORDER_D = {"half": 0.0, "include": 1.0, "exclude": -1.0}


def _iou_one_to_many(box, boxes, border: str = "include",
                     intersection_border: str | None = None):
    """One-vs-many corner-box IoU.

    `intersection_border` (default: same as `border`) exists to replicate a
    reference quirk bit-for-bit: `bounding_box_utils.iou` forgets to forward
    `border_pixels` to `intersection_area_` (`bounding_box_utils.py:348`), so
    the reference evaluator's 'include' matching actually uses a MIXED
    formula — box areas with +1, intersection with +0.  The official VOC
    devkit uses +1 consistently (as does `eval_utils/utils.py:5-35`), so the
    consistent formula is the default here; pass `intersection_border='half'`
    for exact parity with `average_precision_evaluator.py` matching
    (pinned by `tests/test_reference_parity.py`).
    """
    d = _BORDER_D[border]
    di = d if intersection_border is None else _BORDER_D[intersection_border]
    ix = np.maximum(
        0.0, np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]) + di
    )
    iy = np.maximum(
        0.0, np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]) + di
    )
    inter = ix * iy
    a = (box[2] - box[0] + d) * (box[3] - box[1] + d)
    b = (boxes[:, 2] - boxes[:, 0] + d) * (boxes[:, 3] - boxes[:, 1] + d)
    union = a + b - inter
    return np.where(union > 0, inter / union, 0.0)


def num_gt_per_class(ground_truth: dict, n_classes: int,
                     ignore_neutral: bool = True) -> np.ndarray:
    """ground_truth: {image_id: (boxes (k,5), neutral (k,) bool)}.
    Returns counts indexed 0..n_classes (index 0 = background, unused)."""
    counts = np.zeros(n_classes + 1, dtype=np.int64)
    for boxes, neutral in ground_truth.values():
        for j in range(len(boxes)):
            if ignore_neutral and neutral[j]:
                continue
            counts[int(boxes[j, 0])] += 1
    return counts


def match_predictions(
    predictions_per_class: list,
    ground_truth: dict,
    n_classes: int,
    matching_iou_threshold: float = 0.5,
    border_pixels: str = "include",
    ignore_neutral: bool = True,
    intersection_border: str | None = None,
):
    """Match per-class prediction lists against GT.

    `intersection_border='half'` reproduces the reference evaluator's mixed
    IoU formula exactly (see `_iou_one_to_many`).

    predictions_per_class: index 1..n_classes of lists of
      (image_id, confidence, xmin, ymin, xmax, ymax).
    ground_truth: {image_id: (boxes (k,5) [cls,4 corners], neutral (k,) bool)}.

    Returns (cum_tp, cum_fp): per-class cumulative TP/FP arrays over
    confidence-sorted predictions (lists indexed 0..n_classes).
    """
    cum_tp: list = [np.zeros(0, np.int64)]
    cum_fp: list = [np.zeros(0, np.int64)]
    for class_id in range(1, n_classes + 1):
        preds = predictions_per_class[class_id]
        tp = np.zeros(len(preds), np.int64)
        fp = np.zeros(len(preds), np.int64)
        if len(preds) == 0:
            cum_tp.append(tp)
            cum_fp.append(fp)
            continue
        confs = np.array([p[1] for p in preds], np.float32)
        order = np.argsort(-confs, kind="stable")
        gt_matched: dict = {}
        for rank, pi in enumerate(order):
            image_id, conf, xmin, ymin, xmax, ymax = preds[pi]
            entry = ground_truth.get(image_id)
            if entry is None:
                fp[rank] = 1
                continue
            boxes, neutral = entry
            mask = boxes[:, 0] == class_id
            gt = boxes[mask]
            neu = neutral[mask]
            if gt.shape[0] == 0:
                fp[rank] = 1
                continue
            overlaps = _iou_one_to_many(
                np.array([xmin, ymin, xmax, ymax], np.float64),
                gt[:, 1:5].astype(np.float64),
                border_pixels,
                intersection_border,
            )
            g = int(np.argmax(overlaps))
            if overlaps[g] < matching_iou_threshold:
                fp[rank] = 1
            elif ignore_neutral and neu[g]:
                pass  # evaluation-neutral: neither TP nor FP
            else:
                matched = gt_matched.setdefault(
                    (image_id, class_id), np.zeros(gt.shape[0], bool)
                )
                if matched[g]:
                    fp[rank] = 1  # duplicate detection
                else:
                    matched[g] = True
                    tp[rank] = 1
        cum_tp.append(np.cumsum(tp))
        cum_fp.append(np.cumsum(fp))
    return cum_tp, cum_fp


def precision_recall(cum_tp, cum_fp, n_gt: int):
    denom = cum_tp + cum_fp
    precision = np.where(denom > 0, cum_tp / np.maximum(denom, 1), 0.0)
    recall = cum_tp / max(n_gt, 1) if n_gt > 0 else np.zeros_like(
        cum_tp, np.float64
    )
    return precision, recall


def average_precision(precision, recall, mode: str = "integrate",
                      num_recall_points: int = 11) -> float:
    """Pascal AP: 'sample' (pre-2010 11-point) or 'integrate' (post-2010)."""
    precision = np.asarray(precision, np.float64)
    recall = np.asarray(recall, np.float64)
    if precision.size == 0:
        return 0.0
    if mode == "sample":
        ap = 0.0
        for t in np.linspace(0, 1, num_recall_points, endpoint=True):
            mask = recall >= t
            ap += precision[mask].max() if mask.any() else 0.0
        return ap / num_recall_points
    if mode == "integrate":
        uniq, idx = np.unique(recall, return_index=True)
        if uniq.size < 2:
            return 0.0
        max_prec = np.zeros_like(uniq)
        deltas = np.zeros_like(uniq)
        for i in range(len(uniq) - 2, -1, -1):
            begin, end = idx[i], idx[i + 1]
            max_prec[i] = max(precision[begin:end].max(), max_prec[i + 1])
            deltas[i] = uniq[i + 1] - uniq[i]
        return float(np.sum(max_prec * deltas))
    raise ValueError(f"unknown AP mode {mode!r}")



def _to_host(out) -> np.ndarray:
    """The infer function's output as a NumPy array: a CUDA tensor is waited
    for (as `jax.block_until_ready` waits in the JAX package) and copied to
    the host."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out.cpu().numpy()
    return np.asarray(out)

class DetectionEvaluator:
    """End-to-end mAP evaluation: batched device inference + host matching.

    Role of the reference's `Evaluator.__call__`.

    Args:
      infer_fn: (inputs) -> (B, top_k, 6) decoded detections
        `[class_id, conf, xmin, ymin, xmax, ymax]` (zero rows = padding), a
        tensor (on the card or the CPU) or a NumPy array -- typically
        `lambda x: decode(model(x))` under `torch.no_grad()`.
      pipeline: a `DetectionPipeline` in eval mode (encoder=None), yielding
        inputs + labels + image_ids + inverters.
      n_classes: number of positive classes.
    """

    def __init__(self, infer_fn, pipeline, n_classes: int = 20):
        self.infer_fn = infer_fn
        self.pipeline = pipeline
        self.n_classes = n_classes
        self.prediction_results = None
        self.ground_truth = None

    def predict_on_dataset(self, confidence_thresh_low: float = 0.0):
        preds_per_class = [[] for _ in range(self.n_classes + 1)]
        ground_truth = {}
        for batch in self.pipeline:
            out = _to_host(self.infer_fn(batch["inputs"]))
            for i, image_id in enumerate(batch["image_ids"]):
                rows = out[i]
                rows = rows[rows[:, 1] > confidence_thresh_low]
                inverter = batch["inverters"][i]
                if inverter is not None and len(rows):
                    rows = inverter(rows)
                for row in rows:
                    cls = int(row[0])
                    if 1 <= cls <= self.n_classes:
                        preds_per_class[cls].append(
                            (str(image_id), float(row[1]), *map(float, row[2:6]))
                        )
                boxes = np.asarray(batch["labels"][i], np.float64).reshape(-1, 5)
                difficult = batch.get("difficult")
                neutral_i = (
                    np.asarray(difficult[i], bool)
                    if difficult is not None
                    else np.zeros(len(boxes), bool)
                )
                ground_truth[str(image_id)] = (boxes, neutral_i)
        self.prediction_results = preds_per_class
        self.ground_truth = ground_truth
        return preds_per_class

    def __call__(
        self,
        matching_iou_threshold: float = 0.5,
        border_pixels: str = "include",
        average_precision_mode: str = "integrate",
        num_recall_points: int = 11,
        ignore_neutral: bool = True,
        intersection_border: str | None = None,
    ):
        """Returns (mAP, per-class APs list indexed 0..n_classes,
        per-class (precisions, recalls))."""
        if self.prediction_results is None:
            self.predict_on_dataset()
        n_gt = num_gt_per_class(
            self.ground_truth, self.n_classes, ignore_neutral
        )
        cum_tp, cum_fp = match_predictions(
            self.prediction_results,
            self.ground_truth,
            self.n_classes,
            matching_iou_threshold,
            border_pixels,
            ignore_neutral,
            intersection_border,
        )
        aps = [0.0]
        prs = [([], [])]
        for c in range(1, self.n_classes + 1):
            prec, rec = precision_recall(cum_tp[c], cum_fp[c], int(n_gt[c]))
            aps.append(
                average_precision(
                    prec, rec, average_precision_mode, num_recall_points
                )
            )
            prs.append((prec, rec))
        mean_ap = float(np.mean(aps[1:]))
        return mean_ap, aps, prs
