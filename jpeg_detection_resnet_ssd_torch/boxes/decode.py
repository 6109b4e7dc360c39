"""Prediction decoding + per-class greedy NMS as batched torch ops.

Counterpart of the JAX package's `boxes/decode.py`: the "Caffe-style"
procedure -- per-class confidence threshold -> per-class greedy NMS ->
global top-k -- on padded, masked tensors.  Suppressed or sub-threshold
slots carry score 0 and come out as zero rows.

Top-k order.  `lax.top_k` puts the lower index first among equal values, and
ties are common (a saturated head rounds many scores to exactly 1.0 in f32).
`torch.topk` promises no tie order, so every selection here is a stable
descending sort, sliced.
"""

from __future__ import annotations

import torch

from jpeg_detection_resnet_ssd_torch.boxes import geometry
from jpeg_detection_resnet_ssd_torch.ops.batched_nms import (
    batched_nms_mask,
    batched_nms_mask_reference,
)

NMS_IMPLS = ("auto", "kernel", "reference")
CANDIDATE_SELECTORS = ("exact", "shared", "approx")


def sorted_top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`lax.top_k` over the last axis: descending, lower index first on ties."""
    if k > x.shape[-1]:
        raise ValueError(f"sorted_top_k: k={k} exceeds the axis size {x.shape[-1]}")
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def decode_raw_predictions(
    y_pred: torch.Tensor,
    *,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: int | None = None,
    img_width: int | None = None,
    log_scale_offsets: bool = True,
):
    """Convert raw SSD output offsets to absolute corner boxes + class scores.

    Args:
      y_pred: (..., n_boxes, n_classes + 12) -- [class scores, 4 offsets,
        4 anchor coords, 4 variances].

    Returns:
      (scores, boxes): (..., n_boxes, n_classes) scores and (..., n_boxes, 4)
      corner boxes (absolute pixels if `normalize_coords`).
    """
    scores = y_pred[..., :-12]
    offs = y_pred[..., -12:-8]
    anchors = y_pred[..., -8:-4]
    variances = y_pred[..., -4:]

    if input_coords != "centroids":
        raise NotImplementedError("only 'centroids' in-model coords supported")
    cxa, cya, wa, ha = anchors.unbind(-1)
    cx = offs[..., 0] * variances[..., 0] * wa + cxa
    cy = offs[..., 1] * variances[..., 1] * ha + cya
    if log_scale_offsets:
        w = torch.exp(offs[..., 2] * variances[..., 2]) * wa
        h = torch.exp(offs[..., 3] * variances[..., 3]) * ha
    else:
        # The `_no_log` encoder variant stored raw w/h ratios, not their logs.
        w = offs[..., 2] * variances[..., 2] * wa
        h = offs[..., 3] * variances[..., 3] * ha
    boxes = geometry.centroids_to_corners(torch.stack([cx, cy, w, h], dim=-1))
    if normalize_coords:
        if img_height is None or img_width is None:
            raise ValueError("img_height/img_width required with normalize_coords")
        scale = torch.tensor(
            [img_width, img_height, img_width, img_height],
            dtype=boxes.dtype,
            device=boxes.device,
        )
        boxes = boxes * scale
    return scores, boxes


def _nms_fn(nms_impl: str, device: torch.device):
    """The greedy-NMS mask function `nms_impl` names: 'auto' is
    `batched_nms_mask`, the custom operator (the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor; one node in a `torch.export`
    graph, which dispatches by device when it runs), 'kernel' the same but
    only for a CUDA tensor, and 'reference' the plain version on either
    device (traced op by op)."""
    if nms_impl not in NMS_IMPLS:
        raise ValueError(f"nms_impl must be one of {NMS_IMPLS}, got {nms_impl!r}")
    if nms_impl == "kernel" and device.type != "cuda":
        raise ValueError(f"nms_impl='kernel' needs a CUDA tensor, got {device}")
    return batched_nms_mask_reference if nms_impl == "reference" else batched_nms_mask


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, ..., idx[b, ..., j], :] -- `take_along_axis` on the row axis."""
    return torch.gather(x, idx.dim() - 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def select_candidates(
    y_pred: torch.Tensor,
    *,
    n_classes: int,
    confidence_thresh: float = 0.01,
    nms_max_output_size: int = 400,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: int = 300,
    img_width: int = 300,
    candidate_selector: str = "exact",
    shared_pool_size: int = 1024,
    pool_topk_impl: str = "sort",
):
    """Per-(image, class) confidence threshold + top-k: the NMS input.

    Returns (top_scores, top_boxes) of shapes (B, C, k) and (B, C, k, 4),
    each (image, class) row sorted by descending score, 0 for empty slots.

    `candidate_selector` 'shared' first keeps one pool of the
    `shared_pool_size` boxes with the best positive-class score per image
    and decodes only those (see the JAX package's `decode_detections`).
    'approx' (and `pool_topk_impl='approx'`) named `lax.approx_max_k`, a
    TPU-only partial reduction; off the TPU that computes the exact top-k,
    and so does the port.
    """
    if candidate_selector not in CANDIDATE_SELECTORS:
        raise ValueError(
            f"candidate_selector must be one of {CANDIDATE_SELECTORS}, "
            f"got {candidate_selector!r}"
        )
    if pool_topk_impl not in ("sort", "approx"):
        raise ValueError(f"pool_topk_impl must be 'sort' or 'approx', got {pool_topk_impl!r}")
    n_boxes = y_pred.shape[1]
    C = n_classes
    k = min(nms_max_output_size, n_boxes)
    zero = y_pred.new_zeros(())
    decode_kw = dict(
        input_coords=input_coords,
        normalize_coords=normalize_coords,
        img_height=img_height,
        img_width=img_width,
    )

    if candidate_selector == "shared":
        M = min(shared_pool_size, n_boxes)
        pos_scores = y_pred[..., 1 : C + 1]  # (B, n_boxes, C)
        box_best = torch.where(pos_scores > confidence_thresh, pos_scores, zero).amax(-1)
        _, pool_idx = sorted_top_k(box_best, M)  # (B, M)
        pool_pred = _gather_rows(y_pred, pool_idx)  # (B, M, C+1+12)
        pool_all_scores, boxes = decode_raw_predictions(pool_pred, **decode_kw)
        pos = pool_all_scores[..., 1 : C + 1].movedim(-1, 1)  # (B, C, M)
        k = min(k, M)
    else:
        scores, boxes = decode_raw_predictions(y_pred, **decode_kw)
        pos = scores[..., 1 : C + 1].movedim(-1, 1)  # (B, C, n_boxes)
    masked = torch.where(pos > confidence_thresh, pos, zero)
    top_scores, top_idx = sorted_top_k(masked, k)  # (B, C, k)
    top_boxes = _gather_rows(boxes[:, None].expand(-1, C, -1, -1), top_idx)
    return top_scores.contiguous(), top_boxes


def decode_detections(
    y_pred: torch.Tensor,
    *,
    n_classes: int,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: int = 300,
    img_width: int = 300,
    border_pixels: str = "half",
    nms_impl: str = "auto",
    candidate_selector: str = "exact",
    shared_pool_size: int = 1024,
    pool_topk_impl: str = "sort",
) -> torch.Tensor:
    """Full batched decode: (B, n_boxes, n_cls+1+12) -> (B, top_k, 6).

    Output rows are `[class_id, confidence, xmin, ymin, xmax, ymax]` sorted by
    descending confidence, zero-padded.  `n_classes` is the number of
    POSITIVE classes (background excluded).

    `nms_impl`: 'auto' launches the CUDA kernel on a CUDA tensor and runs the
    plain version on a CPU tensor; 'kernel' launches the kernel and raises on
    the CPU; 'reference' runs the plain version on either device.
    """
    nms = _nms_fn(nms_impl, y_pred.device)
    B = y_pred.shape[0]
    C = n_classes
    top_scores, top_boxes = select_candidates(
        y_pred,
        n_classes=n_classes,
        confidence_thresh=confidence_thresh,
        nms_max_output_size=nms_max_output_size,
        input_coords=input_coords,
        normalize_coords=normalize_coords,
        img_height=img_height,
        img_width=img_width,
        candidate_selector=candidate_selector,
        shared_pool_size=shared_pool_size,
        pool_topk_impl=pool_topk_impl,
    )
    k = top_scores.shape[-1]
    keep = nms(
        top_boxes.reshape(B * C, k, 4),
        top_scores.reshape(B * C, k),
        iou_threshold=iou_threshold,
        border_delta=geometry.border_delta(border_pixels),
    ).reshape(B, C, k)

    zero = top_scores.new_zeros(())
    kept_scores = torch.where(keep, top_scores, zero)  # (B, C, k)
    class_ids = torch.arange(1, C + 1, dtype=torch.float32, device=y_pred.device)
    flat_cls = class_ids[None, :, None].expand(B, C, k).reshape(B, -1)
    flat_scores = kept_scores.reshape(B, -1)
    flat_boxes = top_boxes.reshape(B, -1, 4)
    best, idx = sorted_top_k(flat_scores, top_k)  # (B, top_k)
    alive = best > 0
    return torch.cat(
        [
            torch.where(alive, torch.gather(flat_cls, 1, idx), zero)[..., None],
            best[..., None],
            torch.where(alive[..., None], _gather_rows(flat_boxes, idx), zero),
        ],
        dim=-1,
    )


def nms_per_class(
    boxes: torch.Tensor,
    class_scores: torch.Tensor,
    *,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    nms_max_output_size: int = 400,
    border_pixels: str = "half",
    nms_impl: str = "auto",
):
    """Confidence-threshold + greedy NMS for ONE class over one image.

    boxes (n, 4) corners, class_scores (n,).  Returns (scores, boxes) of
    length min(nms_max_output_size, n), sorted by descending score, with the
    suppressed and sub-threshold scores set to 0.  The NMS is one problem of
    `batched_nms_mask` (`nms_impl` as in `decode_detections`).
    """
    nms = _nms_fn(nms_impl, boxes.device)
    masked = torch.where(class_scores > confidence_thresh, class_scores, class_scores.new_zeros(()))
    k = min(nms_max_output_size, masked.shape[0])
    top_scores, top_idx = sorted_top_k(masked, k)
    top_boxes = boxes[top_idx]
    keep = nms(
        top_boxes[None].contiguous(),
        top_scores[None].contiguous(),
        iou_threshold=iou_threshold,
        border_delta=geometry.border_delta(border_pixels),
    )[0]
    return torch.where(keep, top_scores, top_scores.new_zeros(())), top_boxes


def decode_detections_debug(
    y_pred: torch.Tensor,
    *,
    n_classes: int,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    normalize_coords: bool = True,
    img_height: int = 300,
    img_width: int = 300,
    border_pixels: str = "half",
    nms_impl: str = "auto",
) -> torch.Tensor:
    """Anchor-index-preserving decode for debugging: the processing of
    `decode_detections` (exact selector), but each output row is
    `[box_id, class_id, confidence, xmin, ymin, xmax, ymax]`, where `box_id`
    is the box's index among the model's n_boxes predictions (which names
    the predictor layer that made it).  (B, top_k, 7), zero-padded.  The
    NMS is B * n_classes problems of `batched_nms_mask`.
    """
    nms = _nms_fn(nms_impl, y_pred.device)
    scores, boxes = decode_raw_predictions(
        y_pred,
        normalize_coords=normalize_coords,
        img_height=img_height,
        img_width=img_width,
    )
    B, n_boxes = boxes.shape[0], boxes.shape[1]
    C = n_classes
    k = min(nms_max_output_size, n_boxes)
    zero = scores.new_zeros(())

    pos = scores[..., 1 : C + 1].movedim(-1, 1)  # (B, C, n_boxes)
    masked = torch.where(pos > confidence_thresh, pos, zero)
    top_scores, top_idx = sorted_top_k(masked, k)  # (B, C, k)
    top_boxes = _gather_rows(boxes[:, None].expand(-1, C, -1, -1), top_idx)
    keep = nms(
        top_boxes.reshape(B * C, k, 4),
        top_scores.reshape(B * C, k).contiguous(),
        iou_threshold=iou_threshold,
        border_delta=geometry.border_delta(border_pixels),
    ).reshape(B, C, k)
    kept_scores = torch.where(keep, top_scores, zero)

    class_ids = torch.arange(1, C + 1, dtype=torch.float32, device=y_pred.device)
    flat_cls = class_ids[None, :, None].expand(B, C, k).reshape(B, -1)
    flat_scores = kept_scores.reshape(B, -1)
    flat_boxes = top_boxes.reshape(B, -1, 4)
    flat_box_id = top_idx.reshape(B, -1).to(torch.float32)
    best, idx = sorted_top_k(flat_scores, top_k)  # (B, top_k)
    alive = best > 0
    return torch.cat(
        [
            torch.where(alive, torch.gather(flat_box_id, 1, idx), zero)[..., None],
            torch.where(alive, torch.gather(flat_cls, 1, idx), zero)[..., None],
            best[..., None],
            torch.where(alive[..., None], _gather_rows(flat_boxes, idx), zero),
        ],
        dim=-1,
    )


def decode_detections_fast(
    y_pred: torch.Tensor,
    *,
    confidence_thresh: float = 0.5,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    input_coords: str = "centroids",
    normalize_coords: bool = True,
    img_height: int = 300,
    img_width: int = 300,
    border_pixels: str = "half",
    log_scale_offsets: bool = True,
    nms_impl: str = "auto",
) -> torch.Tensor:
    """Fast decode: argmax class first, ONE class-agnostic NMS per image.

    Each box keeps only its argmax class and confidence; boxes whose argmax
    is the background are dropped; one NMS runs over each image's surviving
    boxes regardless of class (B problems of `batched_nms_mask`); then the
    top-k.  Output layout as `decode_detections`: (B, top_k, 6).
    """
    nms = _nms_fn(nms_impl, y_pred.device)
    scores, boxes = decode_raw_predictions(
        y_pred,
        input_coords=input_coords,
        normalize_coords=normalize_coords,
        img_height=img_height,
        img_width=img_width,
        log_scale_offsets=log_scale_offsets,
    )
    zero = scores.new_zeros(())
    cls = scores.argmax(dim=-1)  # (B, n_boxes), background included; the first maximum
    conf = scores.amax(dim=-1)
    valid = (cls != 0) & (conf > confidence_thresh)
    masked = torch.where(valid, conf, zero)
    k = min(nms_max_output_size, masked.shape[-1])
    top_scores, top_idx = sorted_top_k(masked, k)  # (B, k)
    top_boxes = _gather_rows(boxes, top_idx)  # (B, k, 4)
    top_cls = torch.gather(cls, 1, top_idx).to(torch.float32)
    keep = nms(
        top_boxes.contiguous(),
        top_scores.contiguous(),
        iou_threshold=iou_threshold,
        border_delta=geometry.border_delta(border_pixels),
    )
    kept_scores = torch.where(keep, top_scores, zero)
    best, idx = sorted_top_k(kept_scores, min(top_k, k))
    alive = best > 0
    rows = torch.cat(
        [
            torch.where(alive, torch.gather(top_cls, 1, idx), zero)[..., None],
            best[..., None],
            torch.where(alive[..., None], _gather_rows(top_boxes, idx), zero),
        ],
        dim=-1,
    )
    if top_k > k:  # pad to the requested top_k
        rows = torch.nn.functional.pad(rows, (0, 0, 0, top_k - k))
    return rows
