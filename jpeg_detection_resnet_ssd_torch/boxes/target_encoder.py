"""SSD ground truth -> training targets, batched, on the device.

Counterpart of the JAX package's `boxes/target_encoder.py`, batched over B
natively (the JAX function is written per image and vmapped).  Padded GT
rows `(class_id, xmin, ymin, xmax, ymax)` in absolute pixel corners, with a
validity mask, become the `(B, n_anchors, n_classes + 1 + 12)` target
tensor [one-hot classes, 4 offsets, 4 anchor centroids, 4 variances]:

  1. every anchor starts as background;
  2. greedy bipartite matching gives every valid GT box one anchor
     (`ops.bipartite_match`, the CUDA kernel on the card);
  3. 'multi' matching gives every other anchor with IoU >=
     pos_iou_threshold its best GT;
  4. the other anchors with IoU >= neg_iou_limit to some GT are neutral
     (all-zero one-hot, ignored by the loss);
  5. matched boxes become variance-scaled centroid offsets.

The JAX package gathers the matched GT rows with one-hot matmuls (fast on
its matrix unit); here they are gathers, which give the same float32 values
(each one-hot product has a single nonzero term).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.boxes import geometry, matching
from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.ops.bipartite_match import IMPLS, bipartite_match
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device


def encode_targets(
    gt: torch.Tensor,
    gt_mask: torch.Tensor,
    anchors: torch.Tensor,
    *,
    n_classes: int,
    img_height: int,
    img_width: int,
    pos_iou_threshold: float = 0.5,
    neg_iou_limit: float = 0.3,
    border_pixels: str = "half",
    normalize_coords: bool = True,
    matching_type: str = "multi",
    log_scale_offsets: bool = True,
    bipartite_impl: str = "auto",
) -> torch.Tensor:
    """Encode a batch of padded GT into SSD training targets.

    Args:
      gt: (B, max_gt, 5) float32 (class_id, xmin, ymin, xmax, ymax), absolute.
      gt_mask: (B, max_gt) bool validity of each GT row.
      anchors: (n_boxes, 8) float32 centroids + variances, on gt's device.
      n_classes: positive classes (the one-hot has n_classes + 1 columns,
        background first).

    Returns:
      (B, n_boxes, n_classes + 1 + 12) float32.
    """
    n_total = n_classes + 1
    batch, max_gt = gt.shape[:2]
    anchors_cent, variances = anchors[:, :4], anchors[:, 4:]
    n_boxes = anchors.shape[0]
    dev = gt.device

    cls_ids = gt[..., 0].to(torch.int32)
    corners = gt[..., 1:5]
    if normalize_coords:
        scale = torch.tensor(
            [img_width, img_height, img_width, img_height], dtype=torch.float32, device=dev
        )
        corners = corners / scale
    cent = geometry.corners_to_centroids(corners, border_pixels=border_pixels)

    sims = geometry.iou_matrix(cent, anchors_cent, coords="centroids", border_pixels=border_pixels)
    sims = torch.where(gt_mask[..., None], sims, matching._NEG).contiguous()  # (B, max_gt, n)

    # Per-anchor best GT over the whole matrix, once: multi matching and the
    # neutral zone are decisions local to each column.
    col_best_gt = sims.argmax(dim=1)  # (B, n), first maximal row
    col_best_sim = sims.amax(dim=1)

    # 1: bipartite pairs, scattered into the per-anchor assignment (column
    # n_boxes collects the unmatched rows and is dropped).
    bip_anchor = bipartite_match(sims, impl=bipartite_impl)
    slot = torch.where(bip_anchor >= 0, bip_anchor, n_boxes).long()
    assigned = torch.full((batch, n_boxes + 1), -1, dtype=torch.long, device=dev)
    assigned.scatter_(1, slot, torch.arange(max_gt, device=dev).expand(batch, -1))
    assigned = assigned[:, :n_boxes]

    # 2: multi matching on the other columns, with every GT row alive.
    if matching_type == "multi":
        multi_hit = (assigned < 0) & (col_best_sim >= pos_iou_threshold)
        assigned = torch.where(multi_hit, col_best_gt, assigned)

    # 3: neutral zone.
    neutral = (assigned < 0) & (col_best_sim >= neg_iou_limit)

    # 4: outputs.
    positive = assigned >= 0
    safe_idx = assigned.clamp(0, max_gt - 1)
    matched_cent = cent.gather(1, safe_idx[..., None].expand(-1, -1, 4))  # (B, n, 4)
    matched_cls = cls_ids.gather(1, safe_idx)  # (B, n)
    classes = torch.arange(n_total, device=dev)
    # An out-of-range class id gives an all-zero row, as jax.nn.one_hot does.
    one_hot_pos = (matched_cls[..., None] == classes).float()
    one_hot_bg = (classes == 0).float().expand(batch, n_boxes, -1)
    one_hot = torch.where(positive[..., None], one_hot_pos, one_hot_bg)
    one_hot = torch.where(neutral[..., None], 0.0, one_hot)

    wa, ha = anchors_cent[:, 2], anchors_cent[:, 3]
    d_cx = (matched_cent[..., 0] - anchors_cent[:, 0]) / (wa * variances[:, 0])
    d_cy = (matched_cent[..., 1] - anchors_cent[:, 1]) / (ha * variances[:, 1])
    if log_scale_offsets:
        # The clamp guards the log on unmatched rows (w or h may be 0).
        d_w = torch.log(torch.clamp_min(matched_cent[..., 2] / wa, 1e-12)) / variances[:, 2]
        d_h = torch.log(torch.clamp_min(matched_cent[..., 3] / ha, 1e-12)) / variances[:, 3]
    else:
        d_w = (matched_cent[..., 2] / wa) / variances[:, 2]
        d_h = (matched_cent[..., 3] / ha) / variances[:, 3]
    offsets = torch.stack([d_cx, d_cy, d_w, d_h], dim=-1)
    offsets = torch.where(positive[..., None], offsets, 0.0)

    return torch.cat(
        [one_hot, offsets, anchors_cent.expand(batch, -1, -1), variances.expand(batch, -1, -1)],
        dim=-1,
    )


@dataclasses.dataclass(frozen=True)
class TargetEncoder:
    """Batched GT encoder bound to one anchor configuration and one device.

    `device` None means CUDA and raises without a card; tests pass "cpu".
    `bipartite_impl` is "auto", "kernel" or "reference" (see
    `ops.bipartite_match`)."""

    spec: AnchorSpec
    predictor_sizes: tuple[tuple[int, int], ...]
    n_classes: int = 20
    pos_iou_threshold: float = 0.5
    neg_iou_limit: float = 0.3
    border_pixels: str = "half"
    matching_type: str = "multi"
    log_scale_offsets: bool = True
    bipartite_impl: str = "auto"
    device: str | torch.device | None = None

    def __post_init__(self):
        if self.bipartite_impl not in IMPLS:
            raise ValueError(f"bipartite_impl must be one of {IMPLS}, got {self.bipartite_impl!r}")
        object.__setattr__(self, "device", resolve_device(self.device))

    @functools.cached_property
    def anchors(self) -> np.ndarray:
        return build_anchors(self.spec, self.predictor_sizes, coords="centroids")

    @property
    def n_boxes(self) -> int:
        return self.anchors.shape[0]

    @functools.cached_property
    def encode_fn(self):
        """(gt, gt_mask) tensors on `device` -> targets."""
        return functools.partial(
            encode_targets,
            anchors=torch.as_tensor(self.anchors, dtype=torch.float32, device=self.device),
            n_classes=self.n_classes,
            img_height=self.spec.img_height,
            img_width=self.spec.img_width,
            pos_iou_threshold=self.pos_iou_threshold,
            neg_iou_limit=self.neg_iou_limit,
            border_pixels=self.border_pixels,
            normalize_coords=self.spec.normalize_coords,
            matching_type=self.matching_type,
            log_scale_offsets=self.log_scale_offsets,
            bipartite_impl=self.bipartite_impl,
        )

    def __call__(self, gt, gt_mask) -> torch.Tensor:
        """gt (B, max_gt, 5), gt_mask (B, max_gt), tensors or NumPy ->
        (B, n_boxes, n_classes + 1 + 12) on `device`."""
        gt = torch.as_tensor(gt, dtype=torch.float32, device=self.device)
        gt_mask = torch.as_tensor(gt_mask, dtype=torch.bool, device=self.device)
        return self.encode_fn(gt, gt_mask)

    def pad_labels(self, labels_list, max_gt: int = 64):
        """Pack a list of (k_i, 5) label arrays into NumPy (B, max_gt, 5)
        float32 and a (B, max_gt) bool mask (host side)."""
        gt = np.zeros((len(labels_list), max_gt, 5), dtype=np.float32)
        mask = np.zeros((len(labels_list), max_gt), dtype=bool)
        for i, lab in enumerate(labels_list):
            lab = np.asarray(lab, dtype=np.float32).reshape(-1, 5)
            k = min(lab.shape[0], max_gt)
            gt[i, :k] = lab[:k]
            mask[i, :k] = True
        return gt, mask
