"""SSD multibox loss with hard-negative mining (torch).

Counterpart of the JAX package's `losses/ssd_loss.py`, same semantics:

  * softmax log loss over the one-hot class block, smooth-L1 over the 4
    offsets (the last 8 columns, anchors and variances, are ignored);
  * positives are anchors with a non-background one-hot; neutral anchors
    (all-zero one-hot) count in neither term;
  * hard-negative mining keeps the k background anchors with the largest
    class loss, k = min(max(neg_pos_ratio * n_pos, n_neg_min), #nonzero
    negative losses), across the whole batch;
  * total = sum(class + alpha * loc) / max(1, n_positive).

The k largest are summed through the exact k-th largest value, found by a
31-step binary search over the int32 bit patterns of the nonnegative losses
(monotone in the value), not by a sort or `torch.topk`: ties at the
threshold share the remaining weight evenly, so value and gradient are the
JAX package's.

Inside `parallel.data_parallel(mesh)` with more than one data rank, each
holding its rows of the global batch, the mining is the global batch's: the
positives and nonzero-negative counts are all-reduced over the data group
(a model group's ranks hold the same rows), and the threshold and the tie
weight come from the all-gathered negative losses, so they are the ones one
process finds on the whole batch.  Each rank's loss is its rows' share of
the global numerator over the global positives count; the shares sum to the
single-process loss.
"""

from __future__ import annotations

import dataclasses

import torch

from jpeg_detection_resnet_ssd_torch.parallel.mesh import active_mesh, all_gather_rows, all_reduce_sum

_NONNEG_BITS_END = 0x7F800000  # bit pattern of +inf


def _kth_largest_nonneg(flat: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th largest value (k >= 1, a 0-dim integer tensor) of a
    nonnegative float32 vector: the largest bit pattern m with
    #{bits >= m} >= k.  Stays on the device (no host synchronisation)."""
    bits = flat.contiguous().view(torch.int32)
    lo = torch.zeros((), dtype=torch.int32, device=flat.device)
    hi = torch.full((), _NONNEG_BITS_END, dtype=torch.int32, device=flat.device)
    for _ in range(31):
        mid = lo + torch.div(hi - lo + 1, 2, rounding_mode="floor")
        ok = (bits >= mid).sum() >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    return lo.view(torch.float32)


def top_k_sum(flat: torch.Tensor, n_keep: torch.Tensor,
              pool: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of the ceil(n_keep) largest entries of a nonnegative vector, for
    a data-dependent n_keep (0 <= n_keep <= len(pool)).

    Gradient: 1 on entries above the k-th largest value t; the entries equal
    to t share the remaining weight (k - #{x > t}) evenly.

    `pool` is the whole vector of which `flat` is one part (default: `flat`
    itself): t, the count above it and the ties are the pool's, and the sum
    runs over `flat`'s entries, so the parts' sums add up to the pool's."""
    pool = flat.detach() if pool is None else pool
    n_keep = torch.as_tensor(n_keep, dtype=flat.dtype, device=flat.device)
    k = torch.ceil(n_keep).to(torch.int32)
    t = _kth_largest_nonneg(pool, torch.clamp_min(k, 1))
    tie_w = (k - (pool > t).sum()).to(flat.dtype)
    n_ties = torch.clamp_min((pool == t).sum(), 1).to(flat.dtype)
    w = (flat > t).to(flat.dtype) + (flat == t).to(flat.dtype) * (tie_w / n_ties)
    total = (flat * w.detach()).sum()
    return torch.where(k > 0, total, torch.zeros_like(total))


def smooth_l1(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Huber / smooth-L1 summed over the last axis."""
    diff = torch.abs(y_true - y_pred)
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(dim=-1)


def softmax_log_loss(y_true: torch.Tensor, y_pred_probs: torch.Tensor) -> torch.Tensor:
    """-sum(y_true * log(max(p, 1e-15))) over the last axis."""
    return -(y_true * torch.log(torch.clamp_min(y_pred_probs, 1e-15))).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class SSDLoss:
    """Configured SSD loss; the reference's defaults neg_pos_ratio=3, alpha=1."""

    neg_pos_ratio: float = 3.0
    n_neg_min: int = 0
    alpha: float = 1.0

    def __call__(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        """y_true, y_pred: (B, n_boxes, n_classes + 1 + 12) -> scalar."""
        cls_loss = softmax_log_loss(y_true[..., :-12], y_pred[..., :-12])
        loc_loss = smooth_l1(y_true[..., -12:-8], y_pred[..., -12:-8])

        negatives = y_true[..., 0]
        positives = y_true[..., 1:-12].amax(dim=-1)
        n_positive = positives.sum()

        pos_class_loss = (cls_loss * positives).sum()
        flat = (cls_loss * negatives).reshape(-1)
        n_neg_losses = (flat > 0).sum().to(torch.float32)
        pool = None
        mesh = active_mesh()
        if mesh is not None:  # the global batch's counts and negative losses
            n_positive, n_neg_losses = all_reduce_sum(
                torch.stack([n_positive.detach().float(), n_neg_losses]), mesh)
            pool = all_gather_rows(flat, mesh)
        n_keep = torch.minimum(
            torch.clamp_min(self.neg_pos_ratio * n_positive, float(self.n_neg_min)),
            n_neg_losses,
        )
        # n_keep <= #nonzero losses, so the threshold is > 0 whenever
        # n_keep >= 1: the reference's `flat > 0` guard is implied.
        neg_class_loss = top_k_sum(flat, n_keep, pool)

        loc = (loc_loss * positives).sum()
        return (pos_class_loss + neg_class_loss + self.alpha * loc) / torch.clamp_min(n_positive, 1.0)

    def per_item(self, y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
        """(B,) positives-only breakdown per batch item (no negatives)."""
        cls_loss = softmax_log_loss(y_true[..., :-12], y_pred[..., :-12])
        loc_loss = smooth_l1(y_true[..., -12:-8], y_pred[..., -12:-8])
        positives = y_true[..., 1:-12].amax(dim=-1)
        n_positive = positives.sum()
        pos_cls = (cls_loss * positives).sum(dim=-1)
        loc = (loc_loss * positives).sum(dim=-1)
        return (pos_cls + self.alpha * loc) / torch.clamp_min(n_positive, 1.0)
