"""GT <-> anchor matching on padded similarity matrices (torch).

Counterpart of the JAX package's `boxes/matching.py`.  Both functions take
(max_gt, n_anchors) similarities with a (max_gt,) validity mask, or a batch
of them with leading axes; invalid (padding) rows are masked to `_NEG` so
they never win.

* `match_bipartite_greedy` runs a fixed `max_gt`-step greedy loop: each step
  matches the globally best remaining (gt, anchor) pair and consumes its row
  and column.  The target encoder uses the faster `ops.bipartite_match`
  (same pairs, a loop bounded by the valid rows); this one is kept for its
  contract (a (matches, valid) pair, unmatched rows keep 0).
* `match_multi` is a masked argmax over the GT axis.
"""

from __future__ import annotations

import torch

_NEG = -1.0  # IoU is >= 0, so -1 marks consumed or invalid entries.


def match_bipartite_greedy(similarities: torch.Tensor, gt_mask: torch.Tensor):
    """Greedy bipartite matching, maximizing similarity.

    Args:
      similarities: (..., max_gt, n_anchors) float.
      gt_mask: (..., max_gt) bool, True for valid GT rows.

    Returns:
      matches: (..., max_gt) int32 matched anchor per GT row (0 where no
        pair was committed, as in the JAX package).
      match_valid: (..., max_gt) bool, `gt_mask`.
    """
    sims = torch.where(gt_mask[..., None], similarities, _NEG)
    max_gt, n_anchors = sims.shape[-2:]
    rows = torch.arange(max_gt, device=sims.device)
    cols = torch.arange(n_anchors, device=sims.device)
    matches = torch.zeros(sims.shape[:-1], dtype=torch.int32, device=sims.device)
    for _ in range(max_gt):
        anchor_idx = sims.argmax(dim=-1)  # (..., max_gt), first maximal index
        row_best = sims.gather(-1, anchor_idx[..., None])[..., 0]
        gt_idx = row_best.argmax(dim=-1, keepdim=True)  # (..., 1)
        a_idx = anchor_idx.gather(-1, gt_idx)
        valid = row_best.gather(-1, gt_idx) >= 0.0
        row_kill = (rows == gt_idx) & valid  # (..., max_gt)
        matches = torch.where(row_kill, a_idx.to(torch.int32), matches)
        col_kill = (cols == a_idx) & valid  # (..., n_anchors)
        sims = torch.where(row_kill[..., :, None] | col_kill[..., None, :], _NEG, sims)
    return matches, gt_mask


def match_multi(similarities: torch.Tensor, gt_mask: torch.Tensor, threshold: float):
    """Per-anchor thresholded argmax matching.

    Returns:
      best_gt: (..., n_anchors) int32 best GT index per anchor (first on ties).
      matched: (..., n_anchors) bool, best similarity >= threshold.
    """
    sims = torch.where(gt_mask[..., None], similarities, _NEG)
    best_gt = sims.argmax(dim=-2).to(torch.int32)
    return best_gt, sims.amax(dim=-2) >= threshold
