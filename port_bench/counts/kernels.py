"""Least work of the hand-written kernels, counted from the cell's inputs.

Each function gives (bytes, operations) that the call needs: every input
byte read once and every output byte written once, and the operations the
algorithm cannot skip on these inputs.  `least_seconds` turns them into the
least time on the card's published peaks (`peaks.json`).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
NMS_OPS_PER_PAIR = 16  # 2 x (min, max, sub, add d, max 0), mul, add, sub, max, div, cmp


def least_seconds(nbytes: float, ops: float) -> float:
    """The kernels' operations are float32 arithmetic and compares."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS["float32_flops"])


def flip(elements: int, itemsize: int = 4) -> tuple[int, int]:
    """B3: read the map once, write its flipped copy once."""
    return 2 * elements * itemsize, 0


def match(live_rows: int, batch: int, max_gt: int, anchors: int) -> tuple[int, int]:
    """B2: read the live GT rows of the IoU matrix and the row mask, write
    one index a row; one compare an element read."""
    return live_rows * anchors * 4 + batch * max_gt * 4 + batch * max_gt, live_rows * anchors


def nms(keep, problems: int, k: int) -> tuple[int, int]:
    """B1: each kept candidate i of a problem is tested against its k-1-i
    later ones; boxes and scores read once, the keep mask written once.
    `keep` is the (problems, k) bool keep mask these inputs give."""
    import torch

    later = (k - 1 - torch.arange(k, device=keep.device))
    pairs = int((later * keep).sum())
    return problems * k * (4 * 4 + 4 + 1), NMS_OPS_PER_PAIR * pairs
