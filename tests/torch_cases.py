"""Seeded inputs shared by the PyTorch-port tests: NumPy and the port only
(no jax), so the card-only tests in `test_torch_cuda.py` can use them on a
machine without JAX."""

import numpy as np

from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

N_CLASSES = 20
BORDERS = {"half": 0.0, "include": 1.0, "exclude": -1.0}


def nms_problems(rng, n, k, at_threshold=True):
    """N sorted NMS problems: clustered boxes (so suppression happens), padded
    zero-score tails, exact-tie scores, and IoU-exactly-at-threshold pairs."""
    centers = rng.uniform(20, 280, (n, 4, 2))
    pick = rng.integers(0, 4, (n, k))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 12, (n, k, 2))
    wh = rng.uniform(10, 60, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1, (n, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[:, : k // 8] = 1.0  # exact ties at the top, as a saturated head gives
    scores[:, -(k // 5 + 1):] = 0.0  # padded slots
    if at_threshold and k >= 4:
        # inter 9, union 20 (area 20 box containing an area 9 box): IoU is
        # 9/20, the f32 nearest 0.45 -- NOT above the threshold 0.45.
        boxes[:, 0] = [100.0, 100.0, 120.0, 101.0]
        boxes[:, 1] = [100.0, 100.0, 109.0, 101.0]
        # one ulp more inter: just above the threshold
        boxes[:, 2] = [200.0, 200.0, 220.0, 201.0]
        boxes[:, 3] = [200.0, 200.0, np.nextafter(np.float32(209.0), np.float32(300.0)), 201.0]
    return np.ascontiguousarray(boxes), np.ascontiguousarray(scores)


def raw_predictions(seed=0, batch=2):
    """(B, 8732, 33) softmax scores, offsets, SSD300 anchors and variances.

    A third of the rows are saturated: one positive class at exactly 1.0 and
    every other class at 0.0, so the top-k selections see many exact ties."""
    rng = np.random.default_rng(seed)
    anchors = build_anchors(AnchorSpec(), ssd_predictor_sizes("resnet_custom"))
    n = anchors.shape[0]
    logits = rng.normal(0, 2.5, (batch, n, N_CLASSES + 1))
    logits[..., 0] += 2.0  # background-leaning, as a detector mostly is
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    saturated = rng.random((batch, n)) < 1 / 3
    cls = rng.integers(1, N_CLASSES + 1, (batch, n))
    onehot = np.eye(N_CLASSES + 1)[cls]
    probs = np.where(saturated[..., None], onehot, probs)
    offsets = rng.normal(0, 1, (batch, n, 4))
    y = np.concatenate(
        [probs, offsets, np.broadcast_to(anchors, (batch, n, 8))], axis=-1
    ).astype(np.float32)
    return np.ascontiguousarray(y)


def gt_batch(rng, n_valid, max_gt=64, img=300):
    """Padded GT `(B, max_gt, 5)` float32 rows (class, xmin, ymin, xmax, ymax)
    in pixels and a `(B, max_gt)` mask, `n_valid[i]` boxes in image i.  The
    second box of an image repeats the first (so matching meets exact ties)
    and a third is a few pixels wide."""
    gt = np.zeros((len(n_valid), max_gt, 5), np.float32)
    mask = np.zeros((len(n_valid), max_gt), bool)
    for i, k in enumerate(n_valid):
        xy0 = rng.uniform(0, img - 60, (k, 2))
        xy1 = np.minimum(xy0 + rng.uniform(8, 220, (k, 2)), img)
        rows = np.concatenate([rng.integers(1, N_CLASSES + 1, (k, 1)), xy0, xy1], -1)
        if k >= 2:
            rows[1] = rows[0]
        if k >= 3:
            rows[2, 3:] = rows[2, 1:3] + 3.0
        gt[i, :k] = rows
        mask[i, :k] = True
    return gt, mask


def tie_sims(rng, shape):
    """Similarities on a coarse grid in [-0.25, 1): many exact ties, some
    rows below zero everywhere (never matched)."""
    sims = rng.integers(-4, 16, shape).astype(np.float32) / 16
    sims[:, -3:] = -1.0
    return sims
