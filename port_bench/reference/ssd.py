"""Plain SSD300 box arithmetic: anchors, target encoding, the multibox loss
and the decode with greedy NMS.

Written from the SSD paper (Liu et al., ECCV 2016) and ssd_keras's
conventions, which the detection fork of the reference keeps: anchors on
each map's grid at offset 0.5, a second ratio-1 box of scale
sqrt(s_k s_{k+1}), variances (0.1, 0.1, 0.2, 0.2), coordinates normalized
to the image; greedy bipartite matching then per-anchor matching at IoU
0.5 with a neutral zone from 0.3; softmax log loss with 3:1 hard-negative
mining plus smooth-L1; per-class confidence threshold, greedy NMS at IoU
0.45 and a global top-k.  A network's `Geometry` gives its maps, steps,
scales and ratios.  Imports nothing of the system under test.  `dtype` is
the precision the arithmetic runs in (float64 for the reference, a lower
one for the control).
"""

from __future__ import annotations

import dataclasses
import math

import torch

VARIANCES = (0.1, 0.1, 0.2, 0.2)
IMG_SIZE = 300  # the frame the decode's boxes are given in, pixels
NMS_IOU = 0.45
CONF_THRESH = 0.01
PER_CLASS = 400  # candidates of each class that enter NMS
TOP_K = 200  # detections kept an image


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Anchors of an SSD: per source map its size, step (pixels) and aspect
    ratios, and the scales s_0..s_n as shares of the image."""

    maps: tuple
    steps: tuple
    ratios: tuple
    scales: tuple

    def boxes(self) -> tuple:
        """Anchors per cell of each map: one per ratio, and a second ratio 1."""
        return tuple(len(r) + (1.0 in r) for r in self.ratios)

    def count(self) -> int:
        return sum(m * m * b for m, b in zip(self.maps, self.boxes()))


_R3, _R5 = (1.0, 2.0, 0.5), (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0)
SSD300 = Geometry(maps=(38, 19, 10, 5, 3, 1), steps=(8, 16, 32, 64, 100, 300),
                  ratios=(_R3, _R5, _R5, _R5, _R3, _R3),
                  scales=(0.1, 0.2, 0.37, 0.54, 0.71, 0.88, 1.05))


def anchors(geom: Geometry, img_size: int, device="cpu",
            dtype=torch.float64) -> torch.Tensor:
    """(n_anchors, 4) anchor centroids (cx, cy, w, h), normalized,
    map-major and then row, column, box."""
    out = []
    for k, (fm, step, ratios) in enumerate(zip(geom.maps, geom.steps, geom.ratios)):
        s, s_next = geom.scales[k] * img_size, geom.scales[k + 1] * img_size
        whs = []
        for r in ratios:
            if r == 1.0:
                whs += [(s, s), (math.sqrt(s * s_next),) * 2]
            else:
                whs.append((s * math.sqrt(r), s / math.sqrt(r)))
        c = (torch.arange(fm, dtype=torch.float64) + 0.5) * step
        cy, cx = torch.meshgrid(c, c, indexing="ij")
        wh = torch.tensor(whs, dtype=torch.float64)
        n = wh.shape[0]
        a = torch.stack([cx[..., None].expand(fm, fm, n), cy[..., None].expand(fm, fm, n),
                         wh[:, 0].expand(fm, fm, n), wh[:, 1].expand(fm, fm, n)], -1)
        out.append(a.reshape(-1, 4))
    a = torch.cat(out) / img_size
    return a.to(device=device, dtype=dtype)


def _corners(c):
    return torch.cat([c[..., :2] - c[..., 2:] / 2, c[..., :2] + c[..., 2:] / 2], -1)


def iou(a, b):
    """(..., m, 4) x (..., n, 4) corner boxes -> (..., m, n); 0 where the
    union is empty."""
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (hi - lo).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1), 0)


def encode(geom: Geometry, gt, gt_mask, img_size: int, n_classes: int, dtype=torch.float64):
    """Padded GT (B, G, 5) rows (class, xmin, ymin, xmax, ymax) in pixels of
    an `img_size` frame -> targets (B, n_anchors, n_classes + 1 + 4): one-hot
    classes (background first; neutral anchors all zero) and the offsets
    of positive anchors."""
    dev = gt.device
    anc = anchors(geom, img_size, device=dev, dtype=dtype)
    gt = gt.to(dtype)
    B, G = gt_mask.shape
    N = anc.shape[0]
    boxes = gt[..., 1:] / img_size
    sims = iou(boxes, _corners(anc))  # (B, G, N)
    sims = torch.where(gt_mask[..., None], sims, -1.0)
    assigned = torch.full((B, N), -1, dtype=torch.long, device=dev)
    # greedy bipartite: the global best (GT, anchor) pair, repeatedly
    s = sims.clone()
    for _ in range(G):
        flat = s.reshape(B, -1)
        best, idx = flat.max(1)
        live = best >= 0
        g, n = idx // N, idx % N
        bi = torch.arange(B, device=dev)[live]
        assigned[bi, n[live]] = g[live]
        s[bi, g[live], :] = -1.0
        s[bi, :, n[live]] = -1.0
    col_best, col_gt = sims.max(1)
    assigned = torch.where((assigned < 0) & (col_best >= 0.5), col_gt, assigned)
    neutral = (assigned < 0) & (col_best >= 0.3)
    pos = assigned >= 0
    idx = assigned.clamp_min(0)
    m = torch.gather(boxes, 1, idx[..., None].expand(B, N, 4))
    cls = torch.gather(gt[..., 0], 1, idx).long()
    onehot = torch.zeros(B, N, n_classes + 1, dtype=dtype, device=dev)
    onehot[..., 0] = 1.0
    onehot = torch.where(pos[..., None], torch.nn.functional.one_hot(cls, n_classes + 1).to(dtype),
                         onehot)
    onehot = torch.where(neutral[..., None], 0.0, onehot)
    mc = torch.cat([(m[..., :2] + m[..., 2:]) / 2, m[..., 2:] - m[..., :2]], -1)
    v = torch.tensor(VARIANCES, dtype=dtype, device=dev)
    off = torch.cat([(mc[..., :2] - anc[:, :2]) / (anc[:, 2:] * v[:2]),
                     torch.log(mc[..., 2:].clamp_min(1e-12) / anc[:, 2:]) / v[2:]], -1)
    off = torch.where(pos[..., None], off, 0.0)
    return torch.cat([onehot, off], -1)


def loss(targets, scores, offsets):
    """Multibox loss: (positive softmax log loss + the top 3 x n_pos negative
    ones + smooth-L1 of positive offsets) / max(1, n_pos)."""
    t = targets.to(scores.dtype)
    n_cls = scores.shape[-1]
    onehot, t_off = t[..., :n_cls], t[..., n_cls:]
    cls_loss = -(onehot * torch.log(scores.clamp_min(1e-15))).sum(-1)
    d = (t_off - offsets).abs()
    loc = torch.where(d < 1, 0.5 * d * d, d - 0.5).sum(-1)
    pos = onehot[..., 1:].amax(-1)
    neg = onehot[..., 0]
    n_pos = pos.sum()
    neg_losses = (cls_loss * neg).reshape(-1)
    n_keep = int(min(3 * float(n_pos), float((neg_losses > 0).sum())))
    top = neg_losses.topk(n_keep).indices if n_keep > 0 else neg_losses.new_zeros(0, dtype=torch.long)
    total = (cls_loss * pos).sum() + neg_losses[top].sum() + (loc * pos).sum()
    return total / n_pos.clamp_min(1)


def decode_boxes(geom: Geometry, offsets, dtype=torch.float64, anchor_dtype=None):
    """(..., n_anchors, 4) offsets -> corner boxes in pixels; with
    `anchor_dtype` the anchors are first rounded to it (the head emits them
    in its compute dtype)."""
    anc = anchors(geom, IMG_SIZE, device=offsets.device, dtype=dtype)
    if anchor_dtype is not None:
        anc = anc.to(anchor_dtype).to(dtype)
    v = torch.tensor(VARIANCES, dtype=dtype, device=offsets.device)
    o = offsets.to(dtype)
    c = torch.cat([o[..., :2] * v[:2] * anc[:, 2:] + anc[:, :2],
                   torch.exp(o[..., 2:] * v[2:]) * anc[:, 2:]], -1)
    return _corners(c) * IMG_SIZE


def _desc(x, k):
    """The k largest along the last axis, descending, lower index first on ties."""
    v, i = torch.sort(x, stable=True, dim=-1, descending=True)
    return v[..., :k], i[..., :k]


def nms_keep(boxes, scores):
    """Greedy NMS of (P, K, 4) boxes sorted by descending (P, K) scores ->
    (P, K) keep mask; empty slots (score 0) are dropped."""
    P, K = scores.shape
    ious = iou(boxes, boxes)
    keep = scores > 0
    for i in range(K):
        sup = keep[:, i:i + 1] & (ious[:, i] > NMS_IOU)
        sup[:, :i + 1] = False
        keep = keep & ~sup
    return keep


def decode(geom: Geometry, scores, offsets, n_classes, pool,
           dtype=torch.float64, return_keep=False, anchor_dtype=None):
    """Detections (B, TOP_K, 6) rows (class, score, xmin, ymin, xmax, ymax):
    a pool of the `pool` anchors with the best positive-class score, the
    PER_CLASS best of each class above CONF_THRESH, greedy NMS per class at
    NMS_IOU, then the global top-k; empty rows are zero.  With `return_keep`
    also the (B, n_classes, PER_CLASS) NMS keep mask."""
    B = scores.shape[0]
    C = n_classes
    pos = scores[..., 1:C + 1].to(dtype)
    best = torch.where(pos > CONF_THRESH, pos, 0).amax(-1)
    _, pool_idx = _desc(best, pool)
    pool_scores = torch.gather(pos, 1, pool_idx[..., None].expand(-1, -1, C))
    pool_boxes = torch.gather(decode_boxes(geom, offsets, dtype, anchor_dtype=anchor_dtype), 1,
                              pool_idx[..., None].expand(-1, -1, 4))
    cls_scores = pool_scores.transpose(1, 2)  # (B, C, pool)
    cls_scores = torch.where(cls_scores > CONF_THRESH, cls_scores, 0)
    k = min(PER_CLASS, pool)
    top_s, top_i = _desc(cls_scores, k)
    top_b = torch.gather(pool_boxes[:, None].expand(-1, C, -1, -1), 2,
                         top_i[..., None].expand(-1, -1, -1, 4))
    keep = nms_keep(top_b.reshape(B * C, k, 4), top_s.reshape(B * C, k)).reshape(B, C, k)
    kept = torch.where(keep, top_s, 0).reshape(B, -1)
    cls = torch.arange(1, C + 1, dtype=dtype, device=scores.device)[None, :, None].expand(B, C, k)
    s, i = _desc(kept, TOP_K)
    alive = s > 0
    rows = torch.cat([torch.gather(cls.reshape(B, -1), 1, i)[..., None], s[..., None],
                      torch.gather(top_b.reshape(B, -1, 4), 1, i[..., None].expand(-1, -1, 4))], -1)
    rows = torch.where(alive[..., None], rows, 0)
    return (rows, keep) if return_keep else rows
