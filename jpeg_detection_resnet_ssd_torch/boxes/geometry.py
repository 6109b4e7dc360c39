"""Axis-aligned box coordinate conversions and IoU as torch functions.

Counterpart of the JAX package's `boxes/geometry.py`, same operation order:

* three coordinate formats --
  'corners'   = (xmin, ymin, xmax, ymax)
  'minmax'    = (xmin, xmax, ymin, ymax)
  'centroids' = (cx, cy, w, h)
* a `border_pixels` convention in {'half','include','exclude'} that adds
  d in {0, +1, -1} to widths/heights computed from corner differences.

Functions take tensors or NumPy arrays (converted to float32 on entry,
keeping a tensor's device), work on the LAST axis and broadcast over the
leading ones.
"""

from __future__ import annotations

import torch

BORDER_DELTA = {"half": 0.0, "include": 1.0, "exclude": -1.0}


def border_delta(border_pixels: str) -> float:
    try:
        return BORDER_DELTA[border_pixels]
    except KeyError:
        raise ValueError(
            f"border_pixels must be one of {list(BORDER_DELTA)}, got {border_pixels!r}"
        ) from None


def _f32(boxes) -> torch.Tensor:
    return torch.as_tensor(boxes, dtype=torch.float32)


def corners_to_centroids(boxes, border_pixels: str = "half"):
    """(..., 4) corners -> centroids. w = xmax - xmin + d, h likewise."""
    boxes = _f32(boxes)
    d = border_delta(border_pixels)
    xmin, ymin, xmax, ymax = boxes.unbind(-1)
    return torch.stack(
        [(xmin + xmax) / 2.0, (ymin + ymax) / 2.0, xmax - xmin + d, ymax - ymin + d],
        dim=-1,
    )


def centroids_to_corners(boxes):
    """(..., 4) centroids -> corners."""
    boxes = _f32(boxes)
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2.0, cy - h / 2.0, cx + w / 2.0, cy + h / 2.0], dim=-1)


def corners_to_minmax(boxes):
    return _f32(boxes)[..., [0, 2, 1, 3]]


def minmax_to_corners(boxes):
    return _f32(boxes)[..., [0, 2, 1, 3]]


def minmax_to_centroids(boxes, border_pixels: str = "half"):
    boxes = _f32(boxes)
    d = border_delta(border_pixels)
    xmin, xmax, ymin, ymax = boxes.unbind(-1)
    return torch.stack(
        [(xmin + xmax) / 2.0, (ymin + ymax) / 2.0, xmax - xmin + d, ymax - ymin + d],
        dim=-1,
    )


def centroids_to_minmax(boxes):
    boxes = _f32(boxes)
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2.0, cx + w / 2.0, cy - h / 2.0, cy + h / 2.0], dim=-1)


_CONVERTERS = {
    ("corners", "centroids"): corners_to_centroids,
    ("corners", "minmax"): lambda b, border_pixels="half": corners_to_minmax(b),
    ("minmax", "corners"): lambda b, border_pixels="half": minmax_to_corners(b),
    ("minmax", "centroids"): minmax_to_centroids,
    ("centroids", "corners"): lambda b, border_pixels="half": centroids_to_corners(b),
    ("centroids", "minmax"): lambda b, border_pixels="half": centroids_to_minmax(b),
}


def convert(boxes, src: str, dst: str, border_pixels: str = "half"):
    """Generic conversion between the three formats."""
    if src == dst:
        return _f32(boxes)
    return _CONVERTERS[(src, dst)](boxes, border_pixels=border_pixels)


def _as_corners(boxes, coords: str):
    if coords == "corners":
        return _f32(boxes)
    if coords == "minmax":
        return minmax_to_corners(boxes)
    if coords == "centroids":
        return centroids_to_corners(boxes)
    raise ValueError(f"unknown coords format {coords!r}")


def box_area(corners, border_pixels: str = "half"):
    """Area of (..., 4) corner-format boxes under the given border convention."""
    corners = _f32(corners)
    d = border_delta(border_pixels)
    return (corners[..., 2] - corners[..., 0] + d) * (corners[..., 3] - corners[..., 1] + d)


def intersection_area_elementwise(boxes1, boxes2, coords="corners", border_pixels="half"):
    """Broadcast element-wise intersection areas: (..., 4) x (..., 4) -> (...)."""
    b1 = _as_corners(boxes1, coords)
    b2 = _as_corners(boxes2, coords)
    d = border_delta(border_pixels)
    min_xy = torch.maximum(b1[..., :2], b2[..., :2])
    max_xy = torch.minimum(b1[..., 2:], b2[..., 2:])
    side = torch.clamp_min(max_xy - min_xy + d, 0.0)
    return side[..., 0] * side[..., 1]


def intersection_area_matrix(boxes1, boxes2, coords="corners", border_pixels="half"):
    """Pairwise intersection areas: (..., m, 4) x (..., n, 4) -> (..., m, n)."""
    b1 = _as_corners(boxes1, coords)[..., :, None, :]
    b2 = _as_corners(boxes2, coords)[..., None, :, :]
    d = border_delta(border_pixels)
    min_xy = torch.maximum(b1[..., :2], b2[..., :2])
    max_xy = torch.minimum(b1[..., 2:], b2[..., 2:])
    side = torch.clamp_min(max_xy - min_xy + d, 0.0)
    return side[..., 0] * side[..., 1]


def iou_matrix(boxes1, boxes2, coords="corners", border_pixels="half"):
    """Pairwise Jaccard overlap: (..., m, 4) x (..., n, 4) -> (..., m, n),
    leading axes broadcast; 0 where the union is not > 0."""
    inter = intersection_area_matrix(boxes1, boxes2, coords, border_pixels)
    a1 = box_area(_as_corners(boxes1, coords), border_pixels)[..., :, None]
    a2 = box_area(_as_corners(boxes2, coords), border_pixels)[..., None, :]
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_elementwise(boxes1, boxes2, coords="corners", border_pixels="half"):
    """Broadcast element-wise Jaccard overlap; 0 where the union is not > 0."""
    inter = intersection_area_elementwise(boxes1, boxes2, coords, border_pixels)
    a1 = box_area(_as_corners(boxes1, coords), border_pixels)
    a2 = box_area(_as_corners(boxes2, coords), border_pixels)
    union = a1 + a2 - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))
