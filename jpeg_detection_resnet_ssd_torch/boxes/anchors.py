"""SSD anchor (prior/default box) generation, in NumPy.

The port's own copy of the JAX package's `boxes/anchors.py` (which is pure
NumPy too, but lives in a package that imports jax).  The arithmetic is kept
operation for operation, so `build_anchors` is bit-equal to the reference's
for every spec; the model turns the `(n_boxes_total, 8)` array into a tensor
once per device.

Geometry contract:
  * `size = min(img_h, img_w)`; for each aspect ratio `ar`:
      ar == 1 -> box  w = h = scale * size, plus (if two_boxes_for_ar1) a second
                 box with w = h = sqrt(scale * next_scale) * size
      else    -> w = scale * size * sqrt(ar), h = scale * size / sqrt(ar)
    The ar==1 geometric-mean box is inserted immediately after the ar==1 box.
  * centers on a grid with spacing `step` and fractional `offset` (default 0.5).
  * optional clipping to image bounds and normalization to [0,1].
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# SSD300 Pascal-VOC hyperparameters of the flagship detector.
SSD300_SCALES_VOC = (0.1, 0.2, 0.37, 0.54, 0.71, 0.88, 1.05)
SSD300_ASPECT_RATIOS = (
    (1.0, 2.0, 0.5),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5, 3.0, 1.0 / 3.0),
    (1.0, 2.0, 0.5),
    (1.0, 2.0, 0.5),
)
SSD300_STEPS = (8, 16, 32, 64, 100, 300)
SSD300_VARIANCES = (0.1, 0.1, 0.2, 0.2)


def n_boxes_per_cell(aspect_ratios: Sequence[float], two_boxes_for_ar1: bool = True) -> int:
    return len(aspect_ratios) + (1 if (1.0 in aspect_ratios and two_boxes_for_ar1) else 0)


@dataclasses.dataclass(frozen=True)
class AnchorSpec:
    """Static anchor configuration for a full SSD detector."""

    img_height: int = 300
    img_width: int = 300
    scales: Sequence[float] = SSD300_SCALES_VOC
    aspect_ratios: Sequence[Sequence[float]] = SSD300_ASPECT_RATIOS
    steps: Sequence[float] | None = SSD300_STEPS
    offsets: Sequence[float] | None = None
    two_boxes_for_ar1: bool = True
    clip_boxes: bool = False
    variances: Sequence[float] = SSD300_VARIANCES
    normalize_coords: bool = True

    @property
    def n_layers(self) -> int:
        return len(self.aspect_ratios)

    def boxes_per_cell(self) -> list[int]:
        return [
            n_boxes_per_cell(ar, self.two_boxes_for_ar1) for ar in self.aspect_ratios
        ]


def _wh_list(scale, next_scale, size, aspect_ratios, two_boxes_for_ar1):
    whs = []
    for ar in aspect_ratios:
        if ar == 1.0:
            whs.append((scale * size, scale * size))
            if two_boxes_for_ar1:
                s = np.sqrt(scale * next_scale) * size
                whs.append((s, s))
        else:
            whs.append((scale * size * np.sqrt(ar), scale * size / np.sqrt(ar)))
    return np.array(whs, dtype=np.float64)  # (n_boxes, 2) as (w, h)


def anchor_grid_for_layer(
    feature_map_size: tuple[int, int],
    img_height: int,
    img_width: int,
    this_scale: float,
    next_scale: float,
    aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
    two_boxes_for_ar1: bool = True,
    this_steps=None,
    this_offsets=None,
    clip_boxes: bool = False,
    normalize_coords: bool = False,
    coords: str = "centroids",
) -> np.ndarray:
    """Anchor boxes for one predictor layer: (fh, fw, n_boxes, 4) float32 in
    the requested `coords` format."""
    fh, fw = int(feature_map_size[0]), int(feature_map_size[1])
    size = min(img_height, img_width)
    wh = _wh_list(this_scale, next_scale, size, aspect_ratios, two_boxes_for_ar1)
    n_boxes = wh.shape[0]

    if this_steps is None:
        step_h, step_w = img_height / fh, img_width / fw
    elif isinstance(this_steps, (list, tuple)):
        step_h, step_w = this_steps
    else:
        step_h = step_w = this_steps

    if this_offsets is None:
        off_h = off_w = 0.5
    elif isinstance(this_offsets, (list, tuple)):
        off_h, off_w = this_offsets
    else:
        off_h = off_w = this_offsets

    cy = np.linspace(off_h * step_h, (off_h + fh - 1) * step_h, fh)
    cx = np.linspace(off_w * step_w, (off_w + fw - 1) * step_w, fw)
    cx_grid, cy_grid = np.meshgrid(cx, cy)

    boxes = np.zeros((fh, fw, n_boxes, 4), dtype=np.float64)
    boxes[..., 0] = cx_grid[..., None]
    boxes[..., 1] = cy_grid[..., None]
    boxes[..., 2] = wh[:, 0]
    boxes[..., 3] = wh[:, 1]

    # centroids -> corners for clipping / normalization
    corners = np.concatenate(
        [boxes[..., :2] - boxes[..., 2:] / 2.0, boxes[..., :2] + boxes[..., 2:] / 2.0],
        axis=-1,
    )
    if clip_boxes:
        # x coords to [0, img_w - 1], y to [0, img_h - 1]
        x = corners[..., [0, 2]]
        x[x >= img_width] = img_width - 1
        x[x < 0] = 0
        corners[..., [0, 2]] = x
        y = corners[..., [1, 3]]
        y[y >= img_height] = img_height - 1
        y[y < 0] = 0
        corners[..., [1, 3]] = y
    if normalize_coords:
        corners[..., [0, 2]] /= img_width
        corners[..., [1, 3]] /= img_height

    if coords == "corners":
        out = corners
    elif coords == "centroids":
        # corners -> centroids with border_pixels='half' (d = 0)
        out = np.concatenate(
            [
                (corners[..., :2] + corners[..., 2:]) / 2.0,
                corners[..., 2:] - corners[..., :2],
            ],
            axis=-1,
        )
    elif coords == "minmax":
        out = corners[..., [0, 2, 1, 3]]
    else:
        raise ValueError(f"unknown coords {coords!r}")
    return out.astype(np.float32)


def build_anchors(
    spec: AnchorSpec,
    predictor_sizes: Sequence[tuple[int, int]],
    coords: str = "centroids",
) -> np.ndarray:
    """All anchors for a detector, flattened and concatenated across layers.

    Returns (n_boxes_total, 8) float32: 4 anchor coords (in `coords` format)
    followed by the 4 variances.  Row order is layer-major, then row-major
    over (fh, fw, n_boxes) -- the order of the head's NHWC reshape.
    """
    if len(predictor_sizes) != spec.n_layers:
        raise ValueError(
            f"got {len(predictor_sizes)} predictor sizes for {spec.n_layers} layers"
        )
    steps = spec.steps if spec.steps is not None else [None] * spec.n_layers
    offsets = spec.offsets if spec.offsets is not None else [None] * spec.n_layers
    pieces = []
    for i, fsize in enumerate(predictor_sizes):
        grid = anchor_grid_for_layer(
            fsize,
            spec.img_height,
            spec.img_width,
            this_scale=spec.scales[i],
            next_scale=spec.scales[i + 1],
            aspect_ratios=spec.aspect_ratios[i],
            two_boxes_for_ar1=spec.two_boxes_for_ar1,
            this_steps=steps[i],
            this_offsets=offsets[i],
            clip_boxes=spec.clip_boxes,
            normalize_coords=spec.normalize_coords,
            coords=coords,
        )
        pieces.append(grid.reshape(-1, 4))
    boxes = np.concatenate(pieces, axis=0)
    variances = np.broadcast_to(
        np.asarray(spec.variances, dtype=np.float32), boxes.shape
    )
    return np.concatenate([boxes, variances], axis=-1).astype(np.float32)
