"""Label-aware image ops, the host detection augmentation chains and the
classification views.

Counterpart of the JAX package's `data/augment.py`: the photometric,
geometric and patch-sampling ops of the reference's
`object_detection_2d_*_ops.py` and the Caffe-SSD training chain
`SSDDataAugmentation` that `DetectionPipeline(train=True)` runs by default,
plus the box filters and the preset chains; and the classification
photometric helpers (`grayscale`, `cls_*`) with the ImageNet training and
evaluation views that `ClassificationPipeline` runs.  Each op is a pure
function or class over an image (uint8 RGB; labels (k, 5) for detection)
that takes an explicit `np.random.Generator` and draws from it in the JAX
package's order, so both packages give identical images from one seed.

Geometric ops can emit inverters (callables mapping predicted boxes back to
original image coordinates), the reference's `apply_inverse_transforms`
contract.  cv2 is imported inside the functions that use it, so the
package imports where OpenCV is not installed.

Labels layout: (class_id, xmin, ymin, xmax, ymax) absolute pixel corners.
"""

from __future__ import annotations

import numpy as np


def _interp_modes():
    """cv2's five interpolation modes, in the order `ResizeRandomInterp`
    draws from."""
    import cv2

    return [
        cv2.INTER_NEAREST, cv2.INTER_LINEAR, cv2.INTER_CUBIC,
        cv2.INTER_AREA, cv2.INTER_LANCZOS4,
    ]


# ---------------------------------------------------------------------------
# photometric ops (detection chain; `object_detection_2d_photometric_ops.py`)
# ---------------------------------------------------------------------------

def to_3_channels(image):
    if image.ndim == 2:
        return np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 1:
        return np.concatenate([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        return image[..., :3]
    return image


def brightness_shift(image, delta):
    """Additive brightness in RGB space (`RandomBrightness`, delta in
    [-32, 32]).  Rounds (not truncates) back to uint8, matching the
    reference's float->uint8 step (`ConvertDataType`,
    `object_detection_2d_photometric_ops.py:62-88`: `np.round` then astype)
    — pinned by `tests/test_reference_parity.py`."""
    return (
        np.clip(image.astype(np.float32) + delta, 0, 255)
        .round()
        .astype(np.uint8)
    )


def contrast_scale(image, factor):
    """Multiplicative contrast about 127.5 (`Contrast`, `:281`); rounds back
    to uint8 per the reference's `ConvertDataType` (see brightness_shift)."""
    return (
        np.clip(127.5 + factor * (image.astype(np.float32) - 127.5), 0, 255)
        .round()
        .astype(np.uint8)
    )


def _rgb_to_hsv(image):
    import cv2

    return cv2.cvtColor(image, cv2.COLOR_RGB2HSV)


def _hsv_to_rgb(image):
    import cv2

    return cv2.cvtColor(image, cv2.COLOR_HSV2RGB)


def saturation_scale_hsv(hsv_f32, factor):
    hsv = hsv_f32.copy()
    hsv[..., 1] = np.clip(hsv[..., 1] * factor, 0, 255)
    return hsv


def hue_shift_hsv(hsv_f32, delta):
    """delta in [-180, 180]; OpenCV hue channel wraps at 180."""
    hsv = hsv_f32.copy()
    hsv[..., 0] = (hsv[..., 0] + delta) % 180.0
    return hsv


def gamma_adjust(image, gamma):
    """`Gamma` op (`photometric_ops.py:340`)."""
    table = (255.0 * ((np.arange(256) / 255.0) ** (1.0 / gamma))).astype(np.uint8)
    return table[image]


def channel_swap(image, order=(2, 1, 0)):
    return image[..., list(order)]


class SSDPhotometricDistortions:
    """The Caffe-SSD photometric pipeline
    (`data_augmentation_chain_original_ssd.py:146-206`): brightness ->
    (contrast early or late, 50/50) -> saturation -> hue, each applied with
    p=0.5; parameters exactly as the reference."""

    def __call__(self, image, labels, rng: np.random.Generator):
        image = to_3_channels(image)
        early_contrast = bool(rng.integers(0, 2))
        if rng.random() < 0.5:
            image = brightness_shift(image, rng.uniform(-32, 32))
        if early_contrast and rng.random() < 0.5:
            image = contrast_scale(image, rng.uniform(0.5, 1.5))
        hsv = _rgb_to_hsv(image).astype(np.float32)
        if rng.random() < 0.5:
            hsv = saturation_scale_hsv(hsv, rng.uniform(0.5, 1.5))
        if rng.random() < 0.5:
            hsv = hue_shift_hsv(hsv, rng.uniform(-18, 18))
        image = _hsv_to_rgb(np.clip(hsv, 0, 255).round().astype(np.uint8))
        if not early_contrast and rng.random() < 0.5:
            image = contrast_scale(image, rng.uniform(0.5, 1.5))
        return image, labels


# ---------------------------------------------------------------------------
# geometric ops (`object_detection_2d_geometric_ops.py`)
# ---------------------------------------------------------------------------

def resize(image, labels, height, width, interpolation=None,
           filter_degenerate=True, return_inverter=False):
    """Resize + box rescale + optional degenerate-box drop (`Resize`, `:27`).

    `interpolation` None means `cv2.INTER_LINEAR`."""
    import cv2

    h0, w0 = image.shape[:2]
    interp = interpolation if interpolation is not None else cv2.INTER_LINEAR
    out = cv2.resize(image, (width, height), interpolation=interp)
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        labels[:, [1, 3]] *= width / w0
        labels[:, [2, 4]] *= height / h0
        if filter_degenerate:
            keep = (labels[:, 3] - labels[:, 1] > 0) & (
                labels[:, 4] - labels[:, 2] > 0
            )
            labels = labels[keep]

    def inverter(boxes):
        """boxes (m, >=5) with coords in the last four columns."""
        boxes = np.asarray(boxes, np.float32).copy()
        boxes[:, -4] *= w0 / width
        boxes[:, -2] *= w0 / width
        boxes[:, -3] *= h0 / height
        boxes[:, -1] *= h0 / height
        return boxes

    if return_inverter:
        return out, labels, inverter
    return out, labels


class ResizeRandomInterp:
    def __init__(self, height=300, width=300):
        self.height, self.width = height, width

    def __call__(self, image, labels, rng, return_inverter=False):
        modes = _interp_modes()
        interp = modes[rng.integers(0, len(modes))]
        return resize(
            image, labels, self.height, self.width, interp,
            return_inverter=return_inverter,
        )


def horizontal_flip(image, labels):
    image = image[:, ::-1]
    if labels is not None and len(labels):
        w = image.shape[1]
        labels = labels.astype(np.float32).copy()
        labels[:, [1, 3]] = w - labels[:, [3, 1]]
    return image, labels


def vertical_flip(image, labels):
    image = image[::-1]
    if labels is not None and len(labels):
        h = image.shape[0]
        labels = labels.astype(np.float32).copy()
        labels[:, [2, 4]] = h - labels[:, [4, 2]]
    return image, labels


class RandomFlip:
    def __init__(self, dim="horizontal", prob=0.5):
        self.dim, self.prob = dim, prob

    def __call__(self, image, labels, rng):
        if rng.random() < self.prob:
            flip = horizontal_flip if self.dim == "horizontal" else vertical_flip
            return flip(image, labels)
        return image, labels


def translate(image, labels, dy, dx, background=(0, 0, 0), clip_boxes=True):
    """Integer-pixel translate with canvas fill (`Translate`, `:233`)."""
    h, w = image.shape[:2]
    out = np.empty_like(image)
    out[...] = np.asarray(background, image.dtype)
    ys = slice(max(dy, 0), min(h + dy, h))
    xs = slice(max(dx, 0), min(w + dx, w))
    src_ys = slice(max(-dy, 0), min(h - dy, h))
    src_xs = slice(max(-dx, 0), min(w - dx, w))
    out[ys, xs] = image[src_ys, src_xs]
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        labels[:, [1, 3]] += dx
        labels[:, [2, 4]] += dy
        if clip_boxes:
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, w - 1)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, h - 1)
            keep = (labels[:, 3] - labels[:, 1] > 0) & (
                labels[:, 4] - labels[:, 2] > 0
            )
            labels = labels[keep]
    return out, labels


def rotate90(image, labels, k=1):
    """Rotate by k*90 degrees (the box-exact subset of `Rotate`, `:659`)."""
    h, w = image.shape[:2]
    out = np.rot90(image, k).copy()
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        for _ in range(k % 4):
            x0, y0, x1, y1 = (labels[:, i].copy() for i in (1, 2, 3, 4))
            labels[:, 1], labels[:, 3] = y0, y1
            labels[:, 2], labels[:, 4] = w - x1, w - x0
            h, w = w, h
    return out, labels


# ---------------------------------------------------------------------------
# patch sampling (`object_detection_2d_patch_sampling_ops.py`)
# ---------------------------------------------------------------------------

def _iou_patch_boxes(patch, boxes):
    """IoU between one patch (xmin,ymin,xmax,ymax) and (k,4) boxes, 'half'
    border convention."""
    ix = np.maximum(
        0.0, np.minimum(patch[2], boxes[:, 2]) - np.maximum(patch[0], boxes[:, 0])
    )
    iy = np.maximum(
        0.0, np.minimum(patch[3], boxes[:, 3]) - np.maximum(patch[1], boxes[:, 1])
    )
    inter = ix * iy
    a_p = (patch[2] - patch[0]) * (patch[3] - patch[1])
    a_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = a_p + a_b - inter
    return np.where(union > 0, inter / union, 0.0)


def crop_patch(image, labels, ymin, xmin, height, width,
               background=(123, 117, 104), clip_boxes=True):
    """Extract a patch (supports positions outside the image = expand-style
    canvas fill), rewriting boxes into patch coordinates and keeping only
    boxes whose CENTER lies in the patch (the Caffe-SSD 'center_point'
    criterion, `data_augmentation_chain_original_ssd.py:70-74`)."""
    h, w = image.shape[:2]
    out = np.empty((height, width) + image.shape[2:], dtype=image.dtype)
    out[...] = np.asarray(background, image.dtype)
    # intersection of patch with image, in image coords
    iy0, iy1 = max(ymin, 0), min(ymin + height, h)
    ix0, ix1 = max(xmin, 0), min(xmin + width, w)
    if iy1 > iy0 and ix1 > ix0:
        out[iy0 - ymin : iy1 - ymin, ix0 - xmin : ix1 - xmin] = image[
            iy0:iy1, ix0:ix1
        ]
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        cx = (labels[:, 1] + labels[:, 3]) / 2 - xmin
        cy = (labels[:, 2] + labels[:, 4]) / 2 - ymin
        # Upper bound is `<= size - 1`, NOT `< size`: the reference's
        # center_point BoxFilter (`object_detection_2d_image_boxes_validation
        # _utils.py:228-232`) keeps centers in [0, size-1] — pinned by
        # `tests/test_reference_parity.py`.
        keep = (
            (cx >= 0) & (cx <= width - 1) & (cy >= 0) & (cy <= height - 1)
        )
        labels = labels[keep]
        labels[:, [1, 3]] -= xmin
        labels[:, [2, 4]] -= ymin
        if clip_boxes and len(labels):
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, width - 1)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, height - 1)
    return out, labels


class SSDExpand:
    """Random zoom-out: place the image on a 1x-4x mean-color canvas with
    p=0.5 (`data_augmentation_chain_original_ssd.py:103-144`)."""

    def __init__(self, background=(123, 117, 104)):
        self.background = background

    def __call__(self, image, labels, rng):
        if rng.random() >= 0.5:
            return image, labels
        h, w = image.shape[:2]
        scale = rng.uniform(1.0, 4.0)
        ph, pw = int(round(scale * h)), int(round(scale * w))
        ymin = -rng.integers(0, ph - h + 1)
        xmin = -rng.integers(0, pw - w + 1)
        return crop_patch(
            image, labels, ymin, xmin, ph, pw, self.background, clip_boxes=False
        )


class SSDRandomCrop:
    """Caffe-SSD min-IoU random crop
    (`data_augmentation_chain_original_ssd.py:29-101`): sample a lower IoU
    bound from {none, .1, .3, .5, .7, .9}; up to 50 trials of patches with
    scale in [0.3, 1] per dim and aspect ratio in [0.5, 2]; a patch is valid
    if >= 1 GT box has IoU >= bound; with p=0.143 per round, bail out and
    return the input unchanged."""

    SAMPLE_SPACE = (None, 0.1, 0.3, 0.5, 0.7, 0.9)

    def __call__(self, image, labels, rng):
        h, w = image.shape[:2]
        while True:
            bound = self.SAMPLE_SPACE[rng.integers(0, len(self.SAMPLE_SPACE))]
            for _ in range(50):
                if rng.random() >= 0.857:
                    return image, labels
                ph = int(round(rng.uniform(0.3, 1.0) * h))
                pw = int(round(rng.uniform(0.3, 1.0) * w))
                if ph < 1 or pw < 1:
                    continue
                ar = pw / ph
                if not (0.5 <= ar <= 2.0):
                    continue
                ymin = int(rng.integers(0, h - ph + 1))
                xmin = int(rng.integers(0, w - pw + 1))
                if bound is not None and labels is not None and len(labels):
                    patch = np.array(
                        [xmin, ymin, xmin + pw, ymin + ph], np.float32
                    )
                    ious = _iou_patch_boxes(patch, labels[:, 1:5])
                    if not (ious >= bound).any():
                        continue
                return crop_patch(
                    image, labels, ymin, xmin, ph, pw, clip_boxes=True
                )


class BoundGenerator:
    """Samples (lower, upper) bound pairs from a discrete space
    (`object_detection_2d_image_boxes_validation_utils.py:28-77`).  `None`
    entries normalize to 0.0 / 1.0."""

    def __init__(
        self,
        sample_space=((0.1, None), (0.3, None), (0.5, None), (0.7, None),
                      (0.9, None), (None, None)),
        weights=None,
    ):
        self.sample_space = []
        for lo, hi in sample_space:
            lo = 0.0 if lo is None else lo
            hi = 1.0 if hi is None else hi
            if lo > hi:
                raise ValueError("lower bound > upper bound")
            self.sample_space.append((lo, hi))
        n = len(self.sample_space)
        if weights is not None and len(weights) != n:
            raise ValueError("weights must match sample_space length")
        self.weights = list(weights) if weights is not None else [1.0 / n] * n

    def __call__(self, rng):
        i = rng.choice(len(self.sample_space), p=self.weights)
        return self.sample_space[i]


def _border_delta(border_pixels):
    return {"half": 0.0, "include": 1.0, "exclude": -1.0}[border_pixels]


def box_filter(
    labels,
    image_height=None,
    image_width=None,
    *,
    check_overlap=True,
    check_min_area=True,
    check_degenerate=True,
    overlap_criterion="center_point",
    overlap_bounds=(0.3, 1.0),
    min_area=16,
    border_pixels="half",
    rng=None,
):
    """Standalone box-validity filter — the reference's `BoxFilter`
    (`object_detection_2d_image_boxes_validation_utils.py:79-233`) as a pure
    function.  Returns the rows of `labels` (k, 5+) that satisfy every
    enabled criterion against an image of the given size:

      * 'center_point': box center inside [0, w-1] x [0, h-1];
      * 'area': intersection(box, image) / box area within bounds;
      * 'iou': IoU(box, image rect) within (lower, upper];
      plus optional degenerate-box and minimum-area checks.

    `overlap_bounds` may be a `BoundGenerator` (pass `rng`)."""
    labels = np.asarray(labels, dtype=np.float32)
    if labels.size == 0:
        return labels.reshape(0, labels.shape[-1] if labels.ndim > 1 else 5)
    keep = np.ones(labels.shape[0], dtype=bool)
    xmin, ymin, xmax, ymax = labels[:, 1], labels[:, 2], labels[:, 3], labels[:, 4]

    if check_degenerate:
        keep &= (xmax > xmin) & (ymax > ymin)
    if check_min_area:
        keep &= (xmax - xmin) * (ymax - ymin) >= min_area
    if check_overlap:
        if isinstance(overlap_bounds, BoundGenerator):
            if rng is None:
                raise ValueError("BoundGenerator bounds require rng")
            lower, upper = overlap_bounds(rng)
        else:
            lower, upper = overlap_bounds
        d = _border_delta(border_pixels)
        if overlap_criterion == "iou":
            # image rect is [0, 0, w, h] (`:197`), not [0, 0, w-1, h-1]
            ix = np.maximum(
                0.0, np.minimum(image_width, xmax) - np.maximum(0, xmin) + d
            )
            iy = np.maximum(
                0.0, np.minimum(image_height, ymax) - np.maximum(0, ymin) + d
            )
            inter = ix * iy
            a_img = (image_width + d) * (image_height + d)
            a_box = (xmax - xmin + d) * (ymax - ymin + d)
            union = a_img + a_box - inter
            iou_vals = np.where(union > 0, inter / union, 0.0)
            keep &= (iou_vals > lower) & (iou_vals <= upper)
        elif overlap_criterion == "area":
            a_box = (xmax - xmin + d) * (ymax - ymin + d)
            cx0 = np.clip(xmin, 0, image_width - 1)
            cx1 = np.clip(xmax, 0, image_width - 1)
            cy0 = np.clip(ymin, 0, image_height - 1)
            cy1 = np.clip(ymax, 0, image_height - 1)
            inter = (cx1 - cx0 + d) * (cy1 - cy0 + d)
            # `>` at lower == 0 so zero-area boxes never count
            # (`object_detection_2d_image_boxes_validation_utils.py:219-224`)
            lo_ok = (
                inter > lower * a_box if lower == 0.0 else inter >= lower * a_box
            )
            keep &= lo_ok & (inter <= upper * a_box)
        elif overlap_criterion == "center_point":
            cx = (xmin + xmax) / 2
            cy = (ymin + ymax) / 2
            keep &= (
                (cx >= 0.0) & (cx <= image_width - 1)
                & (cy >= 0.0) & (cy <= image_height - 1)
            )
        else:
            raise ValueError(f"unknown overlap_criterion {overlap_criterion!r}")
    return labels[keep]


def image_is_valid(
    labels,
    image_height,
    image_width,
    *,
    overlap_criterion="center_point",
    bounds=(0.3, 1.0),
    n_boxes_min=1,
    border_pixels="half",
    rng=None,
):
    """The reference's `ImageValidator`
    (`object_detection_2d_image_boxes_validation_utils.py:234-320`): True if
    at least `n_boxes_min` boxes (or 'all') meet the overlap criterion against
    an image of the given size."""
    labels = np.asarray(labels, dtype=np.float32)
    valid = box_filter(
        labels,
        image_height,
        image_width,
        check_overlap=True,
        check_min_area=False,
        check_degenerate=False,
        overlap_criterion=overlap_criterion,
        overlap_bounds=bounds,
        border_pixels=border_pixels,
        rng=rng,
    )
    if n_boxes_min == "all":
        return len(valid) == len(labels)
    return len(valid) >= n_boxes_min


class RandomMaxCropFixedAR:
    """Crop the largest possible patch of a fixed aspect ratio at a random
    position (`object_detection_2d_patch_sampling_ops.py:744-822`): up to
    `n_trials_max` positions are tried against `image_validator`; on failure
    the input is returned unchanged (RandomPatch `can_fail=False` path,
    `:548-570`)."""

    def __init__(self, patch_aspect_ratio, n_trials_max=3, clip_boxes=True,
                 image_validator=None):
        self.patch_aspect_ratio = patch_aspect_ratio
        self.n_trials_max = n_trials_max
        self.clip_boxes = clip_boxes
        self.image_validator = image_validator  # callable(labels, h, w, rng)

    def __call__(self, image, labels, rng):
        h, w = image.shape[:2]
        if w / h < self.patch_aspect_ratio:
            pw = w
            ph = int(round(pw / self.patch_aspect_ratio))
        else:
            ph = h
            pw = int(round(ph * self.patch_aspect_ratio))
        for _ in range(max(1, self.n_trials_max)):
            ymin = int(rng.integers(0, h - ph + 1)) if h > ph else 0
            xmin = int(rng.integers(0, w - pw + 1)) if w > pw else 0
            if labels is None or not len(labels) or self.image_validator is None:
                return crop_patch(
                    image, labels, ymin, xmin, ph, pw,
                    clip_boxes=self.clip_boxes,
                )
            shifted = labels.astype(np.float32).copy()
            shifted[:, [1, 3]] -= xmin
            shifted[:, [2, 4]] -= ymin
            if self.image_validator(shifted, ph, pw, rng):
                return crop_patch(
                    image, labels, ymin, xmin, ph, pw,
                    clip_boxes=self.clip_boxes,
                )
        return image, labels


class RandomPadFixedAR:
    """Minimal padding to reach a fixed aspect ratio, image placed at a random
    position on the canvas (`object_detection_2d_patch_sampling_ops.py:823-881`).

    Parity note: the pad axis is chosen by `w < h`, EXACTLY as the reference
    does (`:865-871`) — which means an AR/orientation mismatch (e.g. w=100,
    h=80, ar=2.0) yields a patch smaller than the image on one axis (a crop,
    not a pad), the reference's own behavior for that input."""

    def __init__(self, patch_aspect_ratio, background=(0, 0, 0)):
        self.patch_aspect_ratio = patch_aspect_ratio
        self.background = background

    def __call__(self, image, labels, rng):
        h, w = image.shape[:2]
        if w < h:
            ph = h
            pw = int(round(ph * self.patch_aspect_ratio))
        else:
            pw = w
            ph = int(round(pw / self.patch_aspect_ratio))
        # canvas >= image: offsets are non-positive (image inside the canvas)
        ymin = int(rng.integers(h - ph, 1)) if ph > h else 0
        xmin = int(rng.integers(w - pw, 1)) if pw > w else 0
        return crop_patch(
            image, labels, ymin, xmin, ph, pw,
            background=self.background, clip_boxes=False,
        )


class SSDDataAugmentation:
    """The full Caffe-SSD training chain: photometric -> expand -> random
    crop -> random hflip -> resize(300) with random interpolation
    (`data_augmentation_chain_original_ssd.py:208-280`)."""

    def __init__(self, img_height=300, img_width=300,
                 background=(123, 117, 104), crop=True):
        self.photometric = SSDPhotometricDistortions()
        self.expand = SSDExpand(background)
        self.crop = SSDRandomCrop() if crop else None
        self.flip = RandomFlip("horizontal", 0.5)
        self.resize = ResizeRandomInterp(img_height, img_width)

    def __call__(self, image, labels, rng, return_inverter=False):
        image, labels = self.photometric(image, labels, rng)
        image, labels = self.expand(image, labels, rng)
        if self.crop is not None:
            image, labels = self.crop(image, labels, rng)
        image, labels = self.flip(image, labels, rng)
        return self.resize(image, labels, rng, return_inverter=return_inverter)


def SSDDataAugmentationNoCrop(img_height=300, img_width=300,
                              background=(123, 117, 104)):
    """`--no_crop` chain variant (`data_augmentation_chain_original_ssd_no_crop.py:208`)."""
    return SSDDataAugmentation(img_height, img_width, background, crop=False)


# ---------------------------------------------------------------------------
# classification photometric helpers (`classification_part/.../helper.py`)
# ---------------------------------------------------------------------------

def grayscale(rgb):
    return rgb.dot([0.299, 0.587, 0.114])


# Deterministic cores (parameter injected) + drawing wrappers.  The alpha
# draw `2*U(0,1)*var + 1 - var` of the reference (`helper.py:18-19`) is
# 1 + U(-var, var), which the wrappers draw.


def cls_saturation_core(rgb, alpha):
    gs = grayscale(rgb)
    out = rgb * alpha + (1 - alpha) * gs[:, :, None]
    return np.clip(out, 0, 255).astype(np.uint8)


def cls_saturation(rgb, rng, var=0.5):
    return cls_saturation_core(rgb, 1.0 + rng.uniform(-var, var))


def cls_brightness_core(rgb, alpha):
    return np.clip(rgb * alpha, 0, 255).astype(np.uint8)


def cls_brightness(rgb, rng, var=0.5):
    return cls_brightness_core(rgb, 1.0 + rng.uniform(-var, var))


def cls_contrast_core(rgb, alpha):
    gs = grayscale(rgb).mean() * np.ones_like(rgb, dtype=np.float64)
    return np.clip(rgb * alpha + (1 - alpha) * gs, 0, 255).astype(np.uint8)


def cls_contrast(rgb, rng, var=0.5):
    return cls_contrast_core(rgb, 1.0 + rng.uniform(-var, var))


def cls_lighting_core(img, noise3):
    """AlexNet-style PCA color shift with the 3-vector draw injected."""
    cov = np.cov(img.reshape(-1, 3) / 255.0, rowvar=False)
    eigval, eigvec = np.linalg.eigh(cov)
    noise = eigvec.dot(eigval * noise3) * 255
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def cls_lighting(img, rng, std=0.5):
    """AlexNet-style PCA color augmentation (`helper.py:39-45`)."""
    return cls_lighting_core(img, rng.normal(0, std, 3))


CLASSIFICATION_TRANSFORMS = (cls_lighting, cls_contrast, cls_brightness,
                             cls_saturation)


def classification_train_view(image, rng, size=224,
                              transforms=CLASSIFICATION_TRANSFORMS):
    """The reference's ImageNet training view (`generators.py:141-177`):
    scale the shorter side to `size`, random crop, random hflip, then each
    photometric transform in shuffled order with p=0.5."""
    import cv2

    h, w = image.shape[:2]
    if h < w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    image = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    oy = int(rng.integers(0, nh - size + 1))
    ox = int(rng.integers(0, nw - size + 1))
    image = image[oy : oy + size, ox : ox + size]
    if rng.random() < 0.5:
        image = image[:, ::-1]
    order = rng.permutation(len(transforms))
    for i in order:
        if rng.random() < 0.5:
            image = transforms[i](image, rng)
    return np.ascontiguousarray(image)


def classification_eval_view(image, size=224):
    """Plain resize to (size, size) (`generators.py:161-163`)."""
    import cv2

    return cv2.resize(image, (size, size), interpolation=cv2.INTER_LINEAR)


# ---------------------------------------------------------------------------
# additional geometric ops + preset chains
# (`data_augmentation_chain_{constant_input_size,variable_input_size,
# satellite}.py`)
# ---------------------------------------------------------------------------

def scale_affine(image, labels, factor, background=(123, 117, 104),
                 clip_boxes=True):
    """Scale about the image center, keeping the canvas size (`Scale`,
    `object_detection_2d_geometric_ops.py:449`): zoom-in crops, zoom-out pads
    with the background color; boxes follow the affine map and are kept only
    if their center stays inside."""
    import cv2

    h, w = image.shape[:2]
    M = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), 0, factor)
    out = cv2.warpAffine(
        image, M, (w, h), borderMode=cv2.BORDER_CONSTANT,
        borderValue=tuple(int(c) for c in background),
    )
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        for cols in ((1, 2), (3, 4)):  # map both corners
            x, y = labels[:, cols[0]].copy(), labels[:, cols[1]].copy()
            labels[:, cols[0]] = M[0, 0] * x + M[0, 1] * y + M[0, 2]
            labels[:, cols[1]] = M[1, 0] * x + M[1, 1] * y + M[1, 2]
        cx = (labels[:, 1] + labels[:, 3]) / 2
        cy = (labels[:, 2] + labels[:, 4]) / 2
        keep = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        labels = labels[keep]
        if clip_boxes and len(labels):
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, w - 1)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, h - 1)
    return out, labels


class RandomTranslate:
    """Bounded-trials random translate (`RandomTranslate`, `:319`): the
    translation fractions are drawn per trial; a trial is valid if at least
    `n_boxes_min` box centers survive; after `n_trials_max` failures the
    input is returned unchanged."""

    def __init__(self, dy_minmax=(0.03, 0.3), dx_minmax=(0.03, 0.3),
                 prob=0.5, n_trials_max=3, background=(123, 117, 104),
                 n_boxes_min=1):
        self.dy_minmax, self.dx_minmax = dy_minmax, dx_minmax
        self.prob, self.n_trials_max = prob, n_trials_max
        self.background, self.n_boxes_min = background, n_boxes_min

    def __call__(self, image, labels, rng):
        if rng.random() >= self.prob:
            return image, labels
        h, w = image.shape[:2]
        for _ in range(max(1, self.n_trials_max)):
            dy = int(round(h * rng.uniform(*self.dy_minmax))) * (
                1 if rng.random() < 0.5 else -1
            )
            dx = int(round(w * rng.uniform(*self.dx_minmax))) * (
                1 if rng.random() < 0.5 else -1
            )
            out, lab = translate(image, labels, dy, dx, self.background)
            if labels is None or len(labels) == 0 or (
                lab is not None and len(lab) >= self.n_boxes_min
            ):
                return out, lab
        return image, labels


class RandomScale:
    """Bounded-trials random zoom (`RandomScale`, `:534`)."""

    def __init__(self, min_factor=0.5, max_factor=2.0, prob=0.5,
                 n_trials_max=3, background=(123, 117, 104), n_boxes_min=1):
        self.min_factor, self.max_factor = min_factor, max_factor
        self.prob, self.n_trials_max = prob, n_trials_max
        self.background, self.n_boxes_min = background, n_boxes_min

    def __call__(self, image, labels, rng):
        if rng.random() >= self.prob:
            return image, labels
        for _ in range(max(1, self.n_trials_max)):
            factor = rng.uniform(self.min_factor, self.max_factor)
            out, lab = scale_affine(image, labels, factor, self.background)
            if labels is None or len(labels) == 0 or (
                lab is not None and len(lab) >= self.n_boxes_min
            ):
                return out, lab
        return image, labels


class RandomPatchAspect:
    """Random patch with width-from-scale / height-from-aspect-ratio sampling
    (`PatchCoordinateGenerator(must_match='w_ar')` + `RandomPatch`,
    `patch_sampling_ops.py:24,429`), used by the variable-input-size chain."""

    def __init__(self, min_scale=0.3, max_scale=1.0, min_ar=0.5, max_ar=2.0,
                 n_trials_max=3, n_boxes_min=1):
        self.min_scale, self.max_scale = min_scale, max_scale
        self.min_ar, self.max_ar = min_ar, max_ar
        self.n_trials_max, self.n_boxes_min = n_trials_max, n_boxes_min

    def __call__(self, image, labels, rng):
        h, w = image.shape[:2]
        for _ in range(max(1, self.n_trials_max)):
            pw = max(1, int(round(w * rng.uniform(self.min_scale,
                                                  self.max_scale))))
            ph = max(1, int(round(pw / rng.uniform(self.min_ar, self.max_ar))))
            if ph > h or pw > w:
                continue
            ymin = int(rng.integers(0, h - ph + 1))
            xmin = int(rng.integers(0, w - pw + 1))
            out, lab = crop_patch(image, labels, ymin, xmin, ph, pw)
            if labels is None or len(labels) == 0 or (
                lab is not None and len(lab) >= self.n_boxes_min
            ):
                return out, lab
        return image, labels


class _PhotometricPreset:
    """Parametrized photometric block shared by the preset chains."""

    def __init__(self, brightness=(-48, 48, 0.5), contrast=(0.5, 1.8, 0.5),
                 saturation=(0.5, 1.8, 0.5), hue=(18, 0.5)):
        self.brightness, self.contrast = brightness, contrast
        self.saturation, self.hue = saturation, hue

    def __call__(self, image, labels, rng):
        image = to_3_channels(image)
        if rng.random() < self.brightness[2]:
            image = brightness_shift(
                image, rng.uniform(self.brightness[0], self.brightness[1])
            )
        if rng.random() < self.contrast[2]:
            image = contrast_scale(
                image, rng.uniform(self.contrast[0], self.contrast[1])
            )
        hsv = _rgb_to_hsv(image).astype(np.float32)
        if rng.random() < self.saturation[2]:
            hsv = saturation_scale_hsv(
                hsv, rng.uniform(self.saturation[0], self.saturation[1])
            )
        if rng.random() < self.hue[1]:
            hsv = hue_shift_hsv(hsv, rng.uniform(-self.hue[0], self.hue[0]))
        return _hsv_to_rgb(np.clip(hsv, 0, 255).astype(np.uint8)), labels


class DataAugmentationConstantInputSize:
    """Photometric + translate/zoom/flip for same-size inputs
    (`data_augmentation_chain_constant_input_size.py:26-186`): zoom-in runs
    translate-then-scale, zoom-out runs scale-then-translate, 50/50."""

    def __init__(self, background=(123, 117, 104)):
        self.photometric = _PhotometricPreset()
        self.translate_op = RandomTranslate(background=background)
        self.zoom_in = RandomScale(1.0, 2.0, 0.5, background=background)
        self.zoom_out = RandomScale(0.5, 1.0, 0.5, background=background)
        self.flip = RandomFlip("horizontal", 0.5)

    def __call__(self, image, labels, rng):
        image, labels = self.photometric(image, labels, rng)
        if rng.integers(0, 2):
            image, labels = self.translate_op(image, labels, rng)
            image, labels = self.zoom_in(image, labels, rng)
        else:
            image, labels = self.zoom_out(image, labels, rng)
            image, labels = self.translate_op(image, labels, rng)
        return self.flip(image, labels, rng)


class DataAugmentationVariableInputSize:
    """Photometric + random patch + flip + resize
    (`data_augmentation_chain_variable_input_size.py:29-160`)."""

    def __init__(self, img_height=300, img_width=300):
        self.photometric = _PhotometricPreset()
        self.patch = RandomPatchAspect()
        self.flip = RandomFlip("horizontal", 0.5)
        self.resize = ResizeRandomInterp(img_height, img_width)

    def __call__(self, image, labels, rng, return_inverter=False):
        image, labels = self.photometric(image, labels, rng)
        image, labels = self.patch(image, labels, rng)
        image, labels = self.flip(image, labels, rng)
        return self.resize(image, labels, rng, return_inverter=return_inverter)


class DataAugmentationSatellite:
    """Overhead-imagery chain (`data_augmentation_chain_satellite.py:28-155`):
    photometric + horizontal AND vertical flips + right-angle rotations +
    random patch + resize."""

    def __init__(self, img_height=300, img_width=300):
        self.photometric = _PhotometricPreset()
        self.hflip = RandomFlip("horizontal", 0.5)
        self.vflip = RandomFlip("vertical", 0.5)
        self.patch = RandomPatchAspect()
        self.resize = ResizeRandomInterp(img_height, img_width)

    def __call__(self, image, labels, rng, return_inverter=False):
        image, labels = self.photometric(image, labels, rng)
        image, labels = self.hflip(image, labels, rng)
        image, labels = self.vflip(image, labels, rng)
        if rng.random() < 0.5:
            image, labels = rotate90(image, labels, int(rng.integers(1, 4)))
        image, labels = self.patch(image, labels, rng)
        return self.resize(image, labels, rng, return_inverter=return_inverter)


def rotate_angle(image, labels, angle, scale=1.0, background=(123, 117, 104),
                 clip_boxes=True):
    """Arbitrary-angle rotation about the image center with box rewriting
    (`Rotate`, `object_detection_2d_geometric_ops.py:659`): each box's four
    corners are mapped through the rotation and re-boxed axis-aligned (the
    standard loose-fit convention); boxes whose centers leave the canvas are
    dropped."""
    import cv2

    h, w = image.shape[:2]
    M = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, scale)
    out = cv2.warpAffine(
        image, M, (w, h), borderMode=cv2.BORDER_CONSTANT,
        borderValue=tuple(int(c) for c in background),
    )
    if labels is not None and len(labels):
        labels = labels.astype(np.float32).copy()
        x0, y0, x1, y1 = (labels[:, i] for i in (1, 2, 3, 4))
        corners = np.stack(
            [
                np.stack([x0, y0], 1), np.stack([x1, y0], 1),
                np.stack([x0, y1], 1), np.stack([x1, y1], 1),
            ],
            axis=1,
        )  # (k, 4, 2)
        ones = np.ones((*corners.shape[:2], 1), np.float32)
        mapped = np.concatenate([corners, ones], -1) @ M.T  # (k, 4, 2)
        labels[:, 1] = mapped[..., 0].min(1)
        labels[:, 3] = mapped[..., 0].max(1)
        labels[:, 2] = mapped[..., 1].min(1)
        labels[:, 4] = mapped[..., 1].max(1)
        cx = (labels[:, 1] + labels[:, 3]) / 2
        cy = (labels[:, 2] + labels[:, 4]) / 2
        keep = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        labels = labels[keep]
        if clip_boxes and len(labels):
            labels[:, [1, 3]] = labels[:, [1, 3]].clip(0, w - 1)
            labels[:, [2, 4]] = labels[:, [2, 4]].clip(0, h - 1)
    return out, labels
