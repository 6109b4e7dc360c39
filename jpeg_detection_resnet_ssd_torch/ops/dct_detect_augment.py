"""Device-side DETECTION augmentation in DCT space: expand, crop, resize and
flip with the ground truth rewritten to match.

Counterpart of the JAX package's `ops/dct_detect_augment.py`.  The host
ships one oversized coefficient map (e.g. 44 blocks, 352 px) + padded GT per
image; the chain runs on the device in coefficient space and hands the
cropped maps and rewritten GT to the in-step target encoder.

Every random op is split in two (see `ops._draws`): a host sampler
`sample_...(batch_size, h8, w8, generator, ...)` that draws every value
the JAX op draws, with the same distributions and derived values, and a
deterministic `..._apply(y, cbcr, gt, gt_mask, draws, ...)` that runs
batched on the device (the JAX per-image vmaps are batch axes here: no
Python loop over images).  The op of the JAX name composes the two.  The
makers return a `DetectionAugment`, a trainer `augment_fn` `(batch,
generator) -> batch` that moves the batch to its device (CUDA unless
`device="cpu"`), draws on the host, copies the draws once, and applies.

Every horizontal flip is `ops.dct_flip.dct_flip_horizontal`, the CUDA kernel
on the card: one launch for the luma map and one for the chroma map.

Labels layout: (max_gt, 5) rows (class_id, xmin, ymin, xmax, ymax) in
absolute pixels of the SOURCE map, plus a validity mask.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.ops import _draws
from jpeg_detection_resnet_ssd_torch.ops.dct_augment import (  # noqa: F401  (re-exported)
    DeviceAugment,
    crop_flip_maps,
    dct_downscale_2x,
    dct_random_photometric_apply,
    flip_where,
    sample_crop_flip,
    sample_photometric,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_resize import N_INTERP_MODES, dct_crop_resize, fma
from jpeg_detection_resnet_ssd_torch.ops.jpeg_quant import jpeg_requantize
from jpeg_detection_resnet_ssd_torch.ops.pixel_photometric import (
    dct_pixel_photometric_apply,
    sample_pixel_photometric,
)
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Caffe-SSD min-IoU sample space; -1 encodes "no requirement".
_IOU_BOUNDS = np.asarray([-1.0, 0.1, 0.3, 0.5, 0.7, 0.9], np.float32)

BACKGROUND = (123, 117, 104)
PHOTOMETRIC_MODES = (True, False, "dct", "pixel_hsv")


def _rgb_to_ycbcr_dc(background):
    """Constant-color 8x8 block DC coefficients (orthonormal DCT of the
    level-shifted plane): DC = 8 * (value - 128), AC = 0."""
    r, g, b = (float(v) for v in background)
    yy = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return 8.0 * (yy - 128.0), 8.0 * (cb - 128.0), 8.0 * (cr - 128.0)


@functools.lru_cache(maxsize=None)
def _background_blocks(background: tuple, dtype: torch.dtype, device: torch.device):
    """One constant-color (64,) luma and (128,) stacked-chroma block."""
    dc_y, dc_cb, dc_cr = _rgb_to_ycbcr_dc(background)
    c_y = torch.zeros(64, dtype=dtype)
    c_y[0] = dc_y
    c_c = torch.zeros(128, dtype=dtype)
    c_c[0], c_c[64] = dc_cb, dc_cr
    return c_y.to(device), c_c.to(device)


def _background_maps(y_shape, cbcr_shape, background, dtype, device=None):
    """Constant-color coefficient maps (luma, stacked CbCr), as broadcast views."""
    c_y, c_c = _background_blocks(tuple(background), dtype, torch.device(device or "cpu"))
    return c_y.expand(*y_shape), c_c.expand(*cbcr_shape)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none), as
    `jnp.argmax` of a bool array."""
    return mask.to(torch.uint8).argmax(-1)


def _take(values: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """values[b, index[b]] for (B, T) values and (B,) indices."""
    return values.gather(1, index[:, None])[:, 0]


# ---------------------------------------------------------------------------
# expand (2x zoom-out, block-aligned)
# ---------------------------------------------------------------------------

def sample_expand(batch_size: int, h8: int, w8: int, generator=None, prob: float = 0.5) -> dict:
    """With probability `prob` an image is expanded; its placement offset is
    uniform on 0..H8/4 (0..W8/4) chroma blocks (16 px)."""
    return {
        "do": _draws.bernoulli(generator, prob, (batch_size,)),
        "oy": _draws.randint(generator, (batch_size,), 0, h8 // 4 + 1),
        "ox": _draws.randint(generator, (batch_size,), 0, w8 // 4 + 1),
    }


def _place(small: torch.Tensor, canvas: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor):
    """`lax.dynamic_update_slice` per image: (B, h, w, C) maps written into
    a (H, W, C) canvas at block offsets (oy, ox), as index arithmetic."""
    b, h, w, _ = small.shape
    H, W = canvas.shape[-3], canvas.shape[-2]
    dev = small.device
    oy, ox = oy.clamp(0, H - h), ox.clamp(0, W - w)
    rows = torch.arange(H, device=dev) - oy[:, None]  # (B, H)
    cols = torch.arange(W, device=dev) - ox[:, None]
    inside = (((rows >= 0) & (rows < h))[:, :, None] & ((cols >= 0) & (cols < w))[:, None, :])
    bi = torch.arange(b, device=dev)[:, None, None]
    got = small[bi, rows.clamp(0, h - 1)[:, :, None], cols.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], got, canvas)


def dct_detection_expand_apply(y, cbcr, gt, gt_mask, draws: dict, background=BACKGROUND):
    """Block-granular zoom-out (the analog of the reference's `SSDExpand`):
    where `draws["do"]`, the image is downscaled exactly 2x in the DCT domain
    and placed at (oy, ox) chroma blocks on a same-size background canvas;
    GT boxes are halved and shifted.

    Shapes: y (B, H8, W8, 64) with H8, W8 divisible by 4; cbcr
    (B, H8/2, W8/2, 128); gt (B, max_gt, 5) absolute pixels; gt_mask (B, max_gt)."""
    B, H8, W8, _ = y.shape
    if H8 % 4 or W8 % 4:
        raise ValueError(f"expand requires H8, W8 divisible by 4, got {tuple(y.shape)}")
    do, oy, ox = draws["do"], draws["oy"], draws["ox"]
    bg_y, bg_c = _background_maps(y.shape[1:], cbcr.shape[1:], background, y.dtype, y.device)
    y_exp = _place(dct_downscale_2x(y), bg_y, 2 * oy, 2 * ox)
    c_exp = _place(dct_downscale_2x(cbcr), bg_c, oy, ox)
    y_out = torch.where(do[:, None, None, None], y_exp, y)
    c_out = torch.where(do[:, None, None, None], c_exp, cbcr)

    dx = (16.0 * ox)[:, None].to(gt.dtype)
    dy = (16.0 * oy)[:, None].to(gt.dtype)
    gt_exp = torch.stack(
        [gt[..., 0], gt[..., 1] * 0.5 + dx, gt[..., 2] * 0.5 + dy,
         gt[..., 3] * 0.5 + dx, gt[..., 4] * 0.5 + dy],
        dim=-1,
    )
    gt_out = torch.where(do[:, None, None], gt_exp, gt)
    return y_out, c_out, gt_out, gt_mask


def dct_detection_expand(y, cbcr, gt, gt_mask, generator=None, prob=0.5, background=BACKGROUND):
    """`dct_detection_expand_apply` with draws from `generator`."""
    draws = _draws.to_device(sample_expand(y.shape[0], y.shape[1], y.shape[2], generator, prob),
                             y.device)
    return dct_detection_expand_apply(y, cbcr, gt, gt_mask, draws, background)


# ---------------------------------------------------------------------------
# block-aligned crop + flip
# ---------------------------------------------------------------------------

def _patch_gt_iou(x0px, y0px, w_px, h_px, gt, gt_mask):
    """(B, T) max IoU between each of T patches [x0, y0, x0+w, y0+h] of an
    image and its valid GT.  The patch parameters are (B, T) tensors or
    Python floats; gt (B, G, 5), gt_mask (B, G)."""
    def col(t):
        return t[..., None] if torch.is_tensor(t) else t

    x0px, y0px, w_px, h_px = col(x0px), col(y0px), col(w_px), col(h_px)
    g1, g2, g3, g4 = (gt[:, None, :, k] for k in range(1, 5))
    ix = torch.clamp(torch.minimum(x0px + w_px, g3) - torch.maximum(g1, x0px), min=0.0)
    iy = torch.clamp(torch.minimum(y0px + h_px, g4) - torch.maximum(g2, y0px), min=0.0)
    inter = ix * iy
    a_p = w_px * h_px
    a_b = (g3 - g1) * (g4 - g2)
    union = a_p + a_b - inter
    iou = torch.where((union > 0) & gt_mask[:, None, :], inter / union, 0.0)
    return torch.clamp(iou.amax(-1), min=0.0)  # jnp.max(iou, initial=0.0)


def _rewrite_boxes(cls, xmin, ymin, xmax, ymax, flip, gt_mask, out_px: int):
    """Boxes in the output frame: mirror where flipped, keep those whose
    centre stays inside (the Caffe 'center_point' criterion), clip, drop the
    degenerate, zero the invalid rows.  Coordinates are (B, G)."""
    f = flip[:, None]
    xmin, xmax = torch.where(f, out_px - xmax, xmin), torch.where(f, out_px - xmin, xmax)
    cx = (xmin + xmax) / 2.0
    cy = (ymin + ymax) / 2.0
    inside = (cx >= 0) & (cx < out_px) & (cy >= 0) & (cy < out_px)
    new_mask = gt_mask & inside
    hi = out_px - 1.0
    xmin, xmax = torch.clamp(xmin, 0.0, hi), torch.clamp(xmax, 0.0, hi)
    ymin, ymax = torch.clamp(ymin, 0.0, hi), torch.clamp(ymax, 0.0, hi)
    new_mask = new_mask & (xmax > xmin) & (ymax > ymin)
    new_gt = torch.stack([cls, xmin, ymin, xmax, ymax], dim=-1)
    return torch.where(new_mask[..., None], new_gt, 0.0), new_mask


def _crop_flip(y, cbcr, gt, gt_mask, y0c, x0c, flip, out_y_blocks: int):
    """Crop every image's (y, cbcr) at its chroma-block offset (y0c, x0c),
    flip where `flip`, and rewrite the GT."""
    yc, cc = crop_flip_maps(y, cbcr, y0c, x0c, flip, out_y_blocks)
    dx = (16 * x0c).float()[:, None]
    dy = (16 * y0c).float()[:, None]
    new_gt, new_mask = _rewrite_boxes(
        gt[..., 0], gt[..., 1] - dx, gt[..., 2] - dy, gt[..., 3] - dx, gt[..., 4] - dy,
        flip, gt_mask, out_y_blocks * 8,
    )
    return yc, cc, new_gt, new_mask


def dct_detection_crop_flip_apply(y, cbcr, gt, gt_mask, draws: dict, out_y_blocks: int = 38):
    """Batched block-aligned crop + hflip with GT rewrite.

    y: (B, H8, W8, 64) (H8, W8 >= out_y_blocks, even); cbcr (B, H8/2, W8/2,
    128); gt (B, max_gt, 5) in the SOURCE frame; gt_mask (B, max_gt).
    Returns (y_out, cbcr_out, gt_out, mask_out) with gt in the CROP frame."""
    return _crop_flip(y, cbcr, gt, gt_mask, draws["y0"], draws["x0"], draws["flip"], out_y_blocks)


def dct_detection_crop_flip(y, cbcr, gt, gt_mask, generator=None, out_y_blocks: int = 38):
    """`dct_detection_crop_flip_apply` with draws from `generator`."""
    draws = _draws.to_device(
        sample_crop_flip(y.shape[0], y.shape[1], y.shape[2], generator, out_y_blocks), y.device)
    return dct_detection_crop_flip_apply(y, cbcr, gt, gt_mask, draws, out_y_blocks)


def _iou_bounds(generator, batch_size: int) -> torch.Tensor:
    return torch.from_numpy(_IOU_BOUNDS)[
        _draws.randint(generator, (batch_size,), 0, _IOU_BOUNDS.shape[0])]


def sample_min_iou_crop_flip(batch_size: int, h8: int, w8: int, generator=None,
                             out_y_blocks: int = 38, n_trials: int = 8) -> dict:
    """A min-IoU bound from `_IOU_BOUNDS`, `n_trials` candidate 16-px-aligned
    offsets and a fair flip per image."""
    shape = (batch_size, n_trials)
    return {
        "bound": _iou_bounds(generator, batch_size),
        "y0": _draws.randint(generator, shape, 0, (h8 - out_y_blocks) // 2 + 1),
        "x0": _draws.randint(generator, shape, 0, (w8 - out_y_blocks) // 2 + 1),
        "flip": _draws.bernoulli(generator, 0.5, (batch_size,)),
    }


def dct_detection_min_iou_crop_flip_apply(y, cbcr, gt, gt_mask, draws: dict,
                                          out_y_blocks: int = 38):
    """Bounded-trials min-IoU random crop + hflip (the Caffe-SSD random
    crop's analog): every candidate's max patch-GT IoU is scored at once,
    the first candidate meeting the image's bound is taken, else the
    highest-IoU one.  Returns (y_out, cbcr_out, gt_out, mask_out)."""
    out_px = out_y_blocks * 8
    y0s, x0s, bound = draws["y0"], draws["x0"], draws["bound"]
    ious = _patch_gt_iou((16 * x0s).float(), (16 * y0s).float(), float(out_px), float(out_px),
                         gt, gt_mask)
    ok = (ious >= bound[:, None]) | (bound < 0.0)[:, None] | ~gt_mask.any(-1)[:, None]
    pick = torch.where(ok.any(-1), _first_true(ok), ious.argmax(-1))
    return _crop_flip(y, cbcr, gt, gt_mask, _take(y0s, pick), _take(x0s, pick), draws["flip"],
                      out_y_blocks)


def dct_detection_min_iou_crop_flip(y, cbcr, gt, gt_mask, generator=None,
                                    out_y_blocks: int = 38, n_trials: int = 8):
    """`dct_detection_min_iou_crop_flip_apply` with draws from `generator`."""
    draws = _draws.to_device(sample_min_iou_crop_flip(
        y.shape[0], y.shape[1], y.shape[2], generator, out_y_blocks, n_trials), y.device)
    return dct_detection_min_iou_crop_flip_apply(y, cbcr, gt, gt_mask, draws, out_y_blocks)


# ---------------------------------------------------------------------------
# continuous expand + min-IoU crop + resize
# ---------------------------------------------------------------------------

def sample_random_resized_crop(batch_size: int, h8: int, w8: int, generator=None,
                               n_trials: int = 8, expand_prob: float = 0.5,
                               expand_max: float = 4.0, scale_min: float = 0.3,
                               scale_max: float = 1.0, identity_prob: float = 0.3) -> dict:
    """Draws of `dct_detection_random_resized_crop`: per image an expand
    factor f (U(1, expand_max) with p=expand_prob, else 1) and the source's
    placement (py, px) on the f-times canvas, an interpolation mode of the
    5, a min-IoU bound, n_trials patch scales (U(scale_min, scale_max) per
    side) and positions, a fair flip, and the full-canvas bail-out with
    p=identity_prob."""
    B, T = batch_size, n_trials
    H, W = float(h8 * 8), float(w8 * 8)
    do_exp = _draws.bernoulli(generator, expand_prob, (B,))
    f = torch.where(do_exp, _draws.uniform(generator, (B,), 1.0, expand_max), 1.0)
    return {
        "f": f,
        "py": _draws.uniform(generator, (B,)) * (f * H - H),
        "px": _draws.uniform(generator, (B,)) * (f * W - W),
        "bound": _iou_bounds(generator, B),
        "s_h": _draws.uniform(generator, (B, T), scale_min, scale_max),
        "s_w": _draws.uniform(generator, (B, T), scale_min, scale_max),
        "u": _draws.uniform(generator, (B, T, 2)),
        "flip": _draws.bernoulli(generator, 0.5, (B,)),
        "ident": _draws.bernoulli(generator, identity_prob, (B,)),
        "interp_mode": _draws.randint(generator, (B,), 0, N_INTERP_MODES),
    }


def dct_detection_random_resized_crop_apply(y, cbcr, gt, gt_mask, draws: dict,
                                            out_y_blocks: int = 38, background=BACKGROUND):
    """CONTINUOUS-scale expand + min-IoU crop + resize + hflip on the device.

    The f-times canvas is never built: a crop in canvas coordinates maps to
    source coordinates by subtracting the placement offset, and out-of-source
    regions decode to the background color through the resample's residual
    mass.  Candidates with aspect ratio outside [0.5, 2] are skipped; the
    first meeting the image's IoU bound is taken, else the highest-IoU one,
    else (no aspect ratio fits) the full canvas; the bail-out also takes the
    full canvas.  The crop is cropped and resized to the fixed output frame
    in one linear op (`dct_crop_resize`, the image's interpolation mode).

    Returns (y_out, cbcr_out, gt_out, mask_out); gt in output-frame pixels."""
    B, H8, W8, _ = y.shape
    H, W = float(H8 * 8), float(W8 * 8)
    out_px = out_y_blocks * 8
    dc_y, dc_cb, dc_cr = _rgb_to_ycbcr_dc(background)
    # dct_crop_resize wants level-shifted pixel values (DC / 8)
    bg_y, bg_cb, bg_cr = dc_y / 8.0, dc_cb / 8.0, dc_cr / 8.0

    py, px, bound = draws["py"], draws["px"], draws["bound"]
    ch_canvas, cw_canvas = draws["f"] * H, draws["f"] * W
    chc, cwc = ch_canvas[:, None], cw_canvas[:, None]
    ph = draws["s_h"] * chc
    pw = draws["s_w"] * cwc
    ar_ok = (pw / ph >= 0.5) & (pw / ph <= 2.0)
    u = draws["u"]
    # in SOURCE coords; every multiply-add rounded once, as XLA fuses them
    cy0 = fma(u[..., 0], fma(-draws["s_h"], chc, chc), -py[:, None])
    cx0 = fma(u[..., 1], fma(-draws["s_w"], cwc, cwc), -px[:, None])
    ious = _patch_gt_iou(cx0, cy0, pw, ph, gt, gt_mask)
    ok = ar_ok & ((ious >= bound[:, None]) | (bound < 0.0)[:, None] | ~gt_mask.any(-1)[:, None])
    best = torch.where(ar_ok, ious, -1.0).argmax(-1)
    pick = torch.where(ok.any(-1), _first_true(ok), best)
    # no trial satisfied even the aspect-ratio constraint: the full canvas
    valid = ar_ok.any(-1)
    ry0 = torch.where(valid, _take(cy0, pick), -py)
    rx0 = torch.where(valid, _take(cx0, pick), -px)
    hh = torch.where(valid, _take(ph, pick), ch_canvas)
    ww = torch.where(valid, _take(pw, pick), cw_canvas)

    # bail-out analog: keep the full (possibly expanded) canvas view
    ident = draws["ident"]
    ry0 = torch.where(ident, -py, ry0)
    rx0 = torch.where(ident, -px, rx0)
    hh = torch.where(ident, ch_canvas, hh)
    ww = torch.where(ident, cw_canvas, ww)

    mode, flip = draws["interp_mode"], draws["flip"]
    y_out = dct_crop_resize(y, ry0, rx0, hh, ww, out_px, out_px, background=bg_y,
                            interp_mode=mode)
    c_out = dct_crop_resize(cbcr, ry0 / 2.0, rx0 / 2.0, hh / 2.0, ww / 2.0,
                            out_px // 2, out_px // 2, background=(bg_cb, bg_cr),
                            interp_mode=mode)
    y_out, c_out = flip_where(flip, y_out), flip_where(flip, c_out)

    sx = (out_px / ww)[:, None]
    sy = (out_px / hh)[:, None]
    rx, ry = rx0[:, None], ry0[:, None]
    new_gt, new_mask = _rewrite_boxes(
        gt[..., 0], (gt[..., 1] - rx) * sx, (gt[..., 2] - ry) * sy,
        (gt[..., 3] - rx) * sx, (gt[..., 4] - ry) * sy, flip, gt_mask, out_px,
    )
    return y_out, c_out, new_gt, new_mask


def dct_detection_random_resized_crop(y, cbcr, gt, gt_mask, generator=None,
                                      out_y_blocks: int = 38, n_trials: int = 8,
                                      expand_prob: float = 0.5, expand_max: float = 4.0,
                                      scale_min: float = 0.3, scale_max: float = 1.0,
                                      identity_prob: float = 0.3, background=BACKGROUND):
    """`dct_detection_random_resized_crop_apply` with draws from `generator`."""
    draws = _draws.to_device(sample_random_resized_crop(
        y.shape[0], y.shape[1], y.shape[2], generator, n_trials, expand_prob, expand_max,
        scale_min, scale_max, identity_prob), y.device)
    return dct_detection_random_resized_crop_apply(y, cbcr, gt, gt_mask, draws, out_y_blocks,
                                                   background)


# ---------------------------------------------------------------------------
# trainer augment_fns
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DetectionAugment(DeviceAugment):
    """A `DeviceAugment` whose calls also move the batch's "gt" and
    "gt_mask" to its device."""

    def to_device(self, batch: dict) -> dict:
        out = super().to_device(batch)
        out["gt"] = torch.as_tensor(batch["gt"], dtype=torch.float32, device=self.device)
        out["gt_mask"] = torch.as_tensor(batch["gt_mask"], dtype=torch.bool, device=self.device)
        return out


def _with(batch: dict, y, cbcr, gt, mask) -> dict:
    out = dict(batch)
    out["inputs"] = (y, cbcr)
    out["gt"], out["gt_mask"] = gt, mask
    return out


def make_dct_detection_augment(out_y_blocks: int = 38, device=None) -> DetectionAugment:
    """Block-aligned random crop + hflip with GT rewrite, on `device` (None
    means CUDA and raises without a card).  Integer (int16-shipped)
    coefficients are cast to float32 first; float maps keep their dtype.

    Usage:
        enc = TargetEncoder(AnchorSpec(img_height=304, img_width=304), ..)
        fit(config, batches, target_encoder=enc,
            augment_fn=make_dct_detection_augment(38))   # 44-block source maps
    """
    dev = resolve_device(device)

    def sample(b, h8, w8, generator):
        return {"crop": sample_crop_flip(b, h8, w8, generator, out_y_blocks)}

    def apply(batch, draws):
        y, cbcr = (a if a.is_floating_point() else a.float() for a in batch["inputs"])
        return _with(batch, *dct_detection_crop_flip_apply(
            y, cbcr, batch["gt"], batch["gt_mask"], draws["crop"], out_y_blocks))

    return DetectionAugment(sample, apply, dev)


def make_dct_detection_augment_v2(out_y_blocks: int = 38, expand_prob: float = 0.5,
                                  n_trials: int = 8, photometric: bool = True,
                                  background=BACKGROUND, device=None) -> DetectionAugment:
    """The block-aligned analog of the reference's SSD training chain:
    DCT-domain photometric -> 2x expand onto a mean-color canvas (with p =
    expand_prob) -> bounded-trials min-IoU crop + hflip; inputs cast to
    float32 on the device.  The host ships maps whose side is a multiple of
    4 blocks (e.g. 44 -> 352 px)."""
    dev = resolve_device(device)

    def sample(b, h8, w8, generator):
        draws = {}
        if photometric:
            draws["photometric"] = sample_photometric(b, generator)
        if expand_prob > 0:
            draws["expand"] = sample_expand(b, h8, w8, generator, expand_prob)
        draws["crop"] = sample_min_iou_crop_flip(b, h8, w8, generator, out_y_blocks, n_trials)
        return draws

    def apply(batch, draws):
        y, cbcr = (a.float() for a in batch["inputs"])
        gt, mask = batch["gt"], batch["gt_mask"]
        if photometric:
            y, cbcr = dct_random_photometric_apply(y, cbcr, draws["photometric"])
        if expand_prob > 0:
            y, cbcr, gt, mask = dct_detection_expand_apply(y, cbcr, gt, mask, draws["expand"],
                                                           background)
        return _with(batch, *dct_detection_min_iou_crop_flip_apply(
            y, cbcr, gt, mask, draws["crop"], out_y_blocks))

    return DetectionAugment(sample, apply, dev)


def make_dct_detection_augment_v3(out_y_blocks: int = 38, n_trials: int = 8,
                                  expand_prob: float = 0.5, expand_max: float = 4.0,
                                  scale_range=(0.3, 1.0), identity_prob: float = 0.3,
                                  photometric: bool | str = True, background=BACKGROUND,
                                  requantize_quality: int | None = None,
                                  device=None) -> DetectionAugment:
    """Device-side SSD augmentation with continuous scale semantics:
    photometric -> [expand U(1, 4) + min-IoU crop U(0.3, 1) + resize, one
    linear DCT op] -> hflip (-> requantization).  Inputs cast to float32 on
    the device.

    `photometric`: True/"dct" = coefficient-domain brightness/contrast +
    chroma-rotation hue/sat; "pixel_hsv" = exact reference semantics via
    on-device pixel reconstruction; False = none.  `requantize_quality`: if
    set, snap the output coefficients to that JPEG quality's grid."""
    if photometric not in PHOTOMETRIC_MODES:
        raise ValueError(f"unknown photometric mode {photometric!r}")
    dev = resolve_device(device)
    pixel = photometric == "pixel_hsv"

    def sample(b, h8, w8, generator):
        draws = {}
        if photometric:
            draws["photometric"] = (sample_pixel_photometric if pixel else sample_photometric)(
                b, generator)
        draws["crop"] = sample_random_resized_crop(
            b, h8, w8, generator, n_trials, expand_prob, expand_max, scale_range[0],
            scale_range[1], identity_prob)
        return draws

    def apply(batch, draws):
        y, cbcr = (a.float() for a in batch["inputs"])
        gt, mask = batch["gt"], batch["gt_mask"]
        if pixel:
            y, cbcr = dct_pixel_photometric_apply(y, cbcr, **draws["photometric"])
        elif photometric:
            y, cbcr = dct_random_photometric_apply(y, cbcr, draws["photometric"])
        y, cbcr, gt, mask = dct_detection_random_resized_crop_apply(
            y, cbcr, gt, mask, draws["crop"], out_y_blocks, background)
        if requantize_quality is not None:
            y, cbcr = jpeg_requantize(y, cbcr, requantize_quality)
        return _with(batch, y, cbcr, gt, mask)

    return DetectionAugment(sample, apply, dev)
