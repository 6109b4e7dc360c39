"""DCT-coefficient-domain augmentation: flip, crop, 2x downscale and
photometric adjustment WITHOUT re-encoding.

Counterpart of the JAX package's `ops/dct_augment.py`, on `(..., H8, W8,
64k)` coefficient tensors on the device:

  * horizontal flip: reverse the block columns AND negate every
    odd-column-frequency coefficient (`ops.dct_flip`, the CUDA kernel on the
    card); vertical flip: the same in rows;
  * crop: 8-pixel-aligned block slicing (`lax.dynamic_slice` semantics,
    with one offset per image when the offsets are tensors);
  * 2x downscale: an exact linear map, four 8x8 matrix products per block;
  * brightness/contrast and chroma hue/saturation: exact linear maps of the
    coefficients.

Every random op is split into a host sampler (`sample_photometric`,
`sample_crop_flip`, `sample_classification_crop`) and a deterministic apply
(`dct_random_photometric_apply`, ...); see `ops._draws`.  The classification
augments `make_dct_classification_augment(_v2)` return a `DeviceAugment`,
a trainer `augment_fn` `(batch, generator) -> batch` that moves the batch's
planes to its device (CUDA unless `device="cpu"`), draws on the host,
copies the draws once and applies.  Every horizontal flip is
`ops.dct_flip.dct_flip_horizontal`, the CUDA kernel on the card: one launch
for the luma map and one for the chroma map.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.ops import _draws
from jpeg_detection_resnet_ssd_torch.ops.dct_flip import (  # noqa: F401  (re-exported)
    _COL_SIGNS,
    _signs_for,
    dct_flip_horizontal,
)
from jpeg_detection_resnet_ssd_torch.ops.dct_resize import INTERP_BILINEAR, dct_crop_resize
from jpeg_detection_resnet_ssd_torch.parallel.mesh import active_mesh, shard_batch
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# (-1)^u pattern, varying along rows of the 8x8 block
_ROW_SIGNS = np.where((np.arange(64) // 8) % 2 == 0, 1.0, -1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _row_signs(channels: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_signs_for(channels, _ROW_SIGNS), dtype=dtype, device=device)


def dct_flip_vertical(blocks: torch.Tensor) -> torch.Tensor:
    """Vertical flip: reverse block rows, negate odd row frequencies."""
    return blocks.flip(-3) * _row_signs(blocks.shape[-1], blocks.device, blocks.dtype)


def dct_crop_blocks(blocks: torch.Tensor, y0, x0, h8: int, w8: int) -> torch.Tensor:
    """Block-aligned crop blocks[..., y0:y0+h8, x0:x0+w8, :] (8-pixel
    granularity), with `lax.dynamic_slice` semantics: the start is clamped
    so that the window fits.  `y0`/`x0` are ints, or (B,) integer tensors
    on the device of a (B, H8, W8, C) `blocks`, one offset per image."""
    H8, W8 = blocks.shape[-3], blocks.shape[-2]
    if not (torch.is_tensor(y0) or torch.is_tensor(x0)):
        y0 = min(max(int(y0), 0), H8 - h8)
        x0 = min(max(int(x0), 0), W8 - w8)
        return blocks[..., y0:y0 + h8, x0:x0 + w8, :]
    if blocks.dim() != 4:
        raise ValueError(f"per-image offsets need (B, H8, W8, C) blocks, got {tuple(blocks.shape)}")
    dev = blocks.device
    y0 = _draws.param(y0, dev, torch.long).clamp(0, H8 - h8)
    x0 = _draws.param(x0, dev, torch.long).clamp(0, W8 - w8)
    rows = y0[:, None] + torch.arange(h8, device=dev)
    cols = x0[:, None] + torch.arange(w8, device=dev)
    b = torch.arange(blocks.shape[0], device=dev)
    return blocks[b[:, None, None], rows[:, :, None], cols[:, None, :]]


@functools.lru_cache(maxsize=None)
def _downscale_mats():
    """Constant 8x8 matrices (M0, M1) for exact DCT-domain 2x downscale.

    An 8x8 coefficient block B decodes to pixels P = Cᵀ B C (C = orthonormal
    DCT-II).  Average-pooling a 16x16 tile of four blocks down to 8x8 is
    D = A P_tile Aᵀ with A the (8, 16) 2-tap averaging matrix; re-encoding
    gives  C D Cᵀ = Σ_{i,j} (C A_i Cᵀ) B_ij (C A_j Cᵀ)ᵀ  with A_i the
    left/right 8x8 halves of A.  Level-shift invariant, so it applies
    directly to JPEG's shifted coefficients."""
    k = np.arange(8)
    C = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / 16) / 2.0
    C[0] /= np.sqrt(2.0)  # orthonormal: C @ C.T == I
    A = np.zeros((8, 16))
    A[k, 2 * k] = 0.5
    A[k, 2 * k + 1] = 0.5
    M0 = C @ A[:, :8] @ C.T
    M1 = C @ A[:, 8:] @ C.T
    return (
        np.ascontiguousarray(M0, np.float32),
        np.ascontiguousarray(M1, np.float32),
    )


@functools.lru_cache(maxsize=None)
def _downscale_tensors(device: torch.device, dtype: torch.dtype):
    return tuple(torch.as_tensor(m, dtype=dtype, device=device) for m in _downscale_mats())


def dct_downscale_2x(blocks: torch.Tensor) -> torch.Tensor:
    """Exact 2x average-pool downscale in coefficient space.

    (..., H8, W8, k*64) -> (..., H8/2, W8/2, k*64): each output block is a
    fixed linear combination of its four source blocks (`_downscale_mats`),
    summed in the JAX function's order."""
    *lead, H8, W8, Ch = blocks.shape
    if H8 % 2 or W8 % 2 or Ch % 64:
        raise ValueError(f"bad shape for 2x downscale: {tuple(blocks.shape)}")
    g = Ch // 64
    M = _downscale_tensors(blocks.device, blocks.dtype)
    x = blocks.reshape(*lead, H8 // 2, 2, W8 // 2, 2, g, 8, 8)
    out = None
    for i in (0, 1):
        for j in (0, 1):
            term = torch.einsum("au,...uv,bv->...ab", M[i], x.select(-6, i).select(-4, j), M[j])
            out = term if out is None else out + term
    return out.reshape(*lead, H8 // 2, W8 // 2, Ch)


def _trailing(p, ndim: int, device) -> torch.Tensor:
    """A scalar or per-image parameter as float32, padded with trailing
    unit axes to `ndim` dimensions."""
    p = _draws.param(p, device)
    while p.dim() < ndim:
        p = p[..., None]
    return p


def dct_brightness_contrast(
    blocks: torch.Tensor,
    brightness=0.0,
    contrast=1.0,
    is_luma: bool = True,
) -> torch.Tensor:
    """Pixel-space `p' = a*(p - 128) + 128 + b`, exact in DCT space: every
    coefficient scales by `a` and the luma DC term also absorbs `8*b`.
    Chroma planes are centred already, so brightness leaves them untouched
    (is_luma=False).  `brightness`/`contrast` are scalars or per-image (B,)
    tensors.  (Each is padded on its own: the JAX function pads both by the
    contrast's rank, which is the same whenever both have one rank.)"""
    blocks = blocks.float()
    a = _trailing(contrast, blocks.dim(), blocks.device)
    b = _trailing(brightness, blocks.dim(), blocks.device)
    out = blocks * a
    if is_luma:
        c = blocks.shape[-1]
        dc_mask = (torch.arange(c, device=blocks.device) % 64) == 0
        out = out + torch.where(dc_mask, 8.0 * b, 0.0)
    return out


def dct_chroma_hue_saturation(cbcr: torch.Tensor, hue_rad, sat) -> torch.Tensor:
    """Hue rotation + saturation scaling directly on stacked (Cb|Cr)
    coefficients: [cb'; cr'] = s·R(θ)·[cb; cr], exact per coefficient
    because both are linear pixel-space maps.  `hue_rad`/`sat` are scalars
    or per-image (B,) tensors."""
    cbcr = cbcr.float()
    h = _trailing(hue_rad, cbcr.dim(), cbcr.device)
    s = _trailing(sat, cbcr.dim(), cbcr.device)
    cb, cr = cbcr[..., :64], cbcr[..., 64:]
    c, sn = torch.cos(h), torch.sin(h)
    cb_out = s * (c * cb - sn * cr)
    cr_out = s * (sn * cb + c * cr)
    return torch.cat([cb_out, cr_out], dim=-1)


def sample_photometric(batch_size: int, generator=None, brightness_range=32.0,
                       contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                       hue_max_deg=36.0, prob=0.5) -> dict:
    """Host draws of `dct_random_photometric` (the JAX op's distributions):
    brightness U(±range) applied with p, contrast and saturation U(range)
    with p (else 1), hue U(±hue_max) radians with p (else 0); (B,) each."""
    shape = (batch_size,)
    bright = (_draws.uniform(generator, shape, -brightness_range, brightness_range)
              * _draws.bernoulli(generator, prob, shape))
    contrast = torch.where(_draws.bernoulli(generator, prob, shape),
                           _draws.uniform(generator, shape, *contrast_range), 1.0)
    sat = torch.where(_draws.bernoulli(generator, prob, shape),
                      _draws.uniform(generator, shape, *saturation_range), 1.0)
    hue_max = hue_max_deg * math.pi / 180.0
    hue = torch.where(_draws.bernoulli(generator, prob, shape),
                      _draws.uniform(generator, shape, -hue_max, hue_max), 0.0)
    return {"bright": bright, "contrast": contrast, "sat": sat, "hue": hue}


def dct_random_photometric_apply(y, cbcr, draws: dict):
    """Brightness + contrast on luma, contrast + hue + saturation on chroma,
    with the per-image parameters of `sample_photometric`."""
    y = dct_brightness_contrast(y, draws["bright"], draws["contrast"], is_luma=True)
    cbcr = dct_brightness_contrast(cbcr, 0.0, draws["contrast"], is_luma=False)
    cbcr = dct_chroma_hue_saturation(cbcr, draws["hue"], draws["sat"])
    return y, cbcr


def dct_random_photometric(y, cbcr, generator=None, **kwargs):
    """Batched random brightness + contrast + saturation + hue, all in DCT
    space with per-image parameters drawn on the host from `generator`."""
    draws = _draws.to_device(sample_photometric(y.shape[0], generator, **kwargs), y.device)
    return dct_random_photometric_apply(y, cbcr, draws)


# ---------------------------------------------------------------------------
# classification: crop + flip, random-resized crop, trainer augment_fns
# ---------------------------------------------------------------------------

def flip_where(flip: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Flip the images of a (B, H8, W8, C) map where `flip` (B,) is True
    (one flip kernel launch for the whole map on the card)."""
    return torch.where(flip[:, None, None, None], dct_flip_horizontal(blocks.contiguous()), blocks)


def sample_crop_flip(batch_size: int, h8: int, w8: int, generator=None,
                     out_y_blocks: int = 28) -> dict:
    """A uniform 16-px-aligned crop offset (in chroma blocks) and a fair
    flip per image."""
    shape = (batch_size,)
    return {
        "y0": _draws.randint(generator, shape, 0, (h8 - out_y_blocks) // 2 + 1),
        "x0": _draws.randint(generator, shape, 0, (w8 - out_y_blocks) // 2 + 1),
        "flip": _draws.bernoulli(generator, 0.5, shape),
    }


def crop_flip_maps(y, cbcr, y0c, x0c, flip, out_y_blocks: int):
    """Crop every image's (y, cbcr) at its chroma-block offset (y0c, x0c),
    so luma and 4:2:0 chroma stay block-aligned, and flip where `flip`."""
    out_cb = out_y_blocks // 2
    yc = flip_where(flip, dct_crop_blocks(y, 2 * y0c, 2 * x0c, out_y_blocks, out_y_blocks))
    cc = flip_where(flip, dct_crop_blocks(cbcr, y0c, x0c, out_cb, out_cb))
    return yc, cc


def dct_random_crop_flip_apply(y, cbcr, draws: dict, out_y_blocks: int = 28,
                               out_cbcr_blocks: int = 14):
    """Batched random 16-px-aligned crop + horizontal flip of oversized maps
    y (B, H8, W8, 64), cbcr (B, H8/2, W8/2, 128) with the draws of
    `sample_crop_flip`; returns (B, out_y, out_y, 64), (B, out_c, out_c, 128)."""
    if out_y_blocks != 2 * out_cbcr_blocks:
        raise ValueError("4:2:0 layout requires out_y_blocks = 2*out_cbcr_blocks")
    return crop_flip_maps(y, cbcr, draws["y0"], draws["x0"], draws["flip"], out_y_blocks)


def dct_random_crop_flip(y, cbcr, generator=None, out_y_blocks: int = 28,
                         out_cbcr_blocks: int = 14):
    """`dct_random_crop_flip_apply` with draws from `generator`."""
    draws = _draws.to_device(
        sample_crop_flip(y.shape[0], y.shape[1], y.shape[2], generator, out_y_blocks), y.device)
    return dct_random_crop_flip_apply(y, cbcr, draws, out_y_blocks, out_cbcr_blocks)


def sample_classification_crop(batch_size: int, h8: int, w8: int, generator=None,
                               scale_range=(0.35, 1.0), ar_range=(0.75, 1.333),
                               identity_prob: float = 0.2) -> dict:
    """Draws of the v2 random-resized crop of an (h8, w8)-block source: per
    image an area share U(scale_range) and an aspect ratio exp(U(log
    ar_range)) give the crop's height and width (capped at the frame; the
    full frame with p=identity_prob), U(0, 1) shares of the room left give
    its corner, and a fair flip; (B,) each, in source pixels."""
    shape = (batch_size,)
    H, W = float(h8 * 8), float(w8 * 8)
    log_lo, log_hi = math.log(ar_range[0]), math.log(ar_range[1])
    area = _draws.uniform(generator, shape, *scale_range)
    ar = torch.exp(_draws.uniform(generator, shape, log_lo, log_hi))
    ident = _draws.bernoulli(generator, identity_prob, shape)
    ch = torch.where(ident, H, torch.clamp_max(torch.sqrt(area / ar) * H, H))
    cw = torch.where(ident, W, torch.clamp_max(torch.sqrt(area * ar) * W, W))
    return {
        "y0": _draws.uniform(generator, shape) * (H - ch),
        "x0": _draws.uniform(generator, shape) * (W - cw),
        "ch": ch,
        "cw": cw,
        "flip": _draws.bernoulli(generator, 0.5, shape),
    }


def dct_classification_crop_apply(y, cbcr, draws: dict, out_y_blocks: int = 28):
    """Continuous random-resized crop + flip in coefficient space: each
    image's crop [y0, y0 + ch) x [x0, x0 + cw) (source pixels; chroma at
    half the coordinates) resized bilinearly to out_y_blocks by
    `dct_crop_resize`, then flipped where `flip`."""
    out_px = out_y_blocks * 8
    y0, x0, ch, cw, flip = (draws[k] for k in ("y0", "x0", "ch", "cw", "flip"))
    y_out = dct_crop_resize(y, y0, x0, ch, cw, out_px, out_px, interp_mode=INTERP_BILINEAR)
    c_out = dct_crop_resize(cbcr, y0 / 2.0, x0 / 2.0, ch / 2.0, cw / 2.0, out_px // 2,
                            out_px // 2, interp_mode=INTERP_BILINEAR)
    return flip_where(flip, y_out), flip_where(flip, c_out)


@dataclasses.dataclass(frozen=True)
class DeviceAugment:
    """A trainer `augment_fn`: `(batch, generator) -> batch`.

    `sample(batch_size, h8, w8, generator)` draws on the host, `apply(batch,
    draws)` runs the chain on the batch's device.  A call moves the batch's
    "inputs" to `device` (a CPU batch does not quietly run the chain on the
    CPU), copies the draws there at once and applies.  Inside
    `parallel.data_parallel(mesh)` with n_data > 1 data ranks the batch is
    the rank's rows: the draws are made for the global batch of n_data times
    its rows and the rank keeps its data index's, so the ranks draw what one
    process draws (both ranks of a model group the same)."""

    sample: Callable[..., dict]
    apply: Callable[[dict, dict], dict]
    device: torch.device

    def to_device(self, batch: dict) -> dict:
        out = dict(batch)
        out["inputs"] = tuple(torch.as_tensor(a, device=self.device) for a in batch["inputs"])
        return out

    def __call__(self, batch: dict, generator: torch.Generator | None = None) -> dict:
        batch = self.to_device(batch)
        b, h8, w8 = batch["inputs"][0].shape[:3]
        mesh = active_mesh()
        if mesh is None:
            draws = self.sample(b, h8, w8, generator)
        else:
            draws = shard_batch(self.sample(b * mesh.n_data, h8, w8, generator), mesh)
        return self.apply(batch, _draws.to_device(draws, self.device))


def _with_inputs(batch: dict, y, cbcr) -> dict:
    out = dict(batch)
    out["inputs"] = (y, cbcr)
    return out


def make_dct_classification_augment_v2(out_y_blocks: int = 28, scale_range=(0.35, 1.0),
                                       ar_range=(0.75, 1.333), identity_prob: float = 0.2,
                                       photometric: bool = True, device=None) -> DeviceAugment:
    """Continuous random-resized-crop classification augment on `device`
    (None means CUDA and raises without a card): per image a crop of area
    share U(scale_range) and aspect ratio exp(U(log ar_range)) of the source
    frame at a random position (the full frame with p=identity_prob),
    resized to out_y_blocks, a random hflip, then the DCT photometric op.
    Inputs (int16-shipped or float) are cast to float32 on the device."""
    dev = resolve_device(device)

    def sample(b, h8, w8, generator):
        draws = {"crop": sample_classification_crop(b, h8, w8, generator, scale_range, ar_range,
                                                    identity_prob)}
        if photometric:
            draws["photometric"] = sample_photometric(b, generator)
        return draws

    def apply(batch, draws):
        y, cbcr = (a.float() for a in batch["inputs"])
        y, cbcr = dct_classification_crop_apply(y, cbcr, draws["crop"], out_y_blocks)
        if photometric:
            y, cbcr = dct_random_photometric_apply(y, cbcr, draws["photometric"])
        return _with_inputs(batch, y, cbcr)

    return DeviceAugment(sample, apply, dev)


def make_dct_classification_augment(out_y_blocks: int = 28, photometric: bool = True,
                                    device=None) -> DeviceAugment:
    """Batched random 16-px-aligned crop + hflip (+ DCT photometric) of
    oversized maps (e.g. a 256-px packed corpus -> 224-px crops) on
    `device` (None means CUDA and raises without a card); inputs cast to
    float32 there."""
    dev = resolve_device(device)

    def sample(b, h8, w8, generator):
        draws = {"crop": sample_crop_flip(b, h8, w8, generator, out_y_blocks)}
        if photometric:
            draws["photometric"] = sample_photometric(b, generator)
        return draws

    def apply(batch, draws):
        y, cbcr = (a.float() for a in batch["inputs"])
        y, cbcr = dct_random_crop_flip_apply(y, cbcr, draws["crop"], out_y_blocks,
                                             out_y_blocks // 2)
        if photometric:
            y, cbcr = dct_random_photometric_apply(y, cbcr, draws["photometric"])
        return _with_inputs(batch, y, cbcr)

    return DeviceAugment(sample, apply, dev)
