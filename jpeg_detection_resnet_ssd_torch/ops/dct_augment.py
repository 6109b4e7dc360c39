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

The random photometric op is split into a host sampler
(`sample_photometric`) and a deterministic apply (`dct_random_photometric_
apply`); see `ops._draws`.  The classification augments of the JAX module
(`dct_random_crop_flip`, `make_dct_classification_augment(_v2)`) come with
the classification slice (ROADMAP A12).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.ops import _draws
from jpeg_detection_resnet_ssd_torch.ops.dct_flip import (  # noqa: F401  (re-exported)
    _COL_SIGNS,
    _signs_for,
    dct_flip_horizontal,
)

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
