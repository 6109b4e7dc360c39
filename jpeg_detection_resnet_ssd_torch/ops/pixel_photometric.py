"""Exact pixel-space photometric augmentation on the device, between DCT
codecs.

Counterpart of the JAX package's `ops/pixel_photometric.py`: reconstruct
pixels from the coefficients (8x8 IDCT einsums), apply the reference
photometric chain with cv2's semantics (per-op [0, 255] clips, brightness
shift, multiplicative contrast about 127.5, hexagonal HSV saturation/hue
walk, contrast early or late 50/50), then re-encode (forward DCT einsums).
Every function takes a batch of per-image parameters.

The 4:2:0 chroma resample pair is a triangle 2x upsample with half-pixel
centres and clamped edges (`F.interpolate` bilinear, `align_corners=False`,
the function of `jax.image.resize(..., "linear")` for a 2x upsample) and a
2x2 box downsample.

The random op is split into a host sampler (`sample_pixel_photometric`) and
the deterministic `dct_pixel_photometric_apply`; see `ops._draws`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jpeg_detection_resnet_ssd_torch.ops import _draws
from jpeg_detection_resnet_ssd_torch.ops.block_dct import dct2_8x8, idct2_8x8


# ---------------------------------------------------------------------------
# block <-> plane
# ---------------------------------------------------------------------------

def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(B, hb, wb, 64) natural-order coefficients -> (B, hb*8, wb*8) pixel
    plane (level-shifted: add 128 for unsigned pixels)."""
    px = idct2_8x8(blocks)  # (B, hb, wb, 8, 8)
    b, hb, wb = px.shape[:3]
    return px.permute(0, 1, 3, 2, 4).reshape(b, hb * 8, wb * 8)


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(B, H, W) level-shifted pixel plane -> (B, H/8, W/8, 64)."""
    b, h, w = plane.shape
    px = plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    return dct2_8x8(px)


# ---------------------------------------------------------------------------
# colour conversions (JFIF full-range BT.601; cv2 HSV conventions)
# ---------------------------------------------------------------------------

def ycbcr_to_rgb(y, cb, cr):
    """Full-range JFIF YCbCr planes (pixel domain, [0,255]) -> (..., 3) RGB
    (unclipped — callers clip)."""
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)


def rgb_to_ycbcr(rgb):
    """(..., 3) RGB [0,255] -> (y, cb, cr) full-range JFIF planes."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def rgb_to_hsv(rgb):
    """(..., 3) RGB [0,255] -> (h_deg [0,360), s [0,255], v [0,255]) —
    continuous version of cv2's 8-bit convention (whose H is degrees/2)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    m = torch.minimum(torch.minimum(r, g), b)
    c = v - m
    safe_c = torch.where(c > 0, c, 1.0)
    h6 = torch.where(
        v == r,
        torch.remainder((g - b) / safe_c, 6.0),
        torch.where(v == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0),
    )
    h = torch.where(c > 0, 60.0 * h6, 0.0)
    s = torch.where(v > 0, 255.0 * c / torch.where(v > 0, v, 1.0), 0.0)
    return h, s, v


def _select(conds, values, default):
    """`jnp.select`: the value of the first true condition, else default."""
    out = default
    for cond, value in reversed(list(zip(conds, values))):
        out = torch.where(cond, value, out)
    return out


def hsv_to_rgb(h, s, v):
    """Inverse of `rgb_to_hsv` (hexagonal walk), returns (..., 3) RGB."""
    c = v * s / 255.0
    hp = torch.remainder(h, 360.0) / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    i = torch.floor(hp).to(torch.int32) % 6
    z = torch.zeros_like(c)
    conds = [i == 0, i == 1, i == 2, i == 3, i == 4]
    r1 = _select(conds, [c, x, z, z, x], c)
    g1 = _select(conds, [x, c, c, x, z], z)
    b1 = _select(conds, [z, z, x, c, c], x)
    m = v - c
    return torch.stack([r1 + m, g1 + m, b1 + m], dim=-1)


# ---------------------------------------------------------------------------
# 4:2:0 chroma resample pair
# ---------------------------------------------------------------------------

def upsample2x(plane: torch.Tensor) -> torch.Tensor:
    """(B, h, w) -> (B, 2h, 2w) triangle-filter upsample with half-pixel
    centres — the interior weights (3/4, 1/4) match libjpeg's default
    "fancy" h2v2 upsampler; edges clamp."""
    b, h, w = plane.shape
    return F.interpolate(plane[:, None], size=(2 * h, 2 * w), mode="bilinear",
                         align_corners=False)[:, 0]


def downsample2x(plane: torch.Tensor) -> torch.Tensor:
    """(B, 2h, 2w) -> (B, h, w) 2x2 box average — libjpeg's default h2v2
    encoder downsample."""
    b, h, w = plane.shape
    return plane.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


# ---------------------------------------------------------------------------
# the photometric chain
# ---------------------------------------------------------------------------

def _per_image(p, ndim, device):
    p = _draws.param(p, device)
    while p.dim() < ndim:
        p = p[..., None]
    return p


def dct_pixel_photometric_apply(y, cbcr, bright, contrast, early, sat, hue_delta):
    """Apply the reference photometric chain with EXPLICIT per-image (B,)
    parameters: `bright` additive in [-32, 32]; `contrast` multiplicative
    about 127.5; `early` bool — contrast before (True) or after (False) the
    HSV ops; `sat` multiplicative on S; `hue_delta` in cv2 8-bit hue units
    (degrees/2, wraps at 180)."""
    dev = y.device
    y_plane = blocks_to_plane(y.float()) + 128.0
    cbcr = cbcr.float()
    cb = blocks_to_plane(cbcr[..., :64]) + 128.0
    cr = blocks_to_plane(cbcr[..., 64:]) + 128.0
    rgb = ycbcr_to_rgb(y_plane, upsample2x(cb), upsample2x(cr))
    rgb = torch.clamp(rgb, 0.0, 255.0)

    nd = rgb.dim()
    bright = _per_image(bright, nd, dev)
    contrast = _per_image(contrast, nd, dev)
    early = _per_image(early, nd, dev) > 0.5
    sat3 = _per_image(sat, nd - 1, dev)  # h/s/v planes have one dim less
    hue3 = _per_image(hue_delta, nd - 1, dev)
    c_early = torch.where(early, contrast, 1.0)
    c_late = torch.where(early, 1.0, contrast)

    rgb = torch.clamp(rgb + bright, 0.0, 255.0)
    rgb = torch.clamp(127.5 + c_early * (rgb - 127.5), 0.0, 255.0)
    h, s, v = rgb_to_hsv(rgb)
    s = torch.clamp(s * sat3, 0.0, 255.0)
    h = torch.remainder(h + 2.0 * hue3, 360.0)
    rgb = torch.clamp(hsv_to_rgb(h, s, v), 0.0, 255.0)
    rgb = torch.clamp(127.5 + c_late * (rgb - 127.5), 0.0, 255.0)

    y_out, cb_out, cr_out = rgb_to_ycbcr(rgb)
    y_blocks = plane_to_blocks(y_out - 128.0)
    cb_blocks = plane_to_blocks(downsample2x(cb_out) - 128.0)
    cr_blocks = plane_to_blocks(downsample2x(cr_out) - 128.0)
    return y_blocks, torch.cat([cb_blocks, cr_blocks], dim=-1)


def sample_pixel_photometric(batch_size: int, generator=None, brightness_range=32.0,
                             contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                             hue_max_delta=18.0, prob=0.5) -> dict:
    """Host draws of `dct_pixel_photometric` (the JAX op's distributions,
    after `SSDPhotometricDistortions`): brightness U(±32) with p, contrast
    U(0.5, 1.5) with p placed early or late 50/50, saturation U(0.5, 1.5)
    with p, hue U(±18) cv2 units with p; (B,) each, named as the
    parameters of `dct_pixel_photometric_apply`."""
    shape = (batch_size,)
    bright = (_draws.uniform(generator, shape, -brightness_range, brightness_range)
              * _draws.bernoulli(generator, prob, shape))
    contrast = torch.where(_draws.bernoulli(generator, prob, shape),
                           _draws.uniform(generator, shape, *contrast_range), 1.0)
    early = _draws.bernoulli(generator, 0.5, shape)
    sat = torch.where(_draws.bernoulli(generator, prob, shape),
                      _draws.uniform(generator, shape, *saturation_range), 1.0)
    hue = torch.where(_draws.bernoulli(generator, prob, shape),
                      _draws.uniform(generator, shape, -hue_max_delta, hue_max_delta), 0.0)
    return {"bright": bright, "contrast": contrast, "early": early, "sat": sat,
            "hue_delta": hue}


def dct_pixel_photometric(y, cbcr, generator=None, **kwargs):
    """Batched random photometric chain with exact reference semantics;
    drop-in alternative to `dct_random_photometric`, parameters drawn on the
    host from `generator`."""
    draws = _draws.to_device(sample_pixel_photometric(y.shape[0], generator, **kwargs), y.device)
    return dct_pixel_photometric_apply(y, cbcr, **draws)
