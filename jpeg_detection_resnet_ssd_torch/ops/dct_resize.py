"""Continuous crop + resize in DCT coefficient space (the v3 augment core).

Counterpart of the JAX package's `ops/dct_resize.py`.  Resizing the
DECODED image is a linear map P_out = W_y P W_xᵀ; in block-DCT space that is

    O[I,J] = Σ_{K,L} (C W_y[I,K] Cᵀ) B[K,L] (C W_x[J,L] Cᵀ)ᵀ

with C the orthonormal 8x8 DCT-II matrix and W[I,K] the (8, 8) sub-blocks of
the interpolation matrix.  W is built per image from four scalars (crop
y0/x0/h/w, continuous, possibly beyond the source); out-of-bounds source
pixels contribute a constant background through the residual row mass
(1 - Σw).  The JAX package vmaps one image; here every function takes
leading batch axes, so a (B,) batch of crops is one set of batched
`torch.einsum` products (cuBLAS), with no loop over images.
"""

from __future__ import annotations

import functools
import math

import torch

from jpeg_detection_resnet_ssd_torch.ops._draws import param
from jpeg_detection_resnet_ssd_torch.ops.block_dct import basis, dct2_8x8

# Interpolation modes, mirroring the reference's `ResizeRandomInterp`
# pool of 5 random cv2 modes:
INTERP_BILINEAR = 0
INTERP_NEAREST = 1
INTERP_CUBIC = 2    # Catmull-Rom a=-0.75 (cv2.INTER_CUBIC's kernel)
INTERP_AREA = 3     # fractional overlap of the output span with each source cell
INTERP_LANCZOS4 = 4  # 8-tap windowed sinc, row-normalized like cv2's tables
N_INTERP_MODES = 5

_CUBIC_OFFSETS = (-1.0, 0.0, 1.0, 2.0)
_LANCZOS_OFFSETS = tuple(float(k) for k in range(-3, 5))


def _cubic_kernel(x, a=-0.75):
    """cv2.INTER_CUBIC weight function (BiCubic, alpha=-0.75)."""
    ax = torch.abs(x)
    w1 = ((a + 2.0) * ax - (a + 3.0)) * ax * ax + 1.0
    w2 = ((a * ax - 5.0 * a) * ax + 8.0 * a) * ax - 4.0 * a
    return torch.where(ax <= 1.0, w1, torch.where(ax < 2.0, w2, 0.0))


def _lanczos_kernel(x, taps=4):
    """Lanczos-a windowed sinc (a=4 for cv2.INTER_LANCZOS4)."""
    small = torch.abs(x) < 1e-7
    pix = math.pi * x
    safe = torch.where(small, 1.0, pix)
    sinc = torch.where(small, 1.0, torch.sin(safe) / safe)
    safe_a = torch.where(small, 1.0, pix / taps)
    sinc_a = torch.where(small, 1.0, torch.sin(safe_a) / safe_a)
    return torch.where(torch.abs(x) < taps, sinc * sinc_a, 0.0)


def _device_of(*args) -> torch.device:
    for a in args:
        if torch.is_tensor(a):
            return a.device
    return torch.device("cpu")


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as XLA compiles it (it contracts
    a multiply-add into a fused one).  Pixel coordinates reach 10^3 here,
    where a second rounding moves a sample by up to 6e-5 px and its weights
    by up to 1e-5.  Emulated in float64, where the float32 product is exact."""
    return (a.double() * b.double() + c.double()).float()


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A small float32 constant on `device`, copied there once."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def interp_matrix(src_px: int, dst_px: int, start, length, mode, clamp=False):
    """Interpolation matrices W (..., dst_px, src_px) for resampling the
    source interval [start, start + length) to dst_px output pixels, plus
    the per-output residual mass (..., dst_px) assigned to out-of-bounds
    background.  The leading axes are the broadcast shape of `start`,
    `length`, `clamp` and `mode` (scalars or tensors: one crop per image).

    Half-pixel-centre convention (cv2): output pixel o samples source
    coordinate start + (o + 0.5) * length / dst_px - 0.5.  Source samples
    outside [0, src_px) contribute zero weight and their mass lands in the
    residual.  `mode` (an INTERP_* constant per crop) selects the kernel.
    `clamp` applies cv2's border-replicate convention for an in-bounds
    crop: bilinear and nearest clip the sample coordinate, cubic and
    lanczos clip only the tap indices, area clips the span.

    The tap kernels (bilinear, nearest, cubic, lanczos) are written as up to
    8 (index, weight) taps per output pixel, the crop's own kernel chosen
    per crop, and added into W in tap order (the JAX function's order); the
    area kernel is dense.
    """
    dev = _device_of(start, length, clamp, mode)
    start, length, clamp_t, mode = torch.broadcast_tensors(
        param(start, dev), param(length, dev), param(clamp, dev, torch.bool),
        param(mode, dev, torch.long),
    )
    start, length = start[..., None], length[..., None]
    clamp_t, mode = clamp_t[..., None], mode[..., None]
    hi = float(src_px - 1)

    o = torch.arange(dst_px, dtype=torch.float32, device=dev)
    step = length / dst_px
    s_raw = fma(o + 0.5, step, start) - 0.5  # (..., dst)
    s_lin = torch.where(clamp_t, torch.clamp(s_raw, 0.0, hi), s_raw)
    i0_lin = torch.floor(s_lin)
    frac_lin = s_lin - i0_lin
    i0_raw = torch.floor(s_raw)
    frac_raw = s_raw - i0_raw

    def taps(i0, offsets, weights):
        """(..., dst, 8) tap indices and weights, padded with weight 0."""
        off = _constant(offsets + (0.0,) * (8 - len(offsets)), dev)
        w = torch.nn.functional.pad(weights, (0, 8 - weights.shape[-1]))
        return i0[..., None] + off, w

    # (index, weight) taps of each tap kernel, (..., dst, 8)
    bl = taps(i0_lin, (0.0, 1.0), torch.stack([1.0 - frac_lin, frac_lin], -1))
    nn = taps(torch.round(s_lin), (0.0,), torch.ones_like(s_lin)[..., None])
    cu = taps(i0_raw, _CUBIC_OFFSETS,
              _cubic_kernel(frac_raw[..., None] - _constant(_CUBIC_OFFSETS, dev)))
    lz_w = _lanczos_kernel(frac_raw[..., None] - _constant(_LANCZOS_OFFSETS, dev))
    lz = taps(i0_raw, _LANCZOS_OFFSETS, lz_w / lz_w.sum(-1, keepdim=True))

    idx, w = bl
    for kind, (k_idx, k_w) in ((INTERP_NEAREST, nn), (INTERP_CUBIC, cu), (INTERP_LANCZOS4, lz)):
        pick = (mode == kind)[..., None]
        idx, w = torch.where(pick, k_idx, idx), torch.where(pick, k_w, w)
    # With clamp, out-of-range taps fold onto the edge pixels; without, they
    # carry no weight (their mass is the residual).
    idx = torch.where(clamp_t[..., None], torch.clamp(idx, 0.0, hi), idx)
    inside = (idx >= 0.0) & (idx <= hi)
    W_taps = torch.zeros(*s_raw.shape, src_px, dtype=torch.float32, device=dev)
    W_taps.scatter_add_(-1, torch.clamp(idx, 0.0, hi).long(), torch.where(inside, w, 0.0))

    # area: fractional overlap of the source span [b, b+step) with each
    # source pixel cell [i, i+1), normalized by the span
    src = torch.arange(src_px, dtype=torch.float32, device=dev)
    b = fma(o, step, start)
    e = b + step
    b_eff = torch.where(clamp_t, torch.clamp(b, 0.0, float(src_px)), b)
    e_eff = torch.where(clamp_t, torch.clamp(e, 0.0, float(src_px)), e)
    cover = torch.clamp(
        torch.minimum(e_eff[..., None], src + 1.0) - torch.maximum(b_eff[..., None], src),
        min=0.0,
    )
    W_ar = cover / torch.clamp(e_eff - b_eff, min=1e-12)[..., None]

    W = torch.where((mode == INTERP_AREA)[..., None], W_ar, W_taps)
    residual = 1.0 - W.sum(-1)
    return W, residual


def _block_mix(W: torch.Tensor) -> torch.Tensor:
    """(..., dst_px, src_px) pixel matrix -> (..., D8, K8, 8, 8) block-DCT
    mixing tensor G[I, K] = C @ W[8I:8I+8, 8K:8K+8] @ C.T."""
    c = basis(W.device)
    d8, s8 = W.shape[-2] // 8, W.shape[-1] // 8
    wb = W.reshape(*W.shape[:-2], d8, 8, s8, 8)
    return torch.einsum("au,...IuKv,bv->...IKab", c, wb, c)


def dct_resample(blocks: torch.Tensor, Wy: torch.Tensor, Wx: torch.Tensor) -> torch.Tensor:
    """Apply a pixel-space linear resample to a coefficient tensor.

    blocks: (..., H8, W8, k*64); Wy: (..., out_h_px, H8*8); Wx: (...,
    out_w_px, W8*8).  Returns (..., out_h_px/8, out_w_px/8, k*64), equal to
    dct(Wy @ idct(blocks) @ Wx.T) per channel group."""
    *lead, H8, W8, Ch = blocks.shape
    g = Ch // 64
    Gy = _block_mix(Wy)  # (..., O, K, 8, 8)
    Gx = _block_mix(Wx)  # (..., P, L, 8, 8)
    B = blocks.float().reshape(*lead, H8, W8, g, 8, 8)
    T = torch.einsum("...OKab,...KLgbc->...OLgac", Gy, B)
    out = torch.einsum("...OLgac,...PLdc->...OPgad", T, Gx)
    return out.reshape(*out.shape[:-5], out.shape[-5], out.shape[-4], g * 64)


def dct_crop_resize(
    blocks: torch.Tensor,
    y0,
    x0,
    crop_h,
    crop_w,
    out_h_px: int,
    out_w_px: int,
    background=0.0,
    *,
    interp_mode,
) -> torch.Tensor:
    """Crop [y0, y0+crop_h) x [x0, x0+crop_w) (continuous pixels, may extend
    beyond the source) and resize to (out_h_px, out_w_px), all in
    coefficient space.  `background` is the fill PIXEL value minus 128, a
    float or a tuple of one per channel group (e.g. (Cb, Cr) for stacked
    chroma): out-of-bounds regions decode to that constant.  `interp_mode`
    (an INTERP_* constant per crop) selects the resampling kernel.

    blocks: (..., H8, W8, k*64), the crop parameters scalars or tensors of
    the leading shape.  Returns (..., out_h_px/8, out_w_px/8, k*64)."""
    *lead, H8, W8, Ch = blocks.shape
    g = Ch // 64
    dev = blocks.device
    y0t, x0t = param(y0, dev), param(x0, dev)
    crop_h, crop_w = param(crop_h, dev), param(crop_w, dev)
    # cv2 parity: a crop fully inside the source (per axis) resizes with
    # border replication; a crop leaving the source blends into the
    # background canvas at the image edge (see interp_matrix)
    clamp_y = (y0t >= 0.0) & (y0t + crop_h <= H8 * 8)
    clamp_x = (x0t >= 0.0) & (x0t + crop_w <= W8 * 8)
    interp_mode = param(interp_mode, dev, torch.long)
    Wy, ry = interp_matrix(H8 * 8, out_h_px, y0t, crop_h, interp_mode, clamp=clamp_y)
    Wx, rx = interp_matrix(W8 * 8, out_w_px, x0t, crop_w, interp_mode, clamp=clamp_x)
    Wy = Wy.expand(*lead, *Wy.shape[-2:])
    Wx = Wx.expand(*lead, *Wx.shape[-2:])
    out = dct_resample(blocks, Wy, Wx)
    if torch.is_tensor(background):
        bg = background.to(dev, torch.float32).broadcast_to((g,))
    else:
        values = tuple(background) if isinstance(background, (list, tuple)) else (background,)
        bg = _constant(tuple(float(v) for v in values), dev).broadcast_to((g,))

    # residual pixel mass not covered by in-bounds samples gets the
    # background value: mass[o_y, o_x] = 1 - (1-ry)(1-rx); nonzero only where
    # the crop leaves the source, computed unconditionally (no branch)
    mass = 1.0 - (1.0 - ry)[..., :, None] * (1.0 - rx)[..., None, :]
    mass = mass.expand(*lead, *mass.shape[-2:])
    rh8, rw8 = out_h_px // 8, out_w_px // 8
    unit = dct2_8x8(mass.reshape(*lead, rh8, 8, rw8, 8).transpose(-3, -2))  # (..., rh8, rw8, 64)
    out = out.reshape(*lead, rh8, rw8, g, 64) + bg[:, None] * unit[..., None, :]
    return out.reshape(*lead, rh8, rw8, Ch)
