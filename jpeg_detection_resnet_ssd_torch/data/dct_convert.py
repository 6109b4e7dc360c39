"""RGB array -> JPEG DCT coefficient tensors (the input transform).

Counterpart of the JAX package's `data/dct_convert.py`: the image is
re-encoded to JPEG in RAM with PIL and decoded to coefficients by the port's
`dctjpeg`, as the reference's generators do (`codec="libjpeg"`).  PIL is
imported inside the functions, so the package imports where PIL is not
installed.

`codec="numpy"` computes the same coefficients without PIL or libjpeg
(`rgb_to_dct_tensors_numpy`), for machines that have no libjpeg.  JPEG
encoding is lossless after quantization, so the coefficients the libjpeg
path returns are a deterministic function of the pixels and the quality;
the NumPy copy of libjpeg's forward path is bit-exact with it
(`tests/test_torch_numpy_codec.py`).  The `dct_image` layouts
(`rgb_to_dct_image`) stay libjpeg-only.
"""

from __future__ import annotations

import io

import numpy as np

from jpeg_detection_resnet_ssd_torch import dctjpeg
from jpeg_detection_resnet_ssd_torch.ops.jpeg_quant import quant_tables

CODECS = ("libjpeg", "numpy")


def check_codec(codec: str) -> str:
    if codec not in CODECS:
        raise ValueError(f"codec must be one of {CODECS}, got {codec!r}")
    return codec


def _encode(image: np.ndarray, quality: int, subsampling: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image, np.uint8)).save(
        buf, "jpeg", quality=quality, subsampling=subsampling
    )
    return buf.getvalue()


def rgb_to_dct_tensors(
    image: np.ndarray, quality: int = 75, subsampling: int = 2, codec: str = "libjpeg"
) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (dct_y, dct_cbcr) int32 block tensors.

    Default 4:2:0 subsampling, as PIL's default JPEG encoder:
    300x300 -> (38,38,64) + (19,19,128).  `codec="numpy"` gives the same
    arrays without PIL and libjpeg (4:2:0 only).
    """
    if check_codec(codec) == "numpy":
        return rgb_to_dct_tensors_numpy(image, quality, subsampling)
    y, cb, cr = dctjpeg.loads(_encode(image, quality, subsampling))
    return y, np.concatenate([cb, cr], axis=-1)


def split_cbcr(cbcr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(h, w, 128) -> ((h, w, 64), (h, w, 64)) for the deconv architectures."""
    return cbcr[..., :64], cbcr[..., 64:]


def rgb_to_dct_image(
    image: np.ndarray, crop_hw: tuple[int, int] | None = None, quality: int = 75
) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W, 3) spatial DCT-coefficient image.

    The jpegdecoder path: encode at 4:4:4 (subsampling=0), decode the
    level-2 layout, crop.
    """
    h, w = image.shape[:2]
    crop = crop_hw if crop_hw is not None else (h, w)
    return dctjpeg.decode_dct_image(_encode(image, quality, 0), crop_hw=crop)


# --- libjpeg's forward path in NumPy (the `numpy` codec) ---------------------

# jccolor.c: 16-bit fixed-point RGB -> YCbCr.
_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def rgb_to_ycc(image: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (Y, Cb, Cr) int64 samples, `jccolor.c`'s
    `rgb_ycc_convert` (tables summed, then shifted down)."""
    rgb = np.asarray(image, np.uint8).astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + _ONE_HALF) >> _SCALEBITS
    offset = _CBCR_OFFSET + _ONE_HALF - 1
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset) >> _SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset) >> _SCALEBITS
    return y, cb, cr


def _replicate_edges(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Pad a (h, w) plane to (rows, cols) by repeating its last row and
    column (`jcsample.c` `expand_right_edge`, `jcprepct.c`
    `expand_bottom_edge`)."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def downsample_h2v2(plane: np.ndarray, out_cols: int) -> np.ndarray:
    """`jcsample.c` `h2v2_downsample`: a (2r, >= 2 out_cols) plane ->
    (r, out_cols), each output the 2x2 box sum plus a bias alternating 1, 2
    along a row, shifted down by 2."""
    p = plane[:, : 2 * out_cols]
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.resize(np.array([1, 2], np.int64), out_cols)
    return (s + bias) >> 2


# jfdctint.c: the integer ("islow") forward DCT.
_CONST_BITS = 13
_PASS1_BITS = 2
_F0_298 = 2446
_F0_390 = 3196
_F0_541 = 4433
_F0_765 = 6270
_F0_899 = 7373
_F1_175 = 9633
_F1_501 = 12299
_F1_847 = 15137
_F1_961 = 16069
_F2_053 = 16819
_F2_562 = 20995
_F3_072 = 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One `jpeg_fdct_islow` pass over the last axis of (..., 8)."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    if first:
        out[..., 0] = (tmp10 + tmp11) << _PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << _PASS1_BITS
        shift = _CONST_BITS - _PASS1_BITS
    else:
        out[..., 0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        shift = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * _F0_541
    out[..., 2] = _descale(z1 + tmp13 * _F0_765, shift)
    out[..., 6] = _descale(z1 - tmp12 * _F1_847, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0_298, tmp5 * _F2_053, tmp6 * _F3_072, tmp7 * _F1_501
    z1, z2 = z1 * -_F0_899, z2 * -_F2_562
    z3, z4 = z3 * -_F1_961 + z5, z4 * -_F0_390 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(..., 8, 8) level-shifted int samples -> the islow DCT (scaled up by
    8, as `jpeg_fdct_islow` leaves it): rows first, then columns."""
    rows = _fdct_pass(np.asarray(blocks, np.int64), first=True)
    return np.swapaxes(_fdct_pass(np.swapaxes(rows, -1, -2), first=False), -1, -2)


def quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """`jcdctmgr.c` `quantize`: the DCT output over 8x the quantizer step,
    rounded half away from zero (sign restored after dividing |x|)."""
    q = np.asarray(table, np.int64) * 8
    return np.sign(coefs) * ((np.abs(coefs) + (q >> 1)) // q)


def _plane_coefficients(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(8 hb, 8 wb) samples -> (hb, wb, 64) dequantized int32 coefficients,
    natural order."""
    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) - 128
    coefs = fdct_islow(blocks).reshape(h // 8, w // 8, 64)
    return (quantize(coefs, table) * table).astype(np.int32)


def rgb_to_dct_tensors_numpy(
    image: np.ndarray, quality: int = 75, subsampling: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """What `rgb_to_dct_tensors(image, quality, subsampling)` returns, from
    NumPy alone: Y `(ceil(H/8), ceil(W/8), 64)` and CbCr `(ceil(H/16),
    ceil(W/16), 128)` dequantized int32 coefficients, natural order.

    libjpeg's baseline 4:2:0 encode (PIL's `quality=`): fixed-point colour
    conversion; luma edge-replicated to whole blocks; chroma edge-replicated
    to a multiple of 16 columns and an even row count, box-downsampled, then
    its last downsampled row replicated to whole blocks; islow DCT;
    quantization by the IJG tables scaled to `quality`; dequantization."""
    if subsampling != 2:
        raise ValueError(
            f"the numpy codec encodes 4:2:0 only (subsampling=2), got {subsampling}"
        )
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) RGB image, got shape {image.shape}")
    h, w = image.shape[:2]
    qy, qc = quant_tables(quality)
    y, cb, cr = rgb_to_ycc(image)
    hy, wy, hc, wc = -(-h // 8), -(-w // 8), -(-h // 16), -(-w // 16)
    dct_y = _plane_coefficients(_replicate_edges(y, hy * 8, wy * 8), qy)
    chroma = []
    for c in (cb, cr):
        full = _replicate_edges(c, h + h % 2, wc * 16)
        small = downsample_h2v2(full, wc * 8)
        chroma.append(_plane_coefficients(_replicate_edges(small, hc * 8, wc * 8), qc))
    return dct_y, np.concatenate(chroma, axis=-1)
