"""RGB array -> JPEG DCT coefficient tensors (the input transform).

Counterpart of the JAX package's `data/dct_convert.py`: the image is
re-encoded to JPEG in RAM with PIL and decoded to coefficients by the port's
`dctjpeg`, as the reference's generators do.  PIL is imported inside the
functions, so the package imports where PIL is not installed.
"""

from __future__ import annotations

import io

import numpy as np

from jpeg_detection_resnet_ssd_torch import dctjpeg


def _encode(image: np.ndarray, quality: int, subsampling: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(image, np.uint8)).save(
        buf, "jpeg", quality=quality, subsampling=subsampling
    )
    return buf.getvalue()


def rgb_to_dct_tensors(
    image: np.ndarray, quality: int = 75, subsampling: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> (dct_y, dct_cbcr) int32 block tensors.

    Default 4:2:0 subsampling, as PIL's default JPEG encoder:
    300x300 -> (38,38,64) + (19,19,128).
    """
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
