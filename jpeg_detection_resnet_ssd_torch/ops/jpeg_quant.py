"""JPEG quantization-grid snapping for device-side augmentation chains.

Counterpart of the JAX package's `ops/jpeg_quant.py` (the port keeps its
own copy of the NumPy tables).  The reference's host pipeline re-encodes
every augmented view to JPEG at quality 75, so every coefficient it trains
on lies on that quality's quantization grid; the DCT-domain chain emits
continuous values.  `jpeg_requantize` snaps each coefficient to the nearest
multiple of its quantizer step, per frequency and per component, with the
tables libjpeg derives for the quality (`jcparam.c:jpeg_quality_scaling` /
`jpeg_add_quant_table`, force_baseline): Annex K base tables scaled by
``5000/q`` (q < 50) or ``200 - 2q`` (q >= 50), rounded with +50/100 and
clamped to [1, 255].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ITU-T T.81 Annex K quantization tables, NATURAL (row-major) order.
ANNEX_K_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

ANNEX_K_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def quality_scaling(quality: int) -> int:
    """libjpeg `jpeg_quality_scaling`: quality 1-100 -> percent scale."""
    quality = int(min(max(quality, 1), 100))
    if quality < 50:
        return 5000 // quality
    return 200 - quality * 2


def quant_tables(quality: int = 75) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) quantizer steps, natural order, for a libjpeg/PIL
    baseline encode at `quality` (force_baseline clamp to [1, 255])."""
    scale = quality_scaling(quality)

    def scale_table(base):
        t = (base * scale + 50) // 100
        return np.clip(t, 1, 255).astype(np.int32)

    return scale_table(ANNEX_K_LUMA), scale_table(ANNEX_K_CHROMA)


@functools.lru_cache(maxsize=None)
def _steps(quality: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 (64,) luma and (128,) stacked-chroma steps on `device`
    (Cb and Cr share the chroma table)."""
    qy, qc = quant_tables(quality)
    return (torch.as_tensor(qy, dtype=torch.float32, device=device),
            torch.as_tensor(np.concatenate([qc, qc]), dtype=torch.float32, device=device))


def jpeg_requantize(y: torch.Tensor, cbcr: torch.Tensor, quality: int = 75):
    """Snap dequantized coefficients to the quality-`quality` JPEG grid.

    y: (..., 64) luma coefficients; cbcr: (..., 128) chroma (Cb ++ Cr), both
    natural order and dequantized.  Each coefficient becomes the nearest
    multiple of its step (ties to even, as `jnp.round`)."""
    qy, qcc = _steps(quality, y.device)
    return torch.round(y / qy) * qy, torch.round(cbcr / qcc) * qcc
