"""8x8 block DCT/IDCT as einsums (the JPEG transform, ITU-T T.81 Annex A).

Counterpart of the JAX package's `ops/block_dct.py`: (..., 64)
natural-order coefficient blocks <-> (..., 8, 8) level-shifted pixels, two
8x8 matrix products per block, batched over every block by `torch.einsum`
(cuBLAS on the card, as XLA ran them outside any Pallas kernel).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _basis() -> np.ndarray:
    """basis[u, x] = C(u)/2 * cos((2x+1) u pi / 16) — orthonormal rows."""
    x = np.arange(8)
    u = np.arange(8)
    b = 0.5 * np.cos((2 * x[None, :] + 1) * u[:, None] * np.pi / 16)
    b[0, :] *= 1 / np.sqrt(2)
    return b.astype(np.float32)


DCT_BASIS_8 = _basis()


@functools.lru_cache(maxsize=None)
def basis(device: torch.device) -> torch.Tensor:
    """`DCT_BASIS_8` as a float32 tensor on `device` (cached; never written)."""
    return torch.as_tensor(DCT_BASIS_8, device=device)


def idct2_8x8(blocks: torch.Tensor) -> torch.Tensor:
    """(..., 64) natural-order DCT coefficients -> (..., 8, 8) pixel residuals
    (add 128 for unsigned-pixel level shift), in float32."""
    c = basis(blocks.device)
    f = blocks.float().reshape(*blocks.shape[:-1], 8, 8)
    return torch.einsum("ux,...uv,vy->...xy", c, f, c)


def dct2_8x8(pixels: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) level-shifted pixels -> (..., 64) natural-order DCT."""
    c = basis(pixels.device)
    f = torch.einsum("ux,...xy,vy->...uv", c, pixels.float(), c)
    return f.reshape(*f.shape[:-2], 64)
