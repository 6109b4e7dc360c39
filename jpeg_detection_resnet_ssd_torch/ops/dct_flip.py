"""Coefficient-space horizontal flip: the CUDA kernel, its plain PyTorch
version and the launch counter.

Counterpart of the JAX package's `ops/dct_augment.py::_flip_h_pallas` (the
TPU kernel) and `_flip_h_jnp` (its plain function, which the device
augmentation chain runs).  A `(..., H8, W8, C)` block map, C a multiple of
64, has its block columns reversed and every odd column frequency negated:
exactly the coefficients of the horizontally flipped decoded image.

`impl` chooses, as `TargetEncoder.bipartite_impl` does: "auto" launches the
kernel on a CUDA tensor and runs the plain version on a CPU tensor,
"kernel" always launches the kernel (and raises on the CPU), "reference"
always runs the plain version.  The kernel and the plain version agree bit
for bit (the negation is exact).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from jpeg_detection_resnet_ssd_torch.ops import _build

# Kernel launches since the last reset; only `dct_flip_horizontal` adds to
# it, and only where it launches the kernel.
LAUNCHES = 0

IMPLS = ("auto", "kernel", "reference")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# (-1)^v pattern over the 64 natural-order coefficients, varying along columns
_COL_SIGNS = np.where(np.arange(64) % 8 % 2 == 0, 1.0, -1.0).astype(np.float32)


def _signs_for(channels: int, signs: np.ndarray) -> np.ndarray:
    """Tile the per-block sign pattern to stacked-component channels
    (e.g. CbCr tensors carry Cb|Cr as 128 channels)."""
    if channels % 64 != 0:
        raise ValueError(f"channel count {channels} is not a multiple of 64")
    return np.tile(signs, channels // 64)


@functools.lru_cache(maxsize=None)
def _col_signs(channels: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(_signs_for(channels, _COL_SIGNS), dtype=dtype, device=device)


def dct_flip_horizontal_reference(blocks: torch.Tensor) -> torch.Tensor:
    """The plain version: reverse the W8 axis, multiply by the column signs."""
    return blocks.flip(-2) * _col_signs(blocks.shape[-1], blocks.device, blocks.dtype)


def dct_flip_horizontal(blocks: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """Horizontally flip a (..., H8, W8, C) coefficient tensor, exactly
    matching a pixel-domain horizontal flip of the decoded image.

    The kernel takes float32 or bfloat16, contiguous and 16-byte aligned,
    with C a multiple of 64; it writes a new tensor on the current stream."""
    if impl not in IMPLS:
        raise ValueError(f"dct flip impl must be one of {IMPLS}, got {impl!r}")
    if blocks.dim() < 3:
        raise ValueError(f"blocks must be (..., H8, W8, C), got {tuple(blocks.shape)}")
    _signs_for(blocks.shape[-1], _COL_SIGNS)  # raises unless C is a multiple of 64
    if impl == "reference" or (impl == "auto" and blocks.device.type == "cpu"):
        return dct_flip_horizontal_reference(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"the dct flip kernel runs on cuda, got {blocks.device}")
    if blocks.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the dct flip kernel takes float32 or bfloat16, got {blocks.dtype}")
    if not blocks.is_contiguous():
        raise ValueError("dct_flip_horizontal needs a contiguous tensor")
    if blocks.data_ptr() % 16:
        raise ValueError("dct_flip_horizontal needs a 16-byte aligned tensor")
    out = torch.empty_like(blocks)
    w8, c = blocks.shape[-2], blocks.shape[-1]
    rows = blocks.numel() // (w8 * c) if w8 else 0
    if rows == 0:
        return out
    lib = _library()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream(blocks.device).cuda_stream
        err = lib.dct_flip_h(blocks.data_ptr(), out.data_ptr(), rows, w8, c,
                             blocks.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"dct_flip_h kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _library() -> ctypes.CDLL:
    lib = _build.load("dct_flip")
    lib.dct_flip_h.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.dct_flip_h.restype = ctypes.c_int
    return lib
