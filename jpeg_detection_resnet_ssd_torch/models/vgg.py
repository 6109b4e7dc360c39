"""VGG-A / VGG-D classifiers: the RGB baselines and the DCT variants.

Counterpart of the JAX package's `models/vgg.py`:

  VGG(variant)        `vgga` / `vggd`: plain VGG on (B, 224, 224, 3) RGB.
  VGGDCT(variant)     `vgga_dct` / `vggd_dct`: Y (B, 28, 28, 64) through a
                      256-wide entry conv and block 4; the BatchNorm'd CbCr
                      (B, 14, 14, 128) concatenated before block 5.
  VGGDCT8x8(variant)  `vgga_dct_8x8` / `vggd_dct_8x8`: one (B, 224, 224, 3)
                      "DCT image" through a Conv(196, 8x8, stride 8) stem.

All return logits in the compute dtype.  The head flattens the NHWC map in
(h, w, c) order, as flax does, so `Dense` fc1 weights carry over; its two
Dropout(0.5) layers act in train mode only (`layers.Dropout`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    Dropout,
    max_pool,
    relu_convs,
)
from jpeg_detection_resnet_ssd_torch.models.resnet import as_inputs

# convs per block for each variant (blocks 1..5)
_BLOCK_DEPTH = {"a": (1, 1, 2, 2, 2), "d": (2, 2, 3, 3, 3)}
_BLOCK_WIDTH = (64, 128, 256, 512, 512)


class _VGGHead(nn.Module):
    """Flatten -> fc1 (4096) -> dropout -> fc2 (4096) -> dropout -> logits."""

    def __init__(self, in_features: int, num_classes: int = 1000,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.fc1 = Dense(in_features, 4096, generator=generator)
        self.drop1 = Dropout(0.5)
        self.fc2 = Dense(4096, 4096, generator=generator)
        self.drop2 = Dropout(0.5)
        self.predictions = Dense(4096, num_classes, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = self.drop1(F.relu(self.fc1(x)))
        x = self.drop2(F.relu(self.fc2(x)))
        return self.predictions(x)


def add_convs(model: nn.Module, in_features: int, names, width: int, generator) -> int:
    """Register 3x3 SAME convs `names`, `width` wide, on `model`."""
    for name in names:
        model.add_module(name, Conv(in_features, width, 3, generator=generator))
        in_features = width
    return width


class VGG(nn.Module):
    """Plain VGG-A/D on RGB images: blocks 1-5 of 3x3 convs
    (`block{b}_conv{j}`), each followed by a 2x2 pool, then the head."""

    def __init__(self, variant: str = "a", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        self._blocks = []
        c = 3
        for block, (n, width) in enumerate(zip(_BLOCK_DEPTH[variant], _BLOCK_WIDTH), start=1):
            names = [f"block{block}_conv{j}" for j in range(1, n + 1)]
            c = add_convs(self, c, names, width, generator)
            self._blocks.append(names)
        self.head = _VGGHead(7 * 7 * c, num_classes, generator)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x, self.head.fc1.weight.device, self.dtype)
        for names in self._blocks:
            x = max_pool(relu_convs(self, names, x), 2, 2)
        return self.head(x)


class VGGDCT(nn.Module):
    """Dual-input DCT VGG: Y -> BatchNorm `b_norm_64` -> conv1_1_dct_256 ->
    conv4_x -> pool (28 -> 14) -> concat the BatchNorm'd CbCr (`b_norm_128`)
    -> conv5_x -> pool (14 -> 7) -> head; 2 (A) or 3 (D) convs a block."""

    def __init__(self, variant: str = "a", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        n = 2 if variant == "a" else 3
        g = generator
        self.b_norm_128 = BatchNorm(128)
        self.b_norm_64 = BatchNorm(64)
        self.conv1_1_dct_256 = Conv(64, 256, 3, generator=g)
        self._conv4 = [f"conv4_{j}" for j in range(1, n + 1)]
        self._conv5 = [f"conv5_{j}" for j in range(1, n + 1)]
        c = add_convs(self, 256, self._conv4, 512, g)
        c = add_convs(self, c + 128, self._conv5, 512, g)
        self.head = _VGGHead(7 * 7 * c, num_classes, g)

    def forward(self, inputs) -> torch.Tensor:
        y, cbcr = as_inputs(inputs, self.head.fc1.weight.device, self.dtype)
        norm_cbcr = self.b_norm_128(cbcr)
        x = F.relu(self.conv1_1_dct_256(self.b_norm_64(y)))
        x = max_pool(relu_convs(self, self._conv4, x), 2, 2)  # 28 -> 14
        x = relu_convs(self, self._conv5, torch.cat([x, norm_cbcr], dim=-1))
        return self.head(max_pool(x, 2, 2))  # 14 -> 7


class VGGDCT8x8(nn.Module):
    """Single-input "DCT image" VGG: a (224, 224, 3) plane of coefficients
    in 8x8 block positions -> BatchNorm `b_norm_input` -> conv1_1_dct_8x8
    (196, 8x8, stride 8, SAME: 224 -> 28) -> conv4_x -> pool -> conv5_x ->
    pool -> head."""

    def __init__(self, variant: str = "a", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.variant = variant
        self.dtype = dtype
        n = 2 if variant == "a" else 3
        g = generator
        self.b_norm_input = BatchNorm(3)
        self.conv1_1_dct_8x8 = Conv(3, 196, 8, 8, "SAME", generator=g)
        self._conv4 = [f"conv4_{j}" for j in range(1, n + 1)]
        self._conv5 = [f"conv5_{j}" for j in range(1, n + 1)]
        c = add_convs(self, 196, self._conv4, 512, g)
        c = add_convs(self, c, self._conv5, 512, g)
        self.head = _VGGHead(7 * 7 * c, num_classes, g)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x, self.head.fc1.weight.device, self.dtype)
        x = F.relu(self.conv1_1_dct_8x8(self.b_norm_input(x)))  # 224 -> 28
        x = max_pool(relu_convs(self, self._conv4, x), 2, 2)
        x = max_pool(relu_convs(self, self._conv5, x), 2, 2)
        return self.head(x)
