"""Keras-named ResNet bottleneck blocks on NHWC tensors.

Counterpart of the JAX package's `ResNetBlocks` (`models/resnet.py`): 1x1 ->
kxk('same') -> 1x1 bottleneck with BatchNorm after each conv, residual add,
final relu; the conv variant adds a strided 1x1 projection shortcut.

The layers are registered flat on the owning module under the Keras names
(`res{stage}{block}_branch2a`, `bn{stage}{block}_branch2a`, ...,
`res{stage}{block}_branch1`), so the state_dict keys are the JAX package's
parameter paths and weights carry over by name.  A model lists its blocks
as `Block` specs, registers them with `_add_blocks` and runs them with
`_run_blocks`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.models.layers import BatchNorm, Conv


class Block(NamedTuple):
    """One bottleneck: `strides` None is an identity block, else a conv
    block whose 2a conv and projection shortcut use those strides."""

    kernel: int
    filters: tuple[int, int, int]
    stage: int
    block: str
    strides: int | None = None


def identity_block(kernel: int, filters, stage: int, block: str) -> Block:
    return Block(kernel, tuple(filters), stage, block)


def conv_block(kernel: int, filters, stage: int, block: str, strides: int = 2) -> Block:
    return Block(kernel, tuple(filters), stage, block, strides)


# Stage 5 [512, 512, 2048], the shared tail of every DCT variant (`_block5`).
BLOCK5 = (
    conv_block(3, (512, 512, 2048), 5, "a"),
    identity_block(3, (512, 512, 2048), 5, "b"),
    identity_block(3, (512, 512, 2048), 5, "c"),
)


class ResNetBlocks(nn.Module):
    """Mixin: registers and runs Keras-named bottlenecks."""

    def _add_blocks(
        self, in_features: int, blocks: Sequence[Block], generator: torch.Generator | None
    ) -> int:
        """Register the layers of `blocks` in order; returns the out width."""
        for blk in blocks:
            f1, f2, f3 = blk.filters
            cn = f"res{blk.stage}{blk.block}_branch"
            bn = f"bn{blk.stage}{blk.block}_branch"
            strides = blk.strides or 1
            if blk.strides is None and in_features != f3:
                raise ValueError(f"identity block {cn} maps {in_features} -> {f3} channels")
            self.add_module(cn + "2a", Conv(in_features, f1, 1, strides, "VALID", generator=generator))
            self.add_module(bn + "2a", BatchNorm(f1))
            self.add_module(cn + "2b", Conv(f1, f2, blk.kernel, 1, "SAME", generator=generator))
            self.add_module(bn + "2b", BatchNorm(f2))
            self.add_module(cn + "2c", Conv(f2, f3, 1, 1, "VALID", generator=generator))
            self.add_module(bn + "2c", BatchNorm(f3))
            if blk.strides is not None:
                self.add_module(cn + "1", Conv(in_features, f3, 1, strides, "VALID", generator=generator))
                self.add_module(bn + "1", BatchNorm(f3))
            in_features = f3
        return in_features

    def _bottleneck(self, x: torch.Tensor, blk: Block) -> torch.Tensor:
        m = self._modules
        cn = f"res{blk.stage}{blk.block}_branch"
        bn = f"bn{blk.stage}{blk.block}_branch"
        y = F.relu(m[bn + "2a"](m[cn + "2a"](x)))
        y = F.relu(m[bn + "2b"](m[cn + "2b"](y)))
        y = m[bn + "2c"](m[cn + "2c"](y))
        shortcut = x if blk.strides is None else m[bn + "1"](m[cn + "1"](x))
        return F.relu(y + shortcut)

    def _run_blocks(self, x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
        for blk in blocks:
            x = self._bottleneck(x, blk)
        return x
