"""ResNet-50 backbones on NHWC tensors: Keras-named bottleneck blocks, the
RGB baseline and the 7 DCT-input stems.

Counterpart of the JAX package's `models/resnet.py`.  `ResNetBlocks`: 1x1 ->
kxk('same') -> 1x1 bottleneck with BatchNorm after each conv, residual add,
final relu; the conv variant adds a strided 1x1 projection shortcut.  With
`remat`, each bottleneck branch is recomputed in the backward pass
(`torch.utils.checkpoint`, non-reentrant) instead of keeping its
activations; the recompute runs with the filter-gradient switch as it was in
the forward and with BatchNorm's running statistics frozen, so it moves them
once, as JAX's pure recompute does.

The layers are registered flat on the owning module under the Keras names
(`res{stage}{block}_branch2a`, `bn{stage}{block}_branch2a`, ...,
`res{stage}{block}_branch1`), so the state_dict keys are the JAX package's
parameter paths and weights carry over by name.  A model lists its blocks
as `Block` specs, registers them with `_add_blocks` and runs them with
`_run_blocks`.

`DCTStem` switches on `archi` between the 7 DCT stems, ending before stage
5; `ResNet50DCT` adds stage 5, the global mean and the `fc1000` logits, and
`ResNet50RGB` is the stock ResNet-50 on (B, 224, 224, 3) images.  Input
contracts (224x224 source images): DCT y (B, 28, 28, 64), cbcr (B, 14, 14,
128); `deconv` splits cbcr into cb and cr (B, 14, 14, 64) each.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dense,
    max_pool,
    upsample2x,
    zero_pad2d,
)

CLASSIFICATION_ARCHIS = (
    "deconv",
    "up_sampling",
    "up_sampling_rfa",
    "late_concat_rfa_thinner",
    "late_concat_more_channels",
    "cb5_only",
    "y_cb4_cbcr_cb5",
)


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


def _checkpointed(fn, *args):
    """`fn(*args)` whose activations are recomputed in the backward pass.
    The recompute runs under the filter-gradient switch of this call and
    with BatchNorm's running statistics frozen."""
    wgrad = layers.pallas_wgrad_enabled()
    calls = 0

    def run(*a):
        nonlocal calls
        calls += 1
        if calls == 1:
            return fn(*a)
        with layers.pallas_wgrad(wgrad), layers.running_stats_frozen():
            return fn(*a)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


class ResNetBlocks(nn.Module):
    """Mixin: registers and runs Keras-named bottlenecks; `remat` (a plain
    attribute, False unless a model sets it) checkpoints each branch."""

    remat = False

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

    def _branch(self, x: torch.Tensor, blk: Block) -> torch.Tensor:
        m = self._modules
        cn = f"res{blk.stage}{blk.block}_branch"
        bn = f"bn{blk.stage}{blk.block}_branch"
        y = F.relu(m[bn + "2a"](m[cn + "2a"](x)))
        y = F.relu(m[bn + "2b"](m[cn + "2b"](y)))
        return m[bn + "2c"](m[cn + "2c"](y))

    def _bottleneck(self, x: torch.Tensor, blk: Block) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            y = _checkpointed(self._branch, x, blk)
        else:
            y = self._branch(x, blk)
        if blk.strides is None:
            return F.relu(y + x)
        cn = f"res{blk.stage}{blk.block}_branch1"
        bn = f"bn{blk.stage}{blk.block}_branch1"
        return F.relu(y + self._modules[bn](self._modules[cn](x)))

    def _run_blocks(self, x: torch.Tensor, blocks: Sequence[Block]) -> torch.Tensor:
        for blk in blocks:
            x = self._bottleneck(x, blk)
        return x

# Stage 4 [256, 256, 1024] from a stride-2 conv block, shared by the
# late-concat and up-sampling stems and the RGB model.
STAGE4 = (
    conv_block(3, (256, 256, 1024), 4, "a"),
    *(identity_block(3, (256, 256, 1024), 4, b) for b in "bcdef"),
)


def late_concat_specs(more_channels: bool = False):
    """The late-concat stem's block lists, in execution order: (Y trunk on
    bn_y_in(y) at full resolution, its stride-2 conv block a4, the CbCr
    conv block a5 on bn_cbcr_in(cbcr), stage 3 on concat(y, cbcr) from
    block b, stage 4).  `more_channels` is `late_concat_more_channels`
    (768-wide Y trunk, stage-3 blocks b1/c1/d1); else the thinner variant,
    the trunk of `ssd_custom` too."""
    wide = 768 if more_channels else 384
    mid = (256, 256, 768) if more_channels else (128, 128, 384)
    sfx = "1" if more_channels else ""
    y_trunk = (
        conv_block(1, (256, 256, wide), 1, "a2", strides=1),
        identity_block(2, (256, 256, wide), 1, "b2"),
        identity_block(3, (256, 256, wide), 1, "c2"),
        conv_block(3, mid, 2, "a3", strides=1),
        *(identity_block(3, mid, 2, b) for b in ("b3", "c3", "d3")),
    )
    y_down = (conv_block(3, (256, 256, 384), 2, "a4"),)
    cbcr = (conv_block(1, (256, 256, 128), 2, "a5", strides=1),)
    stage3 = tuple(identity_block(3, (128, 128, 512), 3, b + sfx) for b in "bcd")
    return y_trunk, y_down, cbcr, stage3, STAGE4


def _y_trunk(stage1_width: int, stage2_filters):
    """The Y trunk of cb5_only / y_cb4_cbcr_cb5 at full resolution: stage
    1's a2/b2/c2 blocks `stage1_width` wide, then stage 2's a3..d3."""
    return (
        conv_block(1, (256, 256, stage1_width), 1, "a2", strides=1),
        identity_block(2, (256, 256, stage1_width), 1, "b2"),
        identity_block(3, (256, 256, stage1_width), 1, "c2"),
        conv_block(3, stage2_filters, 2, "a3", strides=1),
        *(identity_block(3, stage2_filters, 2, b) for b in ("b3", "c3", "d3")),
    )


def _stem_plan(archi: str):
    """(input width of the post-concat blocks, Y segments, CbCr segments,
    post-concat segments) of a DCT stem; a segment is (blocks, tap name or
    None), the tap being the map after its last block.  The up-sampling
    family has no Y or CbCr segments: its inputs meet at `bn_in`."""
    stage3_a1 = (
        conv_block(3, (128, 128, 512), 3, "a1", strides=1),
        *(identity_block(3, (128, 128, 512), 3, b) for b in "bcd"),
    )
    if archi in ("deconv", "up_sampling", "up_sampling_rfa"):
        post = []
        if archi != "up_sampling":  # receptive-field-aware entry blocks
            post.append(((
                conv_block(1, (256, 256, 1024), 4, "a2", strides=1),
                identity_block(2, (256, 256, 1024), 4, "b2"),
                identity_block(3, (256, 256, 1024), 4, "c2"),
            ), None))
        post += [(stage3_a1 + STAGE4[:3], "conv4_3"), (STAGE4[3:], None)]
        return 64 + 128, [], [], post
    if archi in ("late_concat_rfa_thinner", "late_concat_more_channels"):
        y_trunk, y_down, cbcr, stage3, stage4 = late_concat_specs(
            archi == "late_concat_more_channels")
        return 384 + 128, [(y_trunk + y_down, None)], [(cbcr, None)], [(stage3 + stage4, None)]
    a5 = (conv_block(1, (256, 256, 256), 2, "a5", strides=1),)
    if archi == "cb5_only":
        y = _y_trunk(768, (256, 256, 768))
        return 768 + 256, [(y + (conv_block(3, (256, 256, 768), 2, "a4"),), None)], [(a5, None)], []
    if archi == "y_cb4_cbcr_cb5":
        y = _y_trunk(384, (128, 128, 512))
        stage4_768 = (
            conv_block(3, (256, 256, 768), 4, "a2"),
            *(identity_block(3, (256, 256, 768), 4, b + "2") for b in "bcdef"),
        )
        return 768 + 256, [(y, "conv4_3"), (stage4_768, "conv4_6")], [(a5, None)], []
    raise ValueError(f"unknown DCT archi {archi!r}")


class DCTStem(ResNetBlocks):
    """The 7 DCT-input ResNet stems, ending just before stage 5.

    Scale-agnostic: classification feeds (28, 28)/(14, 14) coefficient maps.
    `forward(inputs)` takes (y, cbcr), or (y, cb, cr) for `deconv`, already
    in the compute dtype, and returns `(features, taps)` with the
    intermediate maps `conv4_3` (and `conv4_6` for `y_cb4_cbcr_cb5`).
    Layer names are the JAX module's: `deconv_cb`/`deconv_cr` and `bn_in`
    for the up-sampling family, `bn_y_in`/`bn_cbcr_in` for the others."""

    def __init__(self, archi: str = "late_concat_rfa_thinner", remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.archi = archi
        self.remat = remat
        concat_width, self._y, self._cbcr, self._post = _stem_plan(archi)
        g = generator
        if archi == "deconv":
            self.deconv_cb = ConvTranspose(64, 64, 2, 2, generator=g)
            self.deconv_cr = ConvTranspose(64, 64, 2, 2, generator=g)
        if self._y:
            self.bn_y_in = BatchNorm(64)
            self._add_segments(64, self._y, g)
            self.bn_cbcr_in = BatchNorm(128)
            self._add_segments(128, self._cbcr, g)
        else:
            self.bn_in = BatchNorm(concat_width)
        self.out_features = self._add_segments(concat_width, self._post, g)

    def _add_segments(self, c: int, segments, generator) -> int:
        for blocks, _ in segments:
            c = self._add_blocks(c, blocks, generator)
        return c

    def _run_segments(self, x: torch.Tensor, segments, taps: dict) -> torch.Tensor:
        for blocks, tap in segments:
            x = self._run_blocks(x, blocks)
            if tap is not None:
                taps[tap] = x
        return x

    def forward(self, inputs):
        taps: dict[str, torch.Tensor] = {}
        if self.archi == "deconv":
            y, cb, cr = inputs
            x = self.bn_in(torch.cat([y, self.deconv_cb(cb), self.deconv_cr(cr)], dim=-1))
        elif not self._y:
            y, cbcr = inputs
            x = self.bn_in(torch.cat([y, upsample2x(cbcr)], dim=-1))
        else:
            y, cbcr = inputs
            yb = self._run_segments(self.bn_y_in(y), self._y, taps)
            cb = self._run_segments(self.bn_cbcr_in(cbcr), self._cbcr, taps)
            x = torch.cat([yb, cb], dim=-1)
        return self._run_segments(x, self._post, taps), taps


def as_inputs(inputs, device, dtype):
    """A model's input (a tuple of planes, or one image tensor) as tensors on
    `device` in the compute dtype."""
    if isinstance(inputs, (tuple, list)):
        return tuple(torch.as_tensor(a, device=device).to(dtype) for a in inputs)
    return torch.as_tensor(inputs, device=device).to(dtype)


class ResNet50DCT(ResNetBlocks):
    """ImageNet classifier over DCT inputs: `DCTStem` (scope `stem`) + stage
    5 + global mean + `fc1000`; returns logits in the compute dtype `dtype`
    (parameters stay float32)."""

    def __init__(self, archi: str = "late_concat_rfa_thinner", num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.archi = archi
        self.dtype = dtype
        self.remat = remat
        self.stem = DCTStem(archi, remat=remat, generator=generator)
        c = self._add_blocks(self.stem.out_features, BLOCK5, generator)
        self.fc1000 = Dense(c, num_classes, generator=generator)

    def forward(self, inputs) -> torch.Tensor:
        x, _ = self.stem(as_inputs(inputs, self.fc1000.weight.device, self.dtype))
        x = self._run_blocks(x, BLOCK5)
        return self.fc1000(x.mean(dim=(1, 2)))  # GlobalAveragePooling2D 'avg_pool'


_RGB_BLOCKS = (
    conv_block(3, (64, 64, 256), 2, "a", strides=1),
    *(identity_block(3, (64, 64, 256), 2, b) for b in "bc"),
    conv_block(3, (128, 128, 512), 3, "a"),
    *(identity_block(3, (128, 128, 512), 3, b) for b in "bcd"),
    *STAGE4,
    *BLOCK5,
)


class ResNet50RGB(ResNetBlocks):
    """Stock ResNet-50 (Keras layout) on NHWC images, logits output (or the
    stage-5 map with `include_top=False`)."""

    def __init__(self, num_classes: int = 1000, include_top: bool = True,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        self.include_top = include_top
        self.conv1 = Conv(3, 64, 7, 2, "VALID", generator=generator)
        self.bn_conv1 = BatchNorm(64)
        c = self._add_blocks(64, _RGB_BLOCKS, generator)
        if include_top:
            self.fc1000 = Dense(c, num_classes, generator=generator)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x, self.conv1.weight.device, self.dtype)
        x = F.relu(self.bn_conv1(self.conv1(zero_pad2d(x, 3))))
        x = max_pool(zero_pad2d(x, 1), 3, 2, "VALID")
        x = self._run_blocks(x, _RGB_BLOCKS)
        if not self.include_top:
            return x
        return self.fc1000(x.mean(dim=(1, 2)))
