"""The SSD300 detector families and their inference decode.

Counterpart of the JAX package's `models/ssd.py`: the shared head
(`_SSDHead`), the pool5/fc6/fc7 neck and the extra blocks
(`_SSDNeckMixin`, `_FC6CenterTap`), the five families and
`make_inference_fn`:

  SSDResNetCustom     the flagship `ssd_custom` (late-concat ResNet trunk)
  SSDResNetIdentical  a DCT ResNet stem (`deconv`, `up_sampling`,
                      `cb5_only`, `y_cb4_cbcr_cb5`) + the original SSD300
                      extras; its first source is L2Norm of the raw Y input
  SSDVGG              the original VGG16 SSD300 on RGB images
  SSDVGGDCT           the dual DCT-input VGG SSD300 (`ssd300_vgg_dct`)
  SSDVGGDCTImage      one "DCT image" through a stride-8 8x8 stem

The model returns the raw prediction tensor `(B, n_boxes_total,
n_classes + 1 + 12)` = [softmax conf, loc offsets, anchor coords, variances],
float32, from NHWC inputs; `make_inference_fn` turns it into `(B, top_k, 6)`
detections.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
from jpeg_detection_resnet_ssd_torch.boxes.decode import decode_detections
from jpeg_detection_resnet_ssd_torch.models import layers
from jpeg_detection_resnet_ssd_torch.models.layers import (
    BatchNorm,
    Conv,
    L2Normalization,
    he_normal_,
    max_pool,
    nchw_to_nhwc,
    nhwc_to_nchw,
    relu_convs,
    zero_pad2d,
)
from jpeg_detection_resnet_ssd_torch.models.resnet import (
    BLOCK5,
    DCTStem,
    ResNetBlocks,
    as_inputs,
    late_concat_specs,
)
from jpeg_detection_resnet_ssd_torch.models.vgg import add_convs
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Predictor layer base names, kept from the original VGG-SSD for weight
# compatibility even where the source feature maps were remapped.
_HEAD_NAMES = ("conv4_3_norm", "fc7", "conv6_2", "conv7_2", "conv8_2", "conv9_2")
# `ssd300_vgg`'s in-graph preprocessing: the ImageNet mean of its RGB input,
# then the channel order of its Caffe weights.
_RGB_MEAN = (123.0, 117.0, 104.0)
_TO_BGR = [2, 1, 0]


def ssd_predictor_sizes(family: str) -> tuple[tuple[int, int], ...]:
    """Static predictor feature-map sizes per model family (300x300 input)."""
    if family in ("vgg", "vgg_dct", "vgg_dct_image", "resnet_custom"):
        return ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))
    if family == "resnet_identical":
        return ((38, 38), (10, 10), (5, 5), (5, 5), (3, 3), (1, 1))
    raise ValueError(f"unknown SSD family {family!r}")


class _SSDHead(nn.Module):
    """Shared conf/loc predictor heads + prediction tensor assembly.

    The conf and loc predictors of each source are held as two parameter
    groups under the reference head names but executed as one conv over the
    concatenated output channels (the same contraction per output channel).
    The conv output is NHWC before the reshape to boxes, so box order lines
    up with the anchors' (fh, fw, n_boxes) row order.  The conf layers are
    `{name}_mbox_conf_{n_classes + 1}`, or `{name}_mbox_conf` without
    `class_suffixed_conf_names` (the original VGG SSD300's names).
    """

    def __init__(
        self,
        n_classes: int,
        spec: AnchorSpec,
        in_features: Sequence[int],
        generator: torch.Generator | None = None,
        class_suffixed_conf_names: bool = True,
    ):
        super().__init__()
        if len(in_features) != spec.n_layers:
            raise ValueError(f"{len(in_features)} sources for {spec.n_layers} anchor layers")
        self.n_classes = n_classes
        self.spec = spec
        self._names = []
        n_total = n_classes + 1
        for name, cin, n_boxes in zip(_HEAD_NAMES, in_features, spec.boxes_per_cell()):
            conf_name = f"{name}_mbox_conf_{n_total}" if class_suffixed_conf_names else f"{name}_mbox_conf"
            loc_name = f"{name}_mbox_loc"
            self.add_module(conf_name, Conv(cin, n_boxes * n_total, 3, generator=generator))
            self.add_module(loc_name, Conv(cin, n_boxes * 4, 3, generator=generator))
            self._names.append((conf_name, loc_name))
        self._anchors: dict[tuple, torch.Tensor] = {}

    def _anchor_tensor(self, sizes, dtype, device) -> torch.Tensor:
        key = (tuple(sizes), dtype, device)
        anchors = self._anchors.get(key)
        if anchors is None:
            # Held in the compute dtype and widened back to float32, as the
            # JAX head does (bf16 compute rounds the anchor columns).
            anchors = torch.as_tensor(
                build_anchors(self.spec, sizes, coords="centroids"), device=device
            ).to(dtype).float()
            # A trace (torch.export) owns its own copy as a constant: a
            # tensor attribute assigned while it traces cannot be exported.
            if not torch.compiler.is_compiling():
                self._anchors[key] = anchors
        return anchors

    def forward(self, sources: Sequence[torch.Tensor]) -> torch.Tensor:
        n_total = self.n_classes + 1
        batch = sources[0].shape[0]
        confs, locs = [], []
        for (conf_name, loc_name), src in zip(self._names, sources):
            conf, loc = self._modules[conf_name], self._modules[loc_name]
            if conf.model_shard is None and loc.model_shard is None:
                n_conf = conf.weight.shape[0]
                weight = torch.cat([conf.weight, loc.weight], dim=0).to(src.dtype)
                bias = torch.cat([conf.bias, loc.bias], dim=0).to(src.dtype)
                # With the switch on, dW flows back through the cat to both groups.
                out = layers.conv3x3_same(src, weight, bias)
                conf_out, loc_out = out[..., :n_conf], out[..., n_conf:]
            else:  # a kernel sharded over the model axis: each conv gathers its own
                conf_out, loc_out = conf(src), loc(src)
            confs.append(conf_out.reshape(batch, -1, n_total))
            locs.append(loc_out.reshape(batch, -1, 4))
        mbox_conf = torch.cat(confs, dim=1)
        mbox_loc = torch.cat(locs, dim=1)
        sizes = [tuple(s.shape[1:3]) for s in sources]
        anchors = self._anchor_tensor(sizes, mbox_conf.dtype, mbox_conf.device)
        return torch.cat(
            [
                torch.softmax(mbox_conf.float(), dim=-1),
                mbox_loc.float(),
                anchors.expand(batch, -1, -1),
            ],
            dim=-1,
        )


class _FC6CenterTap(nn.Module):
    """fc6's 3x3 dilation-6 SAME conv on a map no larger than the dilation.

    The off-center taps then always read the zero padding, so the conv
    equals its center-tap 1x1 conv at 1/9 the FLOPs.  The full (3,3) kernel
    is still owned, so the parameters match the reference's fc6; sharded
    over the model axis, the rank's kernel slice gives its center tap.
    """

    model_shard: layers.ModelShard | None = None

    def __init__(self, in_features: int, features: int, dilation: int,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(he_normal_(torch.empty(features, in_features, 3, 3), generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] > self.dilation or x.shape[2] > self.dilation:
            raise ValueError(
                f"center-tap rewrite invalid: map {x.shape[1]}x{x.shape[2]} vs "
                f"dilation {self.dilation}"
            )
        return layers.column_parallel(self, x, lambda x, bias: nchw_to_nhwc(F.conv2d(
            nhwc_to_nchw(x), self.weight[:, :, 1:2, 1:2].to(x.dtype), bias)))


class _SSDNeckMixin(ResNetBlocks):
    """pool5 -> dilated fc6 -> fc7, and the conv{idx}_1/_2 extra blocks."""

    def _add_fc_neck(self, in_features: int, neck_size: int, generator) -> int:
        """fc6 and fc7 for a `neck_size` x `neck_size` map (static per
        family): on a map no larger than the dilation (ssd_custom's 5x5)
        fc6 is its center tap, else the full dilation-6 SAME conv."""
        if neck_size <= 6:
            self.fc6 = _FC6CenterTap(in_features, 1024, dilation=6, generator=generator)
        else:
            self.fc6 = Conv(in_features, 1024, 3, 1, "SAME", dilation=6, generator=generator)
        self.fc7 = Conv(1024, 1024, 1, 1, "SAME", generator=generator)
        return 1024

    def _fc_neck(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool(x, 3, 1, "SAME")  # 'pool5_ssd'
        x = F.relu(self.fc6(x))
        return F.relu(self.fc7(x))

    def _add_extra_block(self, in_features, n1, n2, idx, strides, generator) -> int:
        self.add_module(f"conv{idx}_1", Conv(in_features, n1, 1, 1, "SAME", generator=generator))
        self.add_module(f"conv{idx}_2", Conv(n1, n2, 3, strides, "VALID", generator=generator))
        return n2

    def _extra_block(self, x: torch.Tensor, idx: int, pad: bool) -> torch.Tensor:
        """conv{idx}_1 (1x1) [-> zero-pad] -> conv{idx}_2 (3x3, valid)."""
        x = F.relu(self._modules[f"conv{idx}_1"](x))
        if pad:
            x = zero_pad2d(x, 1)
        return F.relu(self._modules[f"conv{idx}_2"](x))


class _SSD300Tail(_SSDNeckMixin):
    """A trunk followed by the original SSD300's tail: the neck, extra
    blocks 6-9 (conv6 at stride 2, conv7 at `conv7_strides`; conv6 and
    conv7 zero-padded first) and the head over [L2Norm(tap), fc7, conv6_2,
    conv7_2, conv8_2, conv9_2].  Subclasses register their trunk, then
    `_add_tail`; their forward ends in `_tail(tap, x)`."""

    def __init__(self, n_classes: int, spec: AnchorSpec, dtype: torch.dtype, remat: bool):
        super().__init__()
        self.n_classes = n_classes
        self.spec = spec
        self.dtype = dtype
        self.remat = remat

    def _add_tail(self, in_features: int, tap_features: int, neck_size: int, conv7_strides: int,
                  generator, class_suffixed_conf_names: bool = True) -> None:
        c = self._add_fc_neck(in_features, neck_size, generator)
        widths = [c, self._add_extra_block(c, 256, 512, 6, 2, generator)]
        widths.append(self._add_extra_block(widths[-1], 128, 256, 7, conv7_strides, generator))
        for idx in (8, 9):
            widths.append(self._add_extra_block(widths[-1], 128, 256, idx, 1, generator))
        self.conv4_3_norm = L2Normalization(tap_features)
        self.head = _SSDHead(self.n_classes, self.spec, (tap_features, *widths), generator,
                             class_suffixed_conf_names)

    def _tail(self, tap: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        maps = [self._fc_neck(x)]
        for idx, pad in ((6, True), (7, True), (8, False), (9, False)):
            maps.append(self._extra_block(maps[-1], idx, pad))
        return self.head([self.conv4_3_norm(tap), *maps])


# The late-concat-RFA-thinner trunk of `ssd_custom`, in execution order:
# the Y trunk (38x38, ends at the conv4_3 tap), its stride-2 block (-> 19x19),
# the CbCr block, stage 3 on concat(y, cbcr) (ends at the conv3_3 tap) and
# stage 4 (-> 10x10, ends at the conv4_6 tap).
_Y_TRUNK, _Y_DOWN, _CBCR, _STAGE3, _STAGE4 = late_concat_specs()


class SSDResNetCustom(_SSDNeckMixin):
    """The flagship "ssd_custom" detector.

    Trunk = late-concat-RFA-thinner at detection scale with three
    L2-normalized taps; predictor sources:
      conv4_3(38x38x384), conv3_3(19x19x512), conv4_6(10x10x1024),
      fc7(5x5x1024), conv6_2(3x3x256), conv9_2(1x1x256).

    Inputs: (y, cbcr) NHWC with y (B,38,38,64) and cbcr (B,19,19,128).
    Parameters are float32; `dtype` is the compute dtype; `remat`
    recomputes the bottleneck branches in the backward pass.
    """

    def __init__(
        self,
        n_classes: int = 20,
        spec: AnchorSpec = AnchorSpec(),
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.n_classes = n_classes
        self.spec = spec
        self.dtype = dtype
        self.remat = remat
        g = generator
        self.bn_y_in = BatchNorm(64)
        c = self._add_blocks(64, _Y_TRUNK, g)
        c_y = self._add_blocks(c, _Y_DOWN, g)
        self.bn_cbcr_in = BatchNorm(128)
        c_cbcr = self._add_blocks(128, _CBCR, g)
        c = self._add_blocks(c_y + c_cbcr, _STAGE3, g)
        c = self._add_blocks(c, _STAGE4, g)
        c = self._add_blocks(c, BLOCK5, g)
        c = self._add_fc_neck(c, 5, g)
        c6 = self._add_extra_block(c, 256, 256, 6, 2, g)
        c9 = self._add_extra_block(c6, 128, 256, 9, 1, g)
        self.conv4_3_norm = L2Normalization(384)
        self.conv3_3_norm = L2Normalization(512)
        self.conv4_6_norm = L2Normalization(1024)
        self.head = _SSDHead(n_classes, spec, (384, 512, 1024, 1024, c6, c9), generator=g)

    def forward(self, inputs) -> torch.Tensor:
        y, cbcr = inputs
        device = self.bn_y_in.weight.device
        y = torch.as_tensor(y, device=device).to(self.dtype)
        cbcr = torch.as_tensor(cbcr, device=device).to(self.dtype)

        conv4_3 = self._run_blocks(self.bn_y_in(y), _Y_TRUNK)
        yb = self._run_blocks(conv4_3, _Y_DOWN)
        cb = self._run_blocks(self.bn_cbcr_in(cbcr), _CBCR)
        conv3_3 = self._run_blocks(torch.cat([yb, cb], dim=-1), _STAGE3)
        conv4_6 = self._run_blocks(conv3_3, _STAGE4)
        x = self._run_blocks(conv4_6, BLOCK5)  # -> 5x5x2048
        fc7 = self._fc_neck(x)  # 5x5x1024
        conv6_2 = self._extra_block(fc7, 6, pad=True)  # 3x3x256
        conv9_2 = self._extra_block(conv6_2, 9, pad=False)  # 1x1x256

        sources = [
            self.conv4_3_norm(conv4_3),
            self.conv3_3_norm(conv3_3),
            self.conv4_6_norm(conv4_6),
            fc7,
            conv6_2,
            conv9_2,
        ]
        return self.head(sources)


class SSDResNetIdentical(_SSD300Tail):
    """A DCT ResNet stem + the original SSD300 extra layers.

    `archi` picks the stem (`deconv`, `cb5_only`, `y_cb4_cbcr_cb5`, or
    `up_sampling`, which builds the `up_sampling_rfa` stem); then stage 5
    (-> 10x10x2048), the neck with the full dilated fc6, and extras 6-9.
    Predictor sources: L2Norm of the RAW Y input (38x38x64), fc7 (10x10),
    conv6_2 (5x5), conv7_2 (5x5), conv8_2 (3x3), conv9_2 (1x1).

    Inputs: (y, cbcr) with y (B,38,38,64) and cbcr (B,19,19,128), or
    (y, cb, cr) with cb, cr (B,19,19,64) for `deconv`.
    """

    def __init__(
        self,
        archi: str = "deconv",
        n_classes: int = 20,
        spec: AnchorSpec = AnchorSpec(),
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__(n_classes, spec, dtype, remat)
        self.archi = archi
        stem_archi = "up_sampling_rfa" if archi == "up_sampling" else archi
        self.stem = DCTStem(stem_archi, remat=remat, generator=generator)
        c = self._add_blocks(self.stem.out_features, BLOCK5, generator)
        self._add_tail(c, 64, 10, 1, generator)

    def forward(self, inputs) -> torch.Tensor:
        inputs = as_inputs(inputs, self.conv4_3_norm.gamma.device, self.dtype)
        x, _ = self.stem(inputs)
        return self._tail(inputs[0], self._run_blocks(x, BLOCK5))  # stage 5 -> 10x10x2048


# The VGG blocks 4 and 5 of the DCT-input VGG SSDs.
_CONV4 = ("conv4_1", "conv4_2", "conv4_3")
_CONV5 = ("conv5_1", "conv5_2", "conv5_3")


class SSDVGG(_SSD300Tail):
    """The original VGG16 SSD300 on RGB images (`ssd300_vgg`).

    In-graph preprocessing: the mean (123, 117, 104) subtracted and the
    channels swapped to BGR, so raw 0-255 images go in.  VGG16 blocks 1-5
    with SAME 2x2 pools (300 -> 150 -> 75 -> 38 -> 19; conv4_3 tapped at
    38x38), the neck on 19x19 and extras 6-9.  The conf layers are named
    `{source}_mbox_conf`, without the class suffix.

    Input: (B, 300, 300, 3).
    """

    _DEPTHS = ((64, 2), (128, 2), (256, 3), (512, 3))

    def __init__(
        self,
        n_classes: int = 20,
        spec: AnchorSpec = AnchorSpec(),
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__(n_classes, spec, dtype, remat)  # (remat: no bottlenecks to recompute)
        c = 3
        self._blocks = []
        for bi, (width, n) in enumerate(self._DEPTHS + ((512, 3),), start=1):
            names = [f"conv{bi}_{j}" for j in range(1, n + 1)]
            c = add_convs(self, c, names, width, generator)
            self._blocks.append(names)
        self._add_tail(c, 512, 19, 2, generator, class_suffixed_conf_names=False)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x, self.conv1_1.weight.device, self.dtype)
        x = (x - torch.tensor(_RGB_MEAN, dtype=x.dtype, device=x.device))[..., _TO_BGR]
        for bi, names in enumerate(self._blocks, start=1):
            x = relu_convs(self, names, x)
            if bi == 4:
                conv4_3 = x
            if bi < 5:
                x = max_pool(x, 2, 2, "SAME")
        return self._tail(conv4_3, x)  # the neck on 19x19


class SSDVGGDCT(_SSD300Tail):
    """The dual DCT-input VGG SSD300 (`ssd300_vgg_dct`).

    Y (38,38,64): BatchNorm `b_norm_64` -> conv1_1_dct_256 -> conv4_1..3
    (tap conv4_3) -> 2x2 pool (VALID, 38 -> 19); concat the BatchNorm'd
    CbCr (`b_norm_128`, 19,19,128) -> conv5_1..3; the neck on 19x19 and
    extras 6-9.
    """

    def __init__(
        self,
        n_classes: int = 20,
        spec: AnchorSpec = AnchorSpec(),
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__(n_classes, spec, dtype, remat)  # (remat: no bottlenecks to recompute)
        self.b_norm_128 = BatchNorm(128)
        self.b_norm_64 = BatchNorm(64)
        self.conv1_1_dct_256 = Conv(64, 256, 3, generator=generator)
        c = add_convs(self, 256, _CONV4, 512, generator)
        c = add_convs(self, c + 128, _CONV5, 512, generator)
        self._add_tail(c, 512, 19, 2, generator)

    def forward(self, inputs) -> torch.Tensor:
        y, cbcr = as_inputs(inputs, self.b_norm_64.weight.device, self.dtype)
        norm_cbcr = self.b_norm_128(cbcr)
        x = F.relu(self.conv1_1_dct_256(self.b_norm_64(y)))
        conv4_3 = relu_convs(self, _CONV4, x)
        x = torch.cat([max_pool(conv4_3, 2, 2), norm_cbcr], dim=-1)  # 38 -> 19
        return self._tail(conv4_3, relu_convs(self, _CONV5, x))


class SSDVGGDCTImage(_SSD300Tail):
    """The single "DCT image" SSD300 (`ssd300_vgg_dct_image`).

    A (300,300,3) plane of coefficients laid out in 8x8 blocks: BatchNorm
    `b_norm` -> conv1_1_dct (196, 8x8, stride 8, SAME: 300 -> 38) ->
    conv4_1..3 (tap conv4_3) -> 2x2 SAME pool (38 -> 19) -> conv5_1..3; the
    neck on 19x19 and extras 6-9.
    """

    def __init__(
        self,
        n_classes: int = 20,
        spec: AnchorSpec = AnchorSpec(),
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__(n_classes, spec, dtype, remat)  # (remat: no bottlenecks to recompute)
        self.b_norm = BatchNorm(3)
        self.conv1_1_dct = Conv(3, 196, 8, 8, "SAME", generator=generator)
        c = add_convs(self, 196, _CONV4, 512, generator)
        c = add_convs(self, c, _CONV5, 512, generator)
        self._add_tail(c, 512, 19, 2, generator)

    def forward(self, x) -> torch.Tensor:
        x = as_inputs(x, self.b_norm.weight.device, self.dtype)
        x = F.relu(self.conv1_1_dct(self.b_norm(x)))  # 300 -> 38
        conv4_3 = relu_convs(self, _CONV4, x)
        return self._tail(conv4_3, relu_convs(self, _CONV5, max_pool(conv4_3, 2, 2, "SAME")))


def make_inference_fn(
    n_classes: int,
    spec: AnchorSpec,
    confidence_thresh: float = 0.01,
    iou_threshold: float = 0.45,
    top_k: int = 200,
    nms_max_output_size: int = 400,
    nms_impl: str = "auto",
    candidate_selector: str = "exact",
    shared_pool_size: int = 1024,
    pool_topk_impl: str = "sort",
    device: str | torch.device | None = None,
):
    """Decode hook turning the model's raw output into (B, top_k, 6) detections.

    Compose as `decode_fn(model((y, cbcr)))`.  The returned function moves its
    input (a tensor or NumPy array) to `device`, which is the CUDA device
    unless the caller asks for the CPU; without a card, `device=None` raises.
    `candidate_selector='shared'` is the serving choice (see
    `boxes.decode.select_candidates`); 'exact' is the reference's literal
    per-class semantics.
    """
    dev = resolve_device(device)
    decode = functools.partial(
        decode_detections,
        n_classes=n_classes,
        confidence_thresh=confidence_thresh,
        iou_threshold=iou_threshold,
        top_k=top_k,
        nms_max_output_size=nms_max_output_size,
        normalize_coords=spec.normalize_coords,
        img_height=spec.img_height,
        img_width=spec.img_width,
        nms_impl=nms_impl,
        candidate_selector=candidate_selector,
        shared_pool_size=shared_pool_size,
        pool_topk_impl=pool_topk_impl,
    )

    def decode_fn(y_pred) -> torch.Tensor:
        return decode(torch.as_tensor(y_pred, dtype=torch.float32, device=dev))

    return decode_fn

