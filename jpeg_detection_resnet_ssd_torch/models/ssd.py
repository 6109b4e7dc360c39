"""The flagship `ssd_custom` DCT-SSD300 detector and its inference decode.

Counterpart of the JAX package's `models/ssd.py` for `SSDResNetCustom`, the
shared head (`_SSDHead`), the pool5/fc6/fc7 neck (`_SSDNeckMixin`,
`_FC6CenterTap`) and `make_inference_fn`.  The other SSD families are not
ported yet (see ROADMAP.md).

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
    zero_pad2d,
)
from jpeg_detection_resnet_ssd_torch.models.resnet import (
    BLOCK5,
    ResNetBlocks,
    late_concat_specs,
)
from jpeg_detection_resnet_ssd_torch.utils.device import resolve_device

# Predictor layer base names, kept from the original VGG-SSD for weight
# compatibility even where the source feature maps were remapped.
_HEAD_NAMES = ("conv4_3_norm", "fc7", "conv6_2", "conv7_2", "conv8_2", "conv9_2")


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
    up with the anchors' (fh, fw, n_boxes) row order.
    """

    def __init__(
        self,
        n_classes: int,
        spec: AnchorSpec,
        in_features: Sequence[int],
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if len(in_features) != spec.n_layers:
            raise ValueError(f"{len(in_features)} sources for {spec.n_layers} anchor layers")
        self.n_classes = n_classes
        self.spec = spec
        self._names = []
        n_total = n_classes + 1
        for name, cin, n_boxes in zip(_HEAD_NAMES, in_features, spec.boxes_per_cell()):
            conf_name = f"{name}_mbox_conf_{n_total}"
            loc_name = f"{name}_mbox_loc"
            self.add_module(conf_name, Conv(cin, n_boxes * n_total, 3, generator=generator))
            self.add_module(loc_name, Conv(cin, n_boxes * 4, 3, generator=generator))
            self._names.append((conf_name, loc_name))
        self._anchors: dict[tuple, torch.Tensor] = {}

    def _anchor_tensor(self, sizes, dtype, device) -> torch.Tensor:
        key = (tuple(sizes), dtype, device)
        if key not in self._anchors:
            anchors = build_anchors(self.spec, sizes, coords="centroids")
            # Held in the compute dtype and widened back to float32, as the
            # JAX head does (bf16 compute rounds the anchor columns).
            self._anchors[key] = torch.as_tensor(anchors, device=device).to(dtype).float()
        return self._anchors[key]

    def forward(self, sources: Sequence[torch.Tensor]) -> torch.Tensor:
        n_total = self.n_classes + 1
        batch = sources[0].shape[0]
        confs, locs = [], []
        for (conf_name, loc_name), src in zip(self._names, sources):
            conf, loc = self._modules[conf_name], self._modules[loc_name]
            n_conf = conf.weight.shape[0]
            weight = torch.cat([conf.weight, loc.weight], dim=0).to(src.dtype)
            bias = torch.cat([conf.bias, loc.bias], dim=0).to(src.dtype)
            # With the switch on, dW flows back through the cat to both groups.
            out = layers.conv3x3_same(src, weight, bias)
            confs.append(out[..., :n_conf].reshape(batch, -1, n_total))
            locs.append(out[..., n_conf:].reshape(batch, -1, 4))
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
    is still owned, so the parameters match the reference's fc6.
    """

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
        weight = self.weight[:, :, 1:2, 1:2].to(x.dtype)
        return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x), weight, self.bias.to(x.dtype)))


class _SSDNeckMixin(ResNetBlocks):
    """pool5 -> dilated fc6 -> fc7, and the conv{idx}_1/_2 extra blocks."""

    def _add_fc_neck(self, in_features: int, generator) -> int:
        self.fc6 = _FC6CenterTap(in_features, 1024, dilation=6, generator=generator)
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
        c = self._add_fc_neck(c, g)
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

