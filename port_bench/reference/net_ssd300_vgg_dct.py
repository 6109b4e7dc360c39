"""The dual DCT-input VGG SSD300 (`ssd300_vgg_dct`) of Deguerre, Chatelain
and Gasso, "Fast object detection in compressed JPEG images" (ITSC 2019),
as `ssd_300DCT` builds it (localisation_part/models/keras_ssd300_dct_j2d.py
of github.com/Shulk97/JPEG_detection_Resnet_SSD).

Y (38,38,64) through the BatchNorm `b_norm_64`, `conv1_1_dct_256` (3x3, 64
-> 256) and VGG16's block 4 (3x3, 512 wide; conv4_3 tapped at 38x38); a 2x2
VALID max pool (38 -> 19); the BatchNorm'd CbCr (`b_norm_128`, 19,19,128)
concatenated (640 channels); block 5 (512 wide, 19x19); the SSD neck
(pool5 3x3 stride 1 SAME, fc6 3x3 at dilation 6 SAME, fc7 1x1, on 19x19:
all nine of fc6's taps read data there); the extras conv6 and conv7 (1x1,
zero pad 1, 3x3 stride 2 VALID: 19 -> 10 -> 5) and conv8 and conv9 (1x1,
3x3 VALID: 5 -> 3 -> 1); and the SSD300 head of ssd_keras on L2Norm(conv4_3),
fc7, conv6_2, conv7_2, conv8_2 and conv9_2 (8,732 anchors).  The loss is
the multibox loss plus 5e-4 x the squares of every convolution kernel (the
trunk's, the neck's, the extras' and the head's; not the BatchNorms' or the
L2Norm's scales).

Departures from the published description: the head's conf layers carry
the class count in their names (`{source}_mbox_conf_21`), as the fork's
other detectors name them, where ssd_keras names them `{source}_mbox_conf`;
the model is trained from random weights (no ImageNet-trained VGG16 is
loaded into blocks 4 and 5).  Imports nothing of the system under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import nets, ssd
# the flagship's head names, and its outputs as the harness reads them (`OUTPUTS`, `split`)
from port_bench.reference.net_ssd300_resnet_custom import HEAD_NAMES, OUTPUTS, split  # noqa: F401

ANCHORS = ssd.SSD300
CONV4 = ("conv4_1", "conv4_2", "conv4_3")
CONV5 = ("conv5_1", "conv5_2", "conv5_3")
# extra block idx: (1x1 width, 3x3 width, stride of the 3x3; stride 2 is zero-padded first)
EXTRAS = {6: (256, 512, 2), 7: (128, 256, 2), 8: (128, 256, 1), 9: (128, 256, 1)}
HEAD_WIDTHS = (512, 1024, 512, 256, 256, 256)
L2_PREFIXES = ("conv1_1_dct", "conv4_", "conv5_", "fc6", "fc7", "conv6_", "conv7_", "conv8_",
               "conv9_", "head.")


def layers(n_classes: int) -> list:
    out = [("bn", "b_norm_64", (64,)), ("bn", "b_norm_128", (128,)),
           ("conv", "conv1_1_dct_256", (256, 64, 3, 3))]
    c = 256
    for name in CONV4:
        out.append(("conv", name, (512, c, 3, 3)))
        c = 512
    c += 128
    for name in CONV5:
        out.append(("conv", name, (512, c, 3, 3)))
        c = 512
    out += [("conv", "fc6", (1024, c, 3, 3)), ("conv", "fc7", (1024, 1024, 1, 1))]
    c = 1024
    for idx, (n1, n2, _) in EXTRAS.items():
        out += [("conv", f"conv{idx}_1", (n1, c, 1, 1)), ("conv", f"conv{idx}_2", (n2, n1, 3, 3))]
        c = n2
    out.append(("l2norm", "conv4_3_norm", (512,)))
    n_total = n_classes + 1
    for name, width, boxes in zip(HEAD_NAMES, HEAD_WIDTHS, ANCHORS.boxes()):
        out.append(("conv", f"head.{name}_mbox_conf_{n_total}", (boxes * n_total, width, 3, 3)))
        out.append(("conv", f"head.{name}_mbox_loc", (boxes * 4, width, 3, 3)))
    return out


def _relu_convs(net: nets.Net, x, names):
    for name in names:
        x = F.relu(net.conv(x, name))
    return x


def forward(net: nets.Net, y, cbcr, n_classes: int, checkpoint: bool = False) -> tuple:
    """(softmax scores (B, n_anchors, n_classes + 1), box offsets
    (B, n_anchors, 4)), float32.  Nothing is recomputed in the backward
    pass (`checkpoint` is not read): a batch of 512 saves ~26 GB of float32
    activations and peaks at 46.5 GB on an 80 GB H100 once the program is
    freed."""
    y, cbcr = y.to(net.prec.dtype), cbcr.to(net.prec.dtype)
    x = _relu_convs(net, net.bn(y, "b_norm_64"), ("conv1_1_dct_256", *CONV4))
    conv4_3 = x
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)  # 2x2 VALID: 38 -> 19
    x = _relu_convs(net, torch.cat([x, net.bn(cbcr, "b_norm_128")], -1), CONV5)
    # pool5: 3x3 stride-1 SAME max pool
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    x = F.relu(net.conv(x, "fc6", dilation=6))  # dilated 3x3 SAME
    maps = [F.relu(net.conv(x, "fc7"))]
    for idx, (_, _, stride) in EXTRAS.items():
        x = F.relu(net.conv(maps[-1], f"conv{idx}_1"))
        if stride == 2:
            x = F.pad(x, (0, 0, 1, 1, 1, 1))
        maps.append(F.relu(net.conv(x, f"conv{idx}_2", stride, "VALID")))
    sources = (net.l2norm(conv4_3, "conv4_3_norm"), *maps)
    n_total = n_classes + 1
    confs, locs = [], []
    for name, src in zip(HEAD_NAMES, sources):
        b = src.shape[0]
        confs.append(net.conv(src, f"head.{name}_mbox_conf_{n_total}").reshape(b, -1, n_total))
        locs.append(net.conv(src, f"head.{name}_mbox_loc").reshape(b, -1, 4))
    scores = torch.softmax(torch.cat(confs, 1).float(), -1)
    return scores, torch.cat(locs, 1).float()


def loss(P: dict, outputs: tuple, batch: dict, hyper: dict):
    scores, offsets = outputs
    total = ssd.loss(batch["targets"].float(), scores, offsets)
    reg = sum(P[k].float().square().sum() for k in P
              if k.endswith(".weight") and P[k].dim() == 4 and k.startswith(L2_PREFIXES))
    return total + hyper["l2"] * reg
