"""The ResNet SSD300 of the detection fork (`ssd_custom`): the
late-concat-RFA-thinner trunk, stage 5, the pool5/fc6/fc7 neck, the
conv6/conv9 extra layers, and the SSD300 head of ssd_keras on six
sources (conv4_3, conv3_3 and conv4_6 L2-normalized, fc7, conv6_2,
conv9_2); the multibox loss plus 5e-4 x the squares of the neck, extra
and head kernels."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference import nets, ssd

ARCH = nets.THINNER
OUTPUTS = ("score", "offset")  # names of forward's outputs, in order
ANCHORS = ssd.SSD300
# the head keeps the original SSD300 layer names for weight compatibility
HEAD_NAMES = ("conv4_3_norm", "fc7", "conv6_2", "conv7_2", "conv8_2", "conv9_2")
HEAD_WIDTHS = (384, 512, 1024, 1024, 256, 256)
L2_PREFIXES = ("fc6", "fc7", "conv6_", "conv9_", "head.")


def layers(n_classes: int) -> list:
    out, c = nets.trunk_params(ARCH)
    p, c = nets.blocks_params("", c, nets.STAGE5)
    out += p
    out += [("conv", "fc6", (1024, c, 3, 3)), ("conv", "fc7", (1024, 1024, 1, 1)),
            ("conv", "conv6_1", (256, 1024, 1, 1)), ("conv", "conv6_2", (256, 256, 3, 3)),
            ("conv", "conv9_1", (128, 256, 1, 1)), ("conv", "conv9_2", (256, 128, 3, 3)),
            ("l2norm", "conv4_3_norm", (384,)), ("l2norm", "conv3_3_norm", (512,)),
            ("l2norm", "conv4_6_norm", (1024,))]
    n_total = n_classes + 1
    for name, width, boxes in zip(HEAD_NAMES, HEAD_WIDTHS, ANCHORS.boxes()):
        out.append(("conv", f"head.{name}_mbox_conf_{n_total}", (boxes * n_total, width, 3, 3)))
        out.append(("conv", f"head.{name}_mbox_loc", (boxes * 4, width, 3, 3)))
    return out


def forward(net: nets.Net, y, cbcr, n_classes: int, checkpoint: bool = False) -> tuple:
    """(softmax scores (B, n_anchors, n_classes + 1), box offsets
    (B, n_anchors, 4)), float32."""
    conv4_3, conv3_3, conv4_6 = net.trunk(ARCH, y, cbcr, "", checkpoint)
    x = net.blocks(conv4_6, nets.STAGE5, "", checkpoint)
    # pool5: 3x3 stride-1 SAME max pool
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 1, 1).permute(0, 2, 3, 1)
    x = F.relu(net.conv(x, "fc6", dilation=6))  # dilated 3x3 SAME
    fc7 = F.relu(net.conv(x, "fc7"))
    x = F.relu(net.conv(fc7, "conv6_1"))
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    conv6_2 = F.relu(net.conv(x, "conv6_2", 2, "VALID"))
    x = F.relu(net.conv(conv6_2, "conv9_1"))
    conv9_2 = F.relu(net.conv(x, "conv9_2", 1, "VALID"))
    sources = (net.l2norm(conv4_3, "conv4_3_norm"), net.l2norm(conv3_3, "conv3_3_norm"),
               net.l2norm(conv4_6, "conv4_6_norm"), fc7, conv6_2, conv9_2)
    n_total = n_classes + 1
    confs, locs = [], []
    for name, src in zip(HEAD_NAMES, sources):
        b = src.shape[0]
        confs.append(net.conv(src, f"head.{name}_mbox_conf_{n_total}").reshape(b, -1, n_total))
        locs.append(net.conv(src, f"head.{name}_mbox_loc").reshape(b, -1, 4))
    scores = torch.softmax(torch.cat(confs, 1).float(), -1)
    return scores, torch.cat(locs, 1).float()


def split(out, n_classes: int) -> tuple:
    """The program's scores and offsets: the first n_classes + 1 and the
    next 4 channels of its (B, n_anchors, ...) output."""
    n = n_classes + 1
    return out[..., :n], out[..., n:n + 4]


def loss(P: dict, outputs: tuple, batch: dict, hyper: dict):
    scores, offsets = outputs
    total = ssd.loss(batch["targets"].float(), scores, offsets)
    reg = sum(P[k].float().square().sum() for k in P
              if k.endswith(".weight") and P[k].dim() == 4 and k.startswith(L2_PREFIXES))
    return total + hyper["l2"] * reg
