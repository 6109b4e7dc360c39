"""The late-concat-RFA-thinner DCT ResNet-50 classifier (Gueguen et al.,
NeurIPS 2018): the late-concat trunk under `stem.`, stage 5, global
average pooling and the `fc1000` dense layer; softmax cross-entropy."""

from __future__ import annotations

import torch

from port_bench.reference import nets

ARCH = nets.THINNER
OUTPUTS = ("logit",)  # names of forward's outputs, in order


def layers(n_classes: int) -> list:
    out, c = nets.trunk_params(ARCH, "stem.")
    p, c = nets.blocks_params("", c, nets.STAGE5)
    return out + p + [("dense", "fc1000", (n_classes, c))]


def forward(net: nets.Net, y, cbcr, n_classes: int, checkpoint: bool = False) -> tuple:
    """(logits (B, n_classes) float32,)"""
    _, _, x = net.trunk(ARCH, y, cbcr, "stem.", checkpoint)
    x = net.blocks(x, nets.STAGE5, "", checkpoint)
    return (net.dense(x.mean(dim=(1, 2)), "fc1000").float(),)


def split(out, n_classes: int) -> tuple:
    """The program's logits."""
    return (out,)


def loss(P: dict, outputs: tuple, batch: dict, hyper: dict):
    """Mean softmax cross-entropy of the batch's labels."""
    logp = torch.log_softmax(outputs[0].float(), -1)
    return -logp.gather(1, batch["labels"].long()[:, None]).mean()
