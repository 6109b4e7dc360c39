"""Plain functional layers of the DCT ResNet-50 networks, and what a
configuration's reference network file gives.

Written from the published architectures (Gueguen et al., "Faster Neural
Networks Straight from JPEG", NeurIPS 2018), on NHWC tensors held in a dict
of named parameters.  It imports no code of the system under test: the
parameter names are the Keras layer names, which both sides use, so the
benchmark can hand one set of weights to both.

A configuration names its network (`"network"` in its file), and the
network is the file `reference/net_<network>.py`, which the harness finds
by that name (`core.load_cell`).  It
gives `layers(n_classes)`, the (kind, name, shape) of every layer;
`forward(net, y, cbcr, n_classes, checkpoint)`, the tuple of its outputs
(float32) through a `Net`; `split(out, n_classes)`, the same tuple cut
from the program's output tensor; and `loss(P, outputs, batch, hyper)`,
its training loss.  A detector also gives `ANCHORS`, its anchor geometry
(`ssd.Geometry`).

Every convolution, normalization and activation is one plain torch call.
`Precision` says in which dtype each layer computes: float32 for the
reference (TF32 off), and a lower one for the control, where the inputs
and weights of every convolution and dense layer are also rounded to
float8 (e4m3, one scale per tensor) before the product.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class Precision:
    """The dtype the layers compute in, and whether the operands of each
    product are first rounded to float8 e4m3 (per-tensor scale)."""

    dtype: torch.dtype = torch.float32
    fp8: bool = False


FLOAT32 = Precision()
FP8 = Precision(torch.bfloat16, True)


# --------------------------------------------------------------------------
# architecture as data
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bottleneck:
    kernel: int
    filters: tuple
    stage: int
    block: str
    stride: int | None  # None: identity block


def conv_block(kernel, filters, stage, block, stride=2):
    return Bottleneck(kernel, tuple(filters), stage, block, stride)


def id_block(kernel, filters, stage, block):
    return Bottleneck(kernel, tuple(filters), stage, block, None)


@dataclasses.dataclass(frozen=True)
class LateConcat:
    """A late-concat trunk's block lists, in execution order: the Y trunk at
    full resolution (ending at the conv4_3 tap), its stride-2 block, the
    CbCr block, stage 3 on the concat (conv3_3 tap), stage 4 (conv4_6 tap)."""

    y_trunk: tuple
    y_down: tuple
    cbcr: tuple
    stage3: tuple
    stage4: tuple


# late-concat-RFA-thinner, the trunk of the classifier and of `ssd_custom`
THINNER = LateConcat(
    y_trunk=(conv_block(1, (256, 256, 384), 1, "a2", 1),
             id_block(2, (256, 256, 384), 1, "b2"),
             id_block(3, (256, 256, 384), 1, "c2"),
             conv_block(3, (128, 128, 384), 2, "a3", 1),
             *(id_block(3, (128, 128, 384), 2, b) for b in ("b3", "c3", "d3"))),
    y_down=(conv_block(3, (256, 256, 384), 2, "a4"),),
    cbcr=(conv_block(1, (256, 256, 128), 2, "a5", 1),),
    stage3=tuple(id_block(3, (128, 128, 512), 3, b) for b in "bcd"),
    stage4=(conv_block(3, (256, 256, 1024), 4, "a"),
            *(id_block(3, (256, 256, 1024), 4, b) for b in "bcdef")))


STAGE5 = (conv_block(3, (512, 512, 2048), 5, "a"),
          *(id_block(3, (512, 512, 2048), 5, b) for b in "bc"))


def _bottleneck_params(prefix: str, c_in: int, blk: Bottleneck) -> list:
    f1, f2, f3 = blk.filters
    cn = f"{prefix}res{blk.stage}{blk.block}_branch"
    bn = f"{prefix}bn{blk.stage}{blk.block}_branch"
    out = [("conv", cn + "2a", (f1, c_in, 1, 1)), ("bn", bn + "2a", (f1,)),
           ("conv", cn + "2b", (f2, f1, blk.kernel, blk.kernel)), ("bn", bn + "2b", (f2,)),
           ("conv", cn + "2c", (f3, f2, 1, 1)), ("bn", bn + "2c", (f3,))]
    if blk.stride is not None:
        out += [("conv", cn + "1", (f3, c_in, 1, 1)), ("bn", bn + "1", (f3,))]
    return out


def blocks_params(prefix: str, c_in: int, blocks) -> tuple[list, int]:
    """Layers of `blocks` on a `c_in`-wide input, and their out width."""
    out = []
    for blk in blocks:
        out += _bottleneck_params(prefix, c_in, blk)
        c_in = blk.filters[2]
    return out, c_in


def trunk_params(arch: LateConcat, prefix: str = "") -> tuple[list, int]:
    """Layers of a late-concat trunk through stage 4, and its out width."""
    out = [("bn", prefix + "bn_y_in", (64,))]
    p, c_y = blocks_params(prefix, 64, arch.y_trunk + arch.y_down)
    out += p + [("bn", prefix + "bn_cbcr_in", (128,))]
    p, c_c = blocks_params(prefix, 128, arch.cbcr)
    out += p
    p, c = blocks_params(prefix, c_y + c_c, arch.stage3 + arch.stage4)
    return out + p, c


def state_shapes(layers: list) -> dict:
    """name -> shape of every tensor the layers hold, as state-dict keys."""
    shapes = {}
    for kind, name, shape in layers:
        if kind in ("conv", "dense"):
            shapes[name + ".weight"] = shape
            shapes[name + ".bias"] = (shape[0],)
        elif kind == "bn":
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                shapes[f"{name}.{leaf}"] = shape
        elif kind == "l2norm":
            shapes[name + ".gamma"] = shape
    return shapes


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (amax -> 448);
    the gradient passes the rounding unchanged, in x's dtype."""
    xd = x.detach()
    scale = xd.abs().amax().float().clamp_min(1e-30) / 448.0
    q = ((xd.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - xd)


class Net:
    """Functional layers over a parameter dict `P` at precision `prec`.
    `train` selects batch statistics for every BatchNorm; `stats`, when a
    dict, collects each BatchNorm's batch mean and biased variance."""

    def __init__(self, P: dict, prec: Precision = FLOAT32, train: bool = False, stats=None):
        self.P, self.prec, self.train, self.stats = P, prec, train, stats

    def _w(self, name):
        return self.P[name].to(self.prec.dtype)

    def conv(self, x, name, stride=1, padding="SAME", dilation=1):
        """NHWC conv; SAME pads (k - 1) * dilation with the odd one high."""
        w, b = self._w(name + ".weight"), self._w(name + ".bias")
        if self.prec.fp8:
            x, w = _fp8(x), _fp8(w)
        k = w.shape[-1]
        xn = x.permute(0, 3, 1, 2)
        if padding == "SAME":
            if stride != 1:
                raise ValueError("SAME is used at stride 1 only")
            total = (k - 1) * dilation
            xn = F.pad(xn, (total // 2, total - total // 2, total // 2, total - total // 2))
        y = F.conv2d(xn, w, b, stride, 0, dilation)
        return y.permute(0, 2, 3, 1)

    def dense(self, x, name):
        w, b = self._w(name + ".weight"), self._w(name + ".bias")
        if self.prec.fp8:
            x, w = _fp8(x), _fp8(w)
        return x @ w.t() + b

    def bn(self, x, name):
        xf = x.float()
        if self.train:
            mean = xf.mean(dim=(0, 1, 2))
            var = (xf - mean).square().mean(dim=(0, 1, 2))
            if self.stats is not None:
                self.stats[name] = (mean.detach(), var.detach())
        else:
            mean = self.P[name + ".running_mean"].float()
            var = self.P[name + ".running_var"].float()
        g, b = self.P[name + ".weight"].float(), self.P[name + ".bias"].float()
        return ((xf - mean) / torch.sqrt(var + BN_EPS) * g + b).to(self.prec.dtype)

    def l2norm(self, x, name):
        xf = x.float()
        n = torch.sqrt(torch.clamp_min(xf.square().sum(-1, keepdim=True), 1e-12))
        return (xf / n * self.P[name + ".gamma"].float()).to(self.prec.dtype)

    def bottleneck(self, x, blk: Bottleneck, prefix=""):
        cn = f"{prefix}res{blk.stage}{blk.block}_branch"
        bn = f"{prefix}bn{blk.stage}{blk.block}_branch"
        s = blk.stride or 1
        y = F.relu(self.bn(self.conv(x, cn + "2a", s, "VALID"), bn + "2a"))
        y = F.relu(self.bn(self.conv(y, cn + "2b"), bn + "2b"))
        y = self.bn(self.conv(y, cn + "2c", 1, "VALID"), bn + "2c")
        short = x if blk.stride is None else self.bn(self.conv(x, cn + "1", s, "VALID"), bn + "1")
        return F.relu(y + short)

    def blocks(self, x, blocks, prefix="", checkpoint=False):
        for blk in blocks:
            if checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(
                    self.bottleneck, x, blk, prefix, use_reentrant=False)
            else:
                x = self.bottleneck(x, blk, prefix)
        return x

    # ---------------------------------------------------------------------

    def trunk(self, arch: LateConcat, y, cbcr, prefix="", checkpoint=False):
        """-> (conv4_3, conv3_3, conv4_6): the Y trunk's map, stage 3's and
        stage 4's."""
        y, cbcr = y.to(self.prec.dtype), cbcr.to(self.prec.dtype)
        conv4_3 = self.blocks(self.bn(y, prefix + "bn_y_in"), arch.y_trunk, prefix, checkpoint)
        yb = self.blocks(conv4_3, arch.y_down, prefix, checkpoint)
        cb = self.blocks(self.bn(cbcr, prefix + "bn_cbcr_in"), arch.cbcr, prefix, checkpoint)
        conv3_3 = self.blocks(torch.cat([yb, cb], -1), arch.stage3, prefix, checkpoint)
        conv4_6 = self.blocks(conv3_3, arch.stage4, prefix, checkpoint)
        return conv4_3, conv3_3, conv4_6


def init_std(kind: str, shape) -> float:
    """he_normal for convolutions, lecun_normal for dense layers."""
    fan_in = math.prod(shape[1:])
    return math.sqrt((2.0 if kind == "conv" else 1.0) / fan_in)
