"""Conv / BatchNorm / pooling layers with Keras defaults, on NHWC tensors.

Counterpart of the JAX package's `models/layers.py`:
  * BatchNormalization: epsilon 1e-3; Keras momentum 0.99 is torch's 0.01.
  * Conv2D 'same' padding == TF 'SAME' at stride 1 (for an even kernel the
    extra row/column goes on the high side).
  * he_normal == truncated normal (at +-2 sigma) with stddev sqrt(2/fan_in),
    drawn from an explicit `torch.Generator`.

Every layer takes and returns NHWC tensors, the JAX package's contract.
Inside, an NHWC tensor viewed as NCHW (`permute(0, 3, 1, 2)`, no copy) is
torch's channels_last layout, which cuDNN convolves and normalises without a
transpose, and the result is viewed back as NHWC.

`dtype` has the flax meaning: parameters stay float32 and a layer computes
in its input's dtype (weights are cast on the fly); the model casts its
inputs to its compute dtype once, at the entry.

`pallas_wgrad()` is the JAX package's process-wide switch of the same name,
here a context manager: while it is on, `conv3x3_same` (every `Conv` that is
3x3, stride 1, SAME and dilation 1, and the SSD head's fused conf+loc conv)
runs through `ops.conv_grad.conv3x3_same_wgrad`, whose filter gradient is
the CUDA kernel `ops/csrc/conv3x3_wgrad.cu`.  The forward, the input
gradient and the parameter names are unchanged.  Unlike the JAX switch (read
at trace time), this one is read at every forward call.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.ops.conv_grad import conv3x3_same_wgrad

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.01  # Keras momentum 0.99

# flax's variance_scaling(..., "truncated_normal") divides by the stddev of a
# unit normal truncated at +-2 so that the truncated draw has the target std.
_TRUNC_STD = 0.87962566103423978


_WGRAD_KERNEL_ENABLED = False


def pallas_wgrad_enabled() -> bool:
    return _WGRAD_KERNEL_ENABLED


@contextlib.contextmanager
def pallas_wgrad(enabled: bool = True):
    """Route eligible 3x3 convs' filter gradient through the CUDA kernel
    (or, with `enabled=False`, through the library) inside the block."""
    global _WGRAD_KERNEL_ENABLED
    prev, _WGRAD_KERNEL_ENABLED = _WGRAD_KERNEL_ENABLED, bool(enabled)
    try:
        yield
    finally:
        _WGRAD_KERNEL_ENABLED = prev


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """3x3 stride-1 SAME conv of NHWC `x` with an OIHW `weight` and `bias`,
    both already in x's dtype.  With the switch on, the filter gradient comes
    from the CUDA kernel and the bias stays outside the Function, as in the
    JAX package."""
    if _WGRAD_KERNEL_ENABLED:
        y = conv3x3_same_wgrad(x, weight)
        return y if bias is None else y + bias
    return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x), weight, bias, 1, 1))


def he_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """In-place he_normal init of an OIHW conv kernel (fan_in = I*H*W)."""
    fan_in = weight.shape[1] * weight.shape[2] * weight.shape[3]
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """Keras-flavoured Conv2D on NHWC: he_normal kernel, zero bias.

    The kernel is stored OIHW, torch's layout (the JAX package stores HWIO;
    `compat.flax_bridge` transposes)."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 3,
        strides: int = 1,
        padding: str = "SAME",
        dilation: int = 1,
        use_bias: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if padding == "SAME":
            if strides != 1:
                raise NotImplementedError("SAME padding is ported for stride 1 only")
            total = dilation * (kernel - 1)
            self.pad = (total // 2, total - total // 2)  # (low, high)
        elif padding == "VALID":
            self.pad = (0, 0)
        else:
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.stride = strides
        self.dilation = dilation
        self.wgrad_eligible = (kernel, strides, padding, dilation) == (3, 1, "SAME", 1)
        self.weight = nn.Parameter(
            he_normal_(torch.empty(features, in_features, kernel, kernel), generator)
        )
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.wgrad_eligible:
            return conv3x3_same(x, self.weight.to(x.dtype), bias)
        lo, hi = self.pad
        if lo != hi:  # TF SAME puts the odd row/column on the high side
            x = F.pad(x, (0, 0, lo, hi, lo, hi))
            lo = 0
        y = F.conv2d(
            nhwc_to_nchw(x), self.weight.to(x.dtype), bias,
            self.stride, lo, self.dilation,
        )
        return nchw_to_nhwc(y)


class BatchNorm(nn.BatchNorm2d):
    """Keras-default BatchNormalization on NHWC (eps 1e-3, momentum 0.99).

    Train mode is flax's `BatchNorm(use_running_average=False)`: statistics
    in at least float32 over (B, H, W), the variance as E[x^2] - E[x]^2
    clipped at 0 (biased), `y = (x - mean) * (rsqrt(var + eps) * scale) +
    bias`, and the running statistics move by `running = 0.99 * running +
    0.01 * batch` with that same biased variance (torch's own layer would
    use the unbiased one).  `momentum=None` keeps torch's cumulative average (factor
    1 / num_batches_tracked).  Eval mode normalises with the running
    statistics.  Both return the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPSILON, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nchw_to_nhwc(super().forward(nhwc_to_nchw(x)))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=(0, 1, 2))
        var = torch.clamp_min(xf.square().mean(dim=(0, 1, 2)) - mean.square(), 0.0)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            factor = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                      else self.momentum)
            self.running_mean.mul_(1.0 - factor).add_(factor * mean)
            self.running_var.mul_(1.0 - factor).add_(factor * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class L2Normalization(nn.Module):
    """Channel-wise L2 normalization with a learnable per-channel scale:
    `x / sqrt(max(sum(x^2), 1e-12)) * gamma`, gamma initialised to 20
    (ParseNet-style norm on SSD's early feature taps)."""

    def __init__(self, features: int, gamma_init: float = 20.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((features,), float(gamma_init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        denom = torch.sqrt(torch.clamp_min(torch.sum(torch.square(x), dim=-1, keepdim=True), 1e-12))
        return (x / denom) * self.gamma.to(x.dtype)


def max_pool(x: torch.Tensor, window: int = 2, strides: int = 2, padding: str = "VALID") -> torch.Tensor:
    """Max pooling on NHWC.  SAME at stride 1 pads with -inf (odd windows)."""
    if padding == "SAME":
        if strides != 1 or window % 2 == 0:
            raise NotImplementedError("SAME max_pool is ported for stride 1, odd window")
        pad = window // 2
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return nchw_to_nhwc(F.max_pool2d(nhwc_to_nchw(x), window, strides, pad))


def zero_pad2d(x: torch.Tensor, pad: int | tuple = 1) -> torch.Tensor:
    """Keras ZeroPadding2D on NHWC tensors: `pad` or ((top, bottom), (left, right))."""
    if isinstance(pad, int):
        ph = pw = (pad, pad)
    else:
        ph, pw = pad
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
