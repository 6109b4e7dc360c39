"""Conv / BatchNorm / pooling layers with Keras defaults, on NHWC tensors.

Counterpart of the JAX package's `models/layers.py`:
  * BatchNormalization: epsilon 1e-3; Keras momentum 0.99 is torch's 0.01.
  * Conv2D and pooling 'same' padding == TF 'SAME': `same_pads` from the
    input's size, the odd row/column on the high side (max pooling pads
    with -inf, as `lax.reduce_window` does).
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

`Dropout` is flax's `nn.Dropout` as the port runs every random op: a host
sampler (`dropout_mask`, a bool mask drawn from a CPU `torch.Generator`)
and a deterministic apply, so the card and the CPU take the same step.  A
train-mode forward through it reads its generator from `dropout_rng()`, a
context manager the trainer opens around the forward.

`running_stats_frozen()` makes train-mode BatchNorm normalise with the batch
statistics without moving its running statistics: the recompute of a
checkpointed (`remat`) branch runs under it, so a branch's statistics move
once a step, as in the JAX package, where the recompute is a pure function.

Inside `parallel.data_parallel(mesh)` with more than one data rank,
train-mode BatchNorm normalises with the statistics of the global batch and
`Dropout` keeps the data index's rows of a mask drawn for the global batch,
so the ranks compute what one process computes on the global batch
(`parallel/mesh.py`).  A `Conv`, `ConvTranspose` or `Dense` whose kernel
`parallel.shard_parameters` sharded over the model axis (its `model_shard`)
computes its output slice and gathers the model group's (`column_parallel`).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.ops.batch_norm import batch_norm_train
from jpeg_detection_resnet_ssd_torch.ops.conv_grad import conv3x3_same_wgrad
from jpeg_detection_resnet_ssd_torch.parallel.mesh import (
    ModelShard,
    active_mesh,
    copy_to_model_group,
    gather_from_model_group,
    shard_batch,
)

BN_EPSILON = 1e-3
BN_MOMENTUM = 0.01  # Keras momentum 0.99

# flax's variance_scaling(..., "truncated_normal") divides by the stddev of a
# unit normal truncated at +-2 so that the truncated draw has the target std.
_TRUNC_STD = 0.87962566103423978


_WGRAD_KERNEL_ENABLED = False
_STATS_FROZEN = False
_DROPOUT_GENERATOR: torch.Generator | None = None


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


@contextlib.contextmanager
def running_stats_frozen():
    """Inside the block, train-mode BatchNorm leaves its running statistics
    and step counter as they are."""
    global _STATS_FROZEN
    prev, _STATS_FROZEN = _STATS_FROZEN, True
    try:
        yield
    finally:
        _STATS_FROZEN = prev


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator | None):
    """Inside the block, train-mode `Dropout` draws its masks from
    `generator` (a CPU generator), in the order the forward reaches them."""
    global _DROPOUT_GENERATOR
    prev, _DROPOUT_GENERATOR = _DROPOUT_GENERATOR, generator
    try:
        yield
    finally:
        _DROPOUT_GENERATOR = prev


def conv3x3_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """3x3 stride-1 SAME conv of NHWC `x` with an OIHW `weight` and `bias`,
    both already in x's dtype.  With the switch on, the filter gradient comes
    from the CUDA kernel and the bias stays outside the Function, as in the
    JAX package."""
    if _WGRAD_KERNEL_ENABLED:
        y = conv3x3_same_wgrad(x, weight)
        return y if bias is None else y + bias
    return nchw_to_nhwc(F.conv2d(nhwc_to_nchw(x), weight, bias, 1, 1))


def column_parallel(layer: nn.Module, x: torch.Tensor, fn) -> torch.Tensor:
    """`fn(x, bias)` of a layer with a `bias` (None or a Parameter, cast to
    x's dtype).  On a layer sharded over the model axis (`layer.model_shard`)
    `fn` computes the rank's output slice from its weight slice, and the
    whole output is `gather(fn(copy(x), None)) + bias` (`parallel/mesh.py`)."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    shard = layer.model_shard
    if shard is None:
        return fn(x, bias)
    y = gather_from_model_group(fn(copy_to_model_group(x, shard), None), shard)
    return y if bias is None else y + bias


def _trunc_normal_(weight: torch.Tensor, scale: float, fan_in: int, generator) -> torch.Tensor:
    """flax's variance_scaling(scale, "fan_in", "truncated_normal")."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def he_normal_(weight: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """In-place he_normal init of an OIHW conv kernel (fan_in = I*H*W)."""
    return _trunc_normal_(weight, 2.0, weight[0].numel(), generator)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def same_pads(size: int, kernel: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """TF SAME padding (low, high) of one spatial axis of `size`: the output
    has ceil(size / stride) positions, the odd one of the padding goes on
    the high side (300 -> 38 under an 8x8 stride-8 kernel pads (2, 2))."""
    total = max((-(-size // stride) - 1) * stride + (kernel - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """Keras-flavoured Conv2D on NHWC: he_normal kernel, zero bias.

    SAME padding is `same_pads` of the input's size, at any stride.  The
    kernel is stored OIHW, torch's layout (the JAX package stores HWIO;
    `compat.flax_bridge` transposes)."""

    model_shard: ModelShard | None = None

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
            # (low, high); at stride > 1 it depends on the input's size (None)
            self.pad = same_pads(1, kernel, 1, dilation) if strides == 1 else None
        elif padding == "VALID":
            self.pad = (0, 0)
        else:
            raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
        self.kernel = kernel
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
        return column_parallel(self, x, self._conv)

    def _conv(self, x: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
        if self.wgrad_eligible:
            return conv3x3_same(x, self.weight.to(x.dtype), bias)
        if self.pad is None:
            args = (self.kernel, self.stride, self.dilation)
            (top, bottom), (left, right) = same_pads(x.shape[1], *args), same_pads(x.shape[2], *args)
        else:
            (top, bottom), (left, right) = self.pad, self.pad
        pad = (top, left)
        if top != bottom or left != right:  # the odd row/column on the high side
            x = F.pad(x, (0, 0, left, right, top, bottom))
            pad = 0
        y = F.conv2d(
            nhwc_to_nchw(x), self.weight.to(x.dtype), bias,
            self.stride, pad, self.dilation,
        )
        return nchw_to_nhwc(y)


class ConvTranspose(nn.Module):
    """flax's `nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="VALID")` on NHWC, with flax's default `transpose_kernel=False`
    (k >= s): he_normal kernel (fan_in = k*k*in), zero bias.

    flax's op correlates the stride-dilated input with the kernel as it is,
    which is the gradient-of-a-convolution transpose that
    `F.conv_transpose2d` computes with the kernel flipped in both spatial
    axes: for k = s = 2, output row 2i + a takes x[i] * kernel[1 - a].  The
    weight is stored in torch's (in, out, k, k) layout, already flipped;
    `compat.flax_bridge` flips and transposes flax's (k, k, in, out)."""

    model_shard: ModelShard | None = None

    def __init__(self, in_features: int, features: int, kernel: int = 2, strides: int = 2,
                 padding: str = "VALID", generator: torch.Generator | None = None):
        super().__init__()
        if padding != "VALID" or kernel < strides:
            raise NotImplementedError("ConvTranspose is ported for VALID padding and kernel >= strides")
        self.stride = strides
        self.weight = nn.Parameter(_trunc_normal_(
            torch.empty(in_features, features, kernel, kernel), 2.0, kernel * kernel * in_features,
            generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(self, x, lambda x, bias: nchw_to_nhwc(F.conv_transpose2d(
            nhwc_to_nchw(x), self.weight.to(x.dtype), bias, self.stride)))


class Dense(nn.Module):
    """flax's `nn.Dense`: lecun_normal kernel (truncated, fan_in = in), zero
    bias.  The weight is torch's (out, in); flax's kernel is (in, out)."""

    model_shard: ModelShard | None = None

    def __init__(self, in_features: int, features: int, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(_trunc_normal_(
            torch.empty(features, in_features), 1.0, in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(self, x, lambda x, bias: F.linear(x, self.weight.to(x.dtype), bias))


def dropout_mask(shape, keep_prob: float, generator: torch.Generator) -> torch.Tensor:
    """The host half of `Dropout`: a CPU bool mask, True with probability
    `keep_prob` (uniform draws below it)."""
    return torch.rand(shape, generator=generator) < keep_prob


class Dropout(nn.Module):
    """flax's `nn.Dropout(rate)`: identity in eval mode; in train mode
    `where(mask, x / keep_prob, 0)` with a mask from `dropout_mask` on the
    generator of `dropout_rng()`, which must be open."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if _DROPOUT_GENERATOR is None:
            raise RuntimeError("a train-mode Dropout needs a generator: run the forward "
                               "inside models.layers.dropout_rng(generator)")
        keep_prob = 1.0 - self.rate
        mesh = active_mesh()
        if mesh is None:
            mask = dropout_mask(tuple(x.shape), keep_prob, _DROPOUT_GENERATOR)
        else:  # the data index's rows of the global batch's mask
            shape = (x.shape[0] * mesh.n_data, *x.shape[1:])
            mask = shard_batch(dropout_mask(shape, keep_prob, _DROPOUT_GENERATOR), mesh)
        mask = mask.to(x.device)
        return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm(nn.BatchNorm2d):
    """Keras-default BatchNormalization on NHWC (eps 1e-3, momentum 0.99).

    Train mode is flax's `BatchNorm(use_running_average=False)`
    (`ops.batch_norm.batch_norm_train`): statistics in at least float32
    over (B, H, W), the variance as E[x^2] - E[x]^2 clipped at 0 (biased),
    `y = (x - mean) * (rsqrt(var + eps) * scale) + bias`, and the running
    statistics move by `running = 0.99 * running + 0.01 * batch` with that
    same biased variance (torch's own layer would use the unbiased one),
    except under `running_stats_frozen()`.  `momentum=None` keeps torch's
    cumulative average (factor 1 / num_batches_tracked).  On a CUDA input
    it runs on the CUDA kernels of `ops/csrc/batch_norm.cu`, elsewhere on
    the plain version.  Eval mode normalises with the running statistics.
    Both return the input's dtype.

    Inside `parallel.data_parallel` with more than one data rank the
    train-mode statistics are the global batch's: the sums of x and x^2 and
    the row count are all-reduced over the data group (and, backward, the
    sums that the input's gradient takes from them), so the gradient flows
    through them, and every rank moves its running statistics by the same
    values."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPSILON, momentum=BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return nchw_to_nhwc(super().forward(nhwc_to_nchw(x)))
        return batch_norm_train(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.num_batches_tracked, self.momentum, self.eps, update=not _STATS_FROZEN,
            mesh=active_mesh())


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
    """Max pooling on NHWC.  SAME pads `same_pads` of the input's size with
    -inf, as `lax.reduce_window` does (75 -> 38 at window 2, stride 2 pads
    (0, 1))."""
    pad = 0
    if padding == "SAME":
        (top, bottom), (left, right) = same_pads(x.shape[1], window, strides), same_pads(
            x.shape[2], window, strides)
        if top == bottom and left == right and 2 * top <= window:
            pad = (top, left)  # max_pool2d pads with -inf itself
        else:
            x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    return nchw_to_nhwc(F.max_pool2d(nhwc_to_nchw(x), window, strides, pad))


def relu_convs(owner: nn.Module, names, x: torch.Tensor) -> torch.Tensor:
    """relu(conv(x)) through `owner`'s layers `names`, in order."""
    for name in names:
        x = F.relu(owner.get_submodule(name)(x))
    return x


def zero_pad2d(x: torch.Tensor, pad: int | tuple = 1) -> torch.Tensor:
    """Keras ZeroPadding2D on NHWC tensors: `pad` or ((top, bottom), (left, right))."""
    if isinstance(pad, int):
        ph = pw = (pad, pad)
    else:
        ph, pw = pad
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Keras UpSampling2D() — nearest-neighbour 2x on NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
