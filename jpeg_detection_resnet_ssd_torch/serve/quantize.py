"""Post-training int8 quantization for the serving path.

Counterpart of the JAX package's `serve/quantize.py`, the standard
post-training scheme:

  * weights: symmetric per-output-channel int8
    (`s_w[oc] = max|W[oc, ...]| / 127`);
  * activations: symmetric per-tensor int8 with STATIC scales from a
    max-calibration pass over representative batches;
  * conv: int8 x int8 -> int32 accumulation, then one rescale
    `acc * (s_x * s_w) + bias`.

The JAX package swaps each conv at trace time through flax's method
interception; the port swaps modules instead: `make_quantized_apply` returns
an eval copy of the model in which every quantized conv is a
`QuantizedConv` holding only its int8 weight, `s_w`, `s_x` and bias, so an
exported artifact carries int8 weights.  Convs whose dotted path matches a
`skip` pattern stay float: by default the raw-DCT input convs and anything
under the SSD head (whose conf/loc convs `_SSDHead` runs from their weights
without calling the conv modules, so they are never calibrated either, as
in the JAX package).

The int8 conv is an im2col of the int8 input in HWIO tap order (the float
conv's own SAME/VALID padding, stride and dilation) and one
`torch._int_mm`, the library's int8 matrix product with int32 accumulation:
XLA's own code in the JAX package, not a TPU kernel.  `torch._int_mm` on the
card takes M > 16 rows and K, N multiples of 8; zero rows and columns meet
that and leave the int32 result exact.
"""

from __future__ import annotations

import copy
import re
from typing import Iterable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from jpeg_detection_resnet_ssd_torch.models.layers import Conv, same_pads
from jpeg_detection_resnet_ssd_torch.models.ssd import _FC6CenterTap

# Layers where int8 error is disproportionate: the stem convs that consume
# raw DCT coefficients and the detection heads (dotted module paths).
DEFAULT_SKIP = (r"conv1_1_dct", r"head\..*", r"deconv_c[br]")

# The module classes the quantizer treats as a conv.  `_FC6CenterTap` owns a
# conv-shaped (weight, bias) pair and applies only the weight's center tap
# (exact for its <= dilation maps), so it calibrates and quantizes like the
# dilated conv it replaced.  `ConvTranspose` and `Dense` are not conv-like,
# as in the JAX package.
CONV_LIKE = (Conv, _FC6CenterTap)

# torch._int_mm on the card: M > 16, K and N multiples of 8.
_MIN_ROWS = 17
_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def calibrate_activation_scales(
    module: nn.Module,
    batches: Iterable,
) -> dict[str, float]:
    """Max-calibration: run `batches` through `module` in eval mode, record
    each conv's peak |input|, return `{conv_path: int8 scale}`.

    Forward pre-hooks on every `CONV_LIKE` module read its input (one host
    readback per conv per batch); a handful of batches is enough for max
    calibration.  `module`'s train/eval mode is restored.
    """
    peaks: dict[str, float] = {}

    def record(path):
        def hook(_mod, args):
            peak = float(args[0].abs().amax())
            peaks[path] = max(peaks.get(path, 0.0), peak)
        return hook

    hooks = [m.register_forward_pre_hook(record(p))
             for p, m in module.named_modules() if isinstance(m, CONV_LIKE)]
    training = module.training
    module.eval()
    try:
        with torch.no_grad():
            for batch in batches:
                module(batch)
    finally:
        for h in hooks:
            h.remove()
        module.train(training)
    return {p: max(m, 1e-8) / 127.0 for p, m in peaks.items()}


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """`x / d` rounded as IEEE division (a CUDA tensor divided by a Python
    number is multiplied by its reciprocal instead)."""
    return x / torch.as_tensor(d, dtype=torch.float32, device=x.device)


def quantize_conv_weights(
    module: nn.Module,
    conv_paths: Iterable[str],
    skip: Sequence[str] = DEFAULT_SKIP,
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Per-output-channel int8 for the weight of every conv in `conv_paths`
    (from calibration) whose path matches no `skip` pattern.

    Returns `{path: (w_q int8 (cout, cin, kh, kw), s_w float32 (cout,))}`.
    """
    skip_res = [re.compile(s) for s in skip]
    out = {}
    for path in conv_paths:
        if any(r.search(path) for r in skip_res):
            continue
        weight = module.get_submodule(path).weight.detach().float()
        s_w = _div(torch.clamp_min(weight.abs().amax(dim=(1, 2, 3)), 1e-8), 127.0)
        w_q = torch.clamp(torch.round(weight / s_w[:, None, None, None]), -127, 127)
        out[path] = (w_q.to(torch.int8), s_w)
    return out


class QuantizedConv(nn.Module):
    """A conv (or `_FC6CenterTap`) as int8 x int8 -> int32 + rescale.

    Holds the int8 weight as an (N, K) matrix (N = output channels and K =
    kh * kw * cin in HWIO tap order, each zero-padded to a multiple of 8),
    the float32 `s_x` and `s_x * s_w`, and the float bias; no float weight.
    Takes and returns NHWC tensors; the output has the input's dtype.
    """

    def __init__(self, conv: nn.Module, w_q: torch.Tensor, s_w: torch.Tensor, s_x: float):
        super().__init__()
        if isinstance(conv, _FC6CenterTap):  # stride-1 SAME on the center tap
            w_q = w_q[:, :, 1:2, 1:2]
            self.stride, self.dilation, self.pad = 1, 1, (0, 0)
        else:
            self.stride, self.dilation, self.pad = conv.stride, conv.dilation, conv.pad
        cout, cin, kh, kw = w_q.shape
        self.kernel, self.features, self.k = kh, cout, kh * kw * cin
        matrix = w_q.permute(0, 2, 3, 1).reshape(cout, self.k)
        matrix = F.pad(matrix, (0, _round_up(self.k, _ALIGN) - self.k,
                                0, _round_up(cout, _ALIGN) - cout))
        self.register_buffer("weight_q", matrix.contiguous())
        s_x32 = torch.tensor(s_x, dtype=torch.float32, device=s_w.device)
        self.register_buffer("s_x", s_x32)
        self.register_buffer("rescale", s_x32 * s_w)
        bias = None if conv.bias is None else conv.bias.detach().float().clone()
        self.register_buffer("bias", bias)

    def _pads(self, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        if self.pad is None:  # SAME at stride > 1: from the input's size
            args = (self.kernel, self.stride, self.dilation)
            return same_pads(h, *args), same_pads(w, *args)
        return self.pad, self.pad

    def accumulate(self, x: torch.Tensor) -> torch.Tensor:
        """The int32 accumulators (B, Ho, Wo, cout) of the int8 conv of `x`."""
        x_q = torch.clamp(torch.round(x.float() / self.s_x), -127, 127).to(torch.int8)
        batch, h, w, _ = x_q.shape
        (top, bottom), (left, right) = self._pads(h, w)
        if top or bottom or left or right:
            x_q = F.pad(x_q, (0, 0, left, right, top, bottom))
        s, d, span = self.stride, self.dilation, (self.kernel - 1) * self.dilation + 1
        ho = (h + top + bottom - span) // s + 1
        wo = (w + left + right - span) // s + 1
        taps = [x_q[:, i * d: i * d + (ho - 1) * s + 1: s, j * d: j * d + (wo - 1) * s + 1: s]
                for i in range(self.kernel) for j in range(self.kernel)]
        cols = (taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)).reshape(-1, self.k)
        rows = cols.shape[0]
        k_pad = self.weight_q.shape[1]
        # The padding rows make M > 16 at any batch without a branch on it.
        cols = F.pad(cols, (0, k_pad - self.k, 0, _MIN_ROWS - 1))
        acc = torch._int_mm(cols, self.weight_q.t())[:rows, : self.features]
        return acc.reshape(batch, ho, wo, self.features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.accumulate(x).float() * self.rescale
        if self.bias is not None:
            out = out + self.bias
        return out.to(x.dtype)


def make_quantized_apply(
    module: nn.Module,
    act_scales: dict[str, float],
    qweights: dict[str, tuple[torch.Tensor, torch.Tensor]],
) -> nn.Module:
    """An eval copy of `module` with every conv of `qweights` replaced by a
    `QuantizedConv`; call it as the model (export-ready, see
    `serve.export.build_serving_fn(..., fold_bn=False)`)."""
    out = copy.deepcopy(module).eval().requires_grad_(False)
    for path, (w_q, s_w) in qweights.items():
        parent, _, name = path.rpartition(".")
        owner = out.get_submodule(parent) if parent else out
        setattr(owner, name, QuantizedConv(getattr(owner, name), w_q, s_w, act_scales[path]))
    return out


def quantize_for_serving(
    module: nn.Module,
    calibration_batches: Iterable,
    skip: Sequence[str] = DEFAULT_SKIP,
    fold_bn: bool = True,
) -> tuple[nn.Module, dict]:
    """Fold BatchNorm, calibrate, quantize, build.  Returns `(model, info)`;
    `info` reports which convs were quantized and which kept float."""
    from jpeg_detection_resnet_ssd_torch.serve.folding import fold_batch_norm

    if fold_bn:
        module = fold_batch_norm(module)
    batches = list(calibration_batches)
    act_scales = calibrate_activation_scales(module, batches)
    qweights = quantize_conv_weights(module, act_scales, skip=skip)
    model = make_quantized_apply(module, act_scales, qweights)
    info = {
        "quantized": sorted(qweights),
        "kept_float": sorted(set(act_scales) - set(qweights)),
        "n_calibration_batches": len(batches),
    }
    return model, info
