"""Filter gradient of 3x3 stride-1 SAME convolutions: the CUDA kernel, its
plain PyTorch version, the launch counter and the autograd Function.

Counterpart of the JAX package's `ops/pallas_conv_grad.py`:

  conv3x3_filter_grad             kernel on a CUDA tensor, plain version on a
                                  CPU tensor (`conv3x3_filter_grad` there)
  conv3x3_filter_grad_reference   the nine-tap matmuls
                                  (`conv3x3_filter_grad_xla_dots` there)
  conv3x3_same_wgrad              the conv whose filter gradient is the
                                  kernel (`conv3x3_same_pallas_wgrad` there)

    dW[kh, kw, c, k] = sum_{b,y,x} Xpad[b, y+kh, x+kw, c] * dY[b, y, x, k]

`x` (B, H, W, C) and `dy` (B, H, W, K) are NHWC and both float32 or both
bfloat16; dW is (3, 3, C, K) float32, accumulated in float32 (a product of
two bf16 values is exact in float32).  There is no fallback from the kernel
to the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from jpeg_detection_resnet_ssd_torch.ops import _build

# Kernel launches since the last reset; only `conv3x3_filter_grad` adds to
# it, and only where it launches the kernel.
LAUNCHES = 0
# Copies the wrapper made because autograd handed it `x` or `dy` in another
# layout than NHWC-contiguous.
LAYOUT_COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_filter_grad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Nine [B*H*W, C]^T x [B*H*W, K] matmuls on shifted slices of the
    zero-padded input, in float32."""
    b, h, w, c = x.shape
    k = dy.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    dyf = dy.float().reshape(b * h * w, k)
    taps = [
        xp[:, kh:kh + h, kw:kw + w, :].reshape(b * h * w, c).T @ dyf
        for kh in range(3)
        for kw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, c, k)


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.device != dy.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.dtype != dy.dtype or x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"conv3x3_filter_grad takes float32 or bfloat16 x and dy of one dtype, "
            f"got {x.dtype} and {dy.dtype}"
        )
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(
            f"x (B,H,W,C) and dy (B,H,W,K) must agree, got {tuple(x.shape)} and {tuple(dy.shape)}"
        )


def _nhwc_contiguous(t: torch.Tensor) -> torch.Tensor:
    global LAYOUT_COPIES
    if t.is_contiguous():
        return t
    LAYOUT_COPIES += 1
    return t.contiguous()


def conv3x3_filter_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (3, 3, C, K) float32 of a 3x3 stride-1 SAME NHWC conv.

    On a CUDA tensor this launches the hand-written kernel on the current
    stream (plus, when it splits the B*H*W sum, a second kernel that adds
    the partial sums in a fixed order); on a CPU tensor it runs
    `conv3x3_filter_grad_reference`."""
    _check(x, dy)
    if x.device.type == "cpu":
        return conv3x3_filter_grad_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_filter_grad runs on cuda or cpu, got {x.device}")
    x, dy = _nhwc_contiguous(x), _nhwc_contiguous(dy)
    b, h, w, c = x.shape
    k = dy.shape[-1]
    out = torch.empty((3, 3, c, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _library()
    splits = lib.conv3x3_wgrad_splits(b, h, w, c, k)
    work = (torch.empty((splits, 3, 3, c, k), dtype=torch.float32, device=x.device)
            if splits > 1 else out)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), work.data_ptr(), out.data_ptr(),
            b, h, w, c, k, splits, _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


class _Conv3x3Wgrad(torch.autograd.Function):
    """3x3 stride-1 SAME conv on NHWC `x` with an OIHW `weight` (already in
    x's dtype).  Forward and input gradient are the library's convolution;
    the filter gradient is `conv3x3_filter_grad`, returned in the weight's
    dtype (bf16 compute rounds dW to bf16, as the JAX package's does)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x.permute(0, 3, 1, 2), weight, None, 1, 1).permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.ops.aten.convolution_backward(
                dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight, None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False],
            )[0].permute(0, 2, 3, 1)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_filter_grad(x, dy).permute(3, 2, 0, 1).to(weight.dtype)
        return dx, dw


def conv3x3_same_wgrad(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x OIHW (K, C, 3, 3) -> (B, H, W, K), no bias."""
    if tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3_same_wgrad takes a 3x3 kernel, got {tuple(weight.shape)}")
    return _Conv3x3Wgrad.apply(x, weight)


def _library() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wgrad")
    # Pointers and the stream as c_void_p: left undeclared, ctypes would pass
    # them as 32-bit ints and cut them.
    lib.conv3x3_wgrad.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.conv3x3_wgrad.restype = ctypes.c_int
    lib.conv3x3_wgrad_splits.argtypes = [ctypes.c_int] * 5
    lib.conv3x3_wgrad_splits.restype = ctypes.c_int
    return lib
