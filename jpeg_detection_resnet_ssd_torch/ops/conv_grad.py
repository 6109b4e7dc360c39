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

On the card, bfloat16 runs the TMA + wgmma kernel on the tiling that
`tiling_plan` chooses; float32 runs a kernel on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from jpeg_detection_resnet_ssd_torch.ops import _build

# Kernel launches since the last reset; only `conv3x3_filter_grad` adds to
# it, and only where it launches the kernel.
LAUNCHES = 0
# Copies the wrapper made because autograd handed it `x` or `dy` in another
# layout than NHWC-contiguous.
LAYOUT_COPIES = 0
# Copies the bf16 path made so that TMA can describe a tensor: channels
# padded to a multiple of 8 (16-byte rows), or a base not 16-byte aligned.
PAD_COPIES = 0

_DTYPES = (torch.float32, torch.bfloat16)


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


# The bf16 kernel's fixed geometry (ops/csrc/conv3x3_wgrad.cu).
N_TILES = (64, 104, 128, 152, 256)  # wgmma widths (k per block) it is built for
BLOCK_C = 128  # channels of x per block: two consumer warpgroups of 64
BOX_C = 64  # channels per TMA box: 128 bytes, the width of the 128-byte swizzle
MAX_STAGE_ROWS = 128  # rows of P a stage (the kernel takes up to 256)
MAX_RING = 6
SMEM_BYTES = 227 * 1024 - 1024 - 96  # a block's shared memory less alignment slack and barriers
# For choosing the split only (a model, not a measurement): one SM's share
# of the 989 TFLOP/s bf16 peak, a block's fixed cost (launch, filling the
# ring, epilogue) and HBM's rate for the workspace's write and read.
_SM_FLOPS = 989e12 / 132
_BLOCK_FIXED_S = 2e-6
_HBM_BYTES_PER_S = 3.35e12


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """How the bf16 kernel tiles dW for x (B, H, W, C) and dy (B, H, W, K).

    A stage is one TMA box of x and one of dy: `images` images x `rows` rows
    x `w_box` columns of P (`stage_rows` in all, a multiple of 16), the
    columns past W and rows past H reading zero.  A row wider than a box
    is cut into `w_groups` column groups of `w_box` columns.  The `stages`
    stages along P (image groups outer, row groups, column groups inner)
    are cut into `splits` chunks of `per_split`, added in order afterwards.
    A block owns BLOCK_C channels x `n_tile` k of one tap over one chunk,
    with a ring of `ring` stages.  x and dy are read with `c_pad` and
    `k_pad` channels (multiples of 8)."""

    c_pad: int
    k_pad: int
    w_box: int
    rows: int
    images: int
    n_tile: int
    h_groups: int
    w_groups: int
    stages: int
    per_split: int
    splits: int
    ring: int

    @property
    def stage_rows(self) -> int:
        return self.w_box * self.rows * self.images

    def stage_origin(self, u: int) -> tuple[int, int, int]:
        """(b0, y0, x0): the first image, row and column of stage `u`."""
        v, g = divmod(u, self.w_groups)
        return (v // self.h_groups) * self.images, (v % self.h_groups) * self.rows, g * self.w_box


@functools.lru_cache(maxsize=256)
def tiling_plan(b: int, h: int, w: int, c: int, k: int, sm_count: int = 132) -> WgradPlan:
    """The bf16 kernel's tiling for one problem.

    The box is the one that pads P least (a stage's fixed cost counted as 16
    rows), spanning whole rows (W to W + 15 columns) where a stage can hold
    one; a row wider than MAX_STAGE_ROWS is cut into column groups of a
    multiple of 16 columns.  The k tile is the narrowest width that holds K
    (K > 256: tiles of 256 or 128, whichever pads less); the split is the
    one that a simple model of one wave of one block per SM finishes
    first."""
    c_pad, k_pad = _cdiv(c, 8) * 8, _cdiv(k, 8) * 8
    if k_pad <= N_TILES[-1]:
        n_tile = min(n for n in N_TILES if n >= k_pad)
    else:
        n_tile = min((256, 128), key=lambda n: _cdiv(k, n) * n)
    stage_boxes = 2 + _cdiv(n_tile, BOX_C)
    best = None
    wide = range(16, MAX_STAGE_ROWS + 1, 16)
    for boxes in (range(w, w + 16), wide):  # the second only when no row fits a stage
        for w_box in boxes:
            for rows in range(1, h + 1):
                for images in range(1, 17):
                    s = w_box * rows * images
                    if s % 16 or s > MAX_STAGE_ROWS or 2 * stage_boxes * s * 128 > SMEM_BYTES:
                        continue
                    padded = _cdiv(b, images) * images * _cdiv(h, rows) * rows * _cdiv(w, w_box) * w_box
                    cost = padded * (1 + 16 / s)
                    if best is None or cost < best[0]:
                        best = (cost, w_box, rows, images)
        if best is not None:
            break
    _, w_box, rows, images = best
    s = w_box * rows * images
    h_groups, w_groups = _cdiv(h, rows), _cdiv(w, w_box)
    stages = _cdiv(b, images) * h_groups * w_groups
    tiles = 9 * _cdiv(c, BLOCK_C) * _cdiv(k, n_tile)
    stage_s = s * BLOCK_C * n_tile * 2 / _SM_FLOPS
    workspace_s = 9 * c * k * 4 * 2 / _HBM_BYTES_PER_S
    best = None
    for per in range(1, stages + 1):
        splits = _cdiv(stages, per)
        if per > 1 and _cdiv(stages, per - 1) == splits:
            continue  # the same split with a shorter last chunk
        waves = _cdiv(tiles * splits, sm_count)
        t = waves * (per * stage_s + _BLOCK_FIXED_S) + (splits * workspace_s if splits > 1 else 0.0)
        if best is None or t < best[0]:
            best = (t, per, splits)
    _, per, splits = best
    ring = min(MAX_RING, SMEM_BYTES // (stage_boxes * s * 128))
    return WgradPlan(c_pad, k_pad, w_box, rows, images, n_tile, h_groups, w_groups, stages, per,
                     splits, ring)


def _check(x: torch.Tensor, dy: torch.Tensor) -> None:
    if x.device != dy.device:
        raise ValueError(f"x on {x.device}, dy on {dy.device}")
    if x.dtype != dy.dtype or x.dtype not in _DTYPES:
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


def _tma_operand(t: torch.Tensor, channels: int) -> torch.Tensor:
    """`t` with `channels` channels (zeros appended) at a 16-byte-aligned
    base, as a TMA tensor map needs; one counted copy where it is not."""
    global PAD_COPIES
    if t.shape[-1] != channels:
        PAD_COPIES += 1
        return F.pad(t, (0, channels - t.shape[-1]))
    if t.data_ptr() % 16:
        PAD_COPIES += 1
        return t.clone()
    return t


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            plan = tiling_plan(b, h, w, c, k, _sm_count(torch.cuda.current_device()))
            x, dy = _tma_operand(x, plan.c_pad), _tma_operand(dy, plan.k_pad)
            work = _workspace(plan.splits, out)
            err = lib.conv3x3_wgrad_bf16(
                x.data_ptr(), dy.data_ptr(), work.data_ptr(), out.data_ptr(),
                b, h, w, c, k, plan.c_pad, plan.k_pad, plan.w_box, plan.rows, plan.images,
                plan.n_tile, plan.per_split, plan.splits, plan.ring, stream,
            )
        else:
            splits = lib.conv3x3_wgrad_splits(b, h, w, c, k)
            work = _workspace(splits, out)
            err = lib.conv3x3_wgrad_f32(
                x.data_ptr(), dy.data_ptr(), work.data_ptr(), out.data_ptr(),
                b, h, w, c, k, splits, stream,
            )
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _workspace(splits: int, out: torch.Tensor) -> torch.Tensor:
    """(splits, 3, 3, C, K) float32 for the partial sums; `out` itself when
    the sum is not split."""
    return torch.empty((splits, *out.shape), dtype=torch.float32, device=out.device) if splits > 1 else out


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


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wgrad")
    # Pointers and the stream as c_void_p: left undeclared, ctypes would pass
    # them as 32-bit ints and cut them.
    ptrs = [ctypes.c_void_p] * 4
    lib.conv3x3_wgrad_f32.argtypes = [*ptrs, *[ctypes.c_int] * 6, ctypes.c_void_p]
    lib.conv3x3_wgrad_f32.restype = ctypes.c_int
    lib.conv3x3_wgrad_bf16.argtypes = [*ptrs, *[ctypes.c_int] * 14, ctypes.c_void_p]
    lib.conv3x3_wgrad_bf16.restype = ctypes.c_int
    lib.conv3x3_wgrad_splits.argtypes = [ctypes.c_int] * 5
    lib.conv3x3_wgrad_splits.restype = ctypes.c_int
    return lib
