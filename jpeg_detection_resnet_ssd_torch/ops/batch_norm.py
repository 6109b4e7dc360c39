"""Train-mode BatchNorm on NHWC activations: the CUDA kernels, their plain
PyTorch version and the launch counter.

Replaces no TPU kernel: the JAX package leaves flax's
`BatchNorm(use_running_average=False)` to XLA.  Function (flax's, with
Keras's defaults in `models/layers.py::BatchNorm`): statistics over (B, H,
W) in at least float32, the variance E[x^2] - E[x]^2 clipped at 0
(biased), `y = (x - mean) * (rsqrt(var + eps) * weight) + bias` rounded
once to x's dtype, and unless `update` is False the running statistics move
by `running = (1 - f) * running + f * batch` with that same biased
variance, `num_batches_tracked` by 1; `f` is `momentum`, or
1 / num_batches_tracked where `momentum` is None (torch's cumulative
average).  With a `mesh` (`parallel.active_mesh()`: a data-parallel scope
of more than one data rank) the statistics are the global batch's: the
sums of x and x^2 and the row count are summed over the data group, and
so are the backward's sums that dx needs.

`impl` chooses, as `dct_flip_horizontal` does: "auto" launches the kernels
on a CUDA tensor and runs the plain version on any other, "kernel" always
launches them (and raises on the CPU), "reference" always runs the plain
version.

The kernels (`csrc/batch_norm.cu`) take a contiguous float32 or bfloat16
input and run as a `torch.autograd.Function`: forward, a statistics pass,
a finalize launch and an apply pass; backward, a pass summing dy and
dy * (x - mean), a finalize launch and the dx pass (skipped where x needs
no gradient).  With a mesh each direction launches a fourth kernel, which
sums a rank's partials before the all-reduce.  They save x and four
float32 numbers a channel for the backward, where the plain version's
autograd keeps two float32 copies of x.  They sum in another order than
the plain version, so the two agree to float32 rounding, not bit for bit;
two runs of the kernels agree bit for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from jpeg_detection_resnet_ssd_torch.ops import _build
from jpeg_detection_resnet_ssd_torch.parallel.mesh import Mesh, all_reduce_sum

# Kernel launches since the last reset: three a forward (statistics,
# finalize, apply), three a backward (sums, finalize, dx) or two where x
# needs no gradient; one more each way under a mesh (a rank's totals).
LAUNCHES = 0

IMPLS = ("auto", "kernel", "reference")
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def batch_norm_train_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    num_batches_tracked: torch.Tensor,
    momentum: float | None,
    eps: float,
    update: bool = True,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """The plain version, with autograd.  Inside a mesh the sums of x and
    x^2 and the row count are all-reduced over the data group with
    autograd, so the gradient flows through them and every rank moves its
    running statistics by the same values; the mean is sum / count there,
    where one process takes `mean()`."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if mesh is None:
        mean = xf.mean(dim=(0, 1, 2))
        mean_sq = xf.square().mean(dim=(0, 1, 2))
    else:
        count = xf.new_full((1,), xf.shape[0] * xf.shape[1] * xf.shape[2])
        sums = all_reduce_sum(torch.cat([xf.sum(dim=(0, 1, 2)),
                                         xf.square().sum(dim=(0, 1, 2)), count]), mesh)
        c = xf.shape[-1]
        mean, mean_sq = sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]
    var = torch.clamp_min(mean_sq - mean.square(), 0.0)
    if update:
        with torch.no_grad():
            num_batches_tracked.add_(1)
            factor = 1.0 / float(num_batches_tracked) if momentum is None else momentum
            running_mean.mul_(1.0 - factor).add_(factor * mean)
            running_var.mul_(1.0 - factor).add_(factor * var)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y.to(x.dtype)


def batch_norm_train(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    num_batches_tracked: torch.Tensor,
    momentum: float | None,
    eps: float,
    update: bool = True,
    mesh: Mesh | None = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Train-mode BatchNorm of a (B, H, W, C) tensor; returns x's dtype.

    The kernels take float32 or bfloat16 on CUDA with float32 parameters
    and running statistics; a non-contiguous x is made contiguous first."""
    if impl == "auto":
        kernels = x.is_cuda
    elif impl in IMPLS:
        kernels = impl == "kernel"
    else:
        raise ValueError(f"batch norm impl must be one of {IMPLS}, got {impl!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    if not kernels:
        return batch_norm_train_reference(x, weight, bias, running_mean, running_var,
                                          num_batches_tracked, momentum, eps, update, mesh)
    _check(x, weight, bias, running_mean, running_var, num_batches_tracked)
    factor = None
    if update:
        if momentum is None:  # the host needs the step count: one synchronize
            num_batches_tracked.add_(1)
            factor = 1.0 / float(num_batches_tracked)
        else:
            factor = momentum
    return _TrainBatchNorm.apply(x.contiguous(), weight, bias, running_mean, running_var,
                                 num_batches_tracked, factor, update and momentum is not None, eps,
                                 None if mesh is None else mesh.data_group)


def _check(x, weight, bias, running_mean, running_var, num_batches_tracked) -> None:
    """What the kernels take, checked on attributes alone (no device call)."""
    if not x.is_cuda:
        raise ValueError(f"the batch norm kernels run on cuda, got {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the batch norm kernels take float32 or bfloat16, got {x.dtype}")
    c, index = x.shape[-1], x.get_device()
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t.dtype is not torch.float32 or t.shape != (c,) or t.get_device() != index \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({c},) tensor on {x.device}")
    if num_batches_tracked.dtype is not torch.int64 or num_batches_tracked.numel() != 1 \
            or num_batches_tracked.get_device() != index:
        raise ValueError(f"num_batches_tracked must be one int64 on {x.device}")
    if x.numel() == 0:
        raise ValueError("batch norm over an empty batch")


class _TrainBatchNorm(torch.autograd.Function):
    """Forward and backward on the kernels; the running statistics move in
    the forward's finalize launch where `factor` is not None, and
    `num_batches_tracked` there too where `count`.  With a data `group`,
    each direction's totals are all-reduced over it between its halves."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, num_batches_tracked,
                factor, count, eps, group):
        c = x.shape[-1]
        m = x.numel() // c
        plan, vec, stream = _launch_args(x, m, c)
        y = torch.empty_like(x)
        # stats (4, C), then the reduce pass's partials (2, row blocks, C)
        work = torch.empty((4 + 2 * plan[2]) * c, dtype=torch.float32, device=x.device)
        stats, part = work.data_ptr(), work.data_ptr() + 16 * c
        update, f = factor is not None, 0.0 if factor is None else factor
        lib = _library()
        with _on(x):
            if group is None:
                err = lib.bn_forward(
                    x.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
                    running_var.data_ptr(), num_batches_tracked.data_ptr(), y.data_ptr(), stats,
                    part, m, c, x.element_size(), vec, plan, eps, f, 1.0 - f, update, count,
                    stream)
            else:
                sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
                err = lib.bn_forward_sums(x.data_ptr(), part, sums.data_ptr(), m, c,
                                          x.element_size(), vec, plan, stream)
                _raise(err, "bn_forward_sums")
                dist.all_reduce(sums, group=group)
                err = lib.bn_forward_apply(
                    x.data_ptr(), weight.data_ptr(), bias.data_ptr(), running_mean.data_ptr(),
                    running_var.data_ptr(), num_batches_tracked.data_ptr(), y.data_ptr(), stats,
                    sums.data_ptr(), m, c, x.element_size(), vec, plan, eps, f, 1.0 - f, update,
                    count, stream)
        _raise(err, "bn_forward")
        global LAUNCHES
        LAUNCHES += 3 if group is None else 4
        ctx.group = group
        # the (4, C) statistics, and under a mesh the all-reduced sums, whose
        # last entry is the global row count
        ctx.save_for_backward(x, work[:4 * c], *(() if group is None else (sums,)))
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stats, *forward_sums = ctx.saved_tensors
        dx, dweight, dbias = _backward(x, dy, stats, forward_sums, ctx.group,
                                       ctx.needs_input_grad[0])
        return dx, dweight, dbias, None, None, None, None, None, None, None


def _backward(x, dy, stats, forward_sums, group, needs_dx):
    """dx (None unless `needs_dx`), dweight and dbias from x, dy and what
    the forward saved: the (4, C) statistics and, under a data `group`, its
    all-reduced sums."""
    dy = dy.contiguous()
    c = x.shape[-1]
    m = x.numel() // c
    plan, vec, stream = _launch_args(x, m, c, dy)
    dx = torch.empty_like(x) if needs_dx else None
    grads = torch.empty(2, c, dtype=torch.float32, device=x.device)  # dweight, dbias
    # coef (2, C), then the partials (2, row blocks, C)
    work = torch.empty((2 + 2 * plan[2]) * c, dtype=torch.float32, device=x.device)
    coef, part = work.data_ptr(), work.data_ptr() + 8 * c
    dx_ptr = None if dx is None else dx.data_ptr()
    lib = _library()
    with _on(x):
        if group is None:
            err = lib.bn_backward(
                x.data_ptr(), dy.data_ptr(), stats.data_ptr(), dx_ptr, grads[0].data_ptr(),
                grads[1].data_ptr(), coef, part, m, c, x.element_size(), vec, plan, stream)
            launches = 2 if dx is None else 3
        else:
            sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
            err = lib.bn_backward_sums(
                x.data_ptr(), dy.data_ptr(), stats.data_ptr(), grads[0].data_ptr(),
                grads[1].data_ptr(), part, sums.data_ptr(), m, c, x.element_size(), vec, plan,
                stream)
            launches = 2
            if dx is not None and err == 0:
                dist.all_reduce(sums, group=group)
                err = lib.bn_backward_apply(
                    x.data_ptr(), dy.data_ptr(), stats.data_ptr(), dx_ptr, coef, sums.data_ptr(),
                    forward_sums[0].data_ptr() + 8 * c, m, c, x.element_size(), vec, plan, stream)
                launches = 4
    _raise(err, "bn_backward")
    global LAUNCHES
    LAUNCHES += launches
    return dx, grads[0], grads[1]


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _on(x: torch.Tensor):
    """The CUDA device of x made current for the launches; nothing to enter
    where it is already (the usual case: a device switch costs the host)."""
    index = x.get_device()
    return _NO_SWITCH if index == torch.cuda.current_device() else torch.cuda.device(index)


_NO_SWITCH = contextlib.nullcontext()


def _launch_args(x: torch.Tensor, m: int, c: int, *others: torch.Tensor):
    """The kernels' launch plan, whether they take 16-byte loads (C a
    multiple of 16 bytes' elements and every tensor 16-byte aligned), and
    x's device's current stream as a raw pointer."""
    elem, index = x.element_size(), x.get_device()
    vec = int(c * elem % 16 == 0 and x.data_ptr() % 16 == 0
              and all(t.data_ptr() % 16 == 0 for t in others))
    # the call torch's own generated kernels make: no Stream object built
    return _plan(m, c, elem, vec, index), vec, torch._C._cuda_getCurrentRawStream(index)


@functools.lru_cache(maxsize=1024)
def _plan(m: int, c: int, elem_bytes: int, vec: int, device_index: int):
    """bn_plan's (lanes, channel tiles, row blocks, rows a block), as the
    ctypes array the launches take; plan[2] reads as an int."""
    plan = (ctypes.c_longlong * 4)()
    with torch.cuda.device(device_index):
        err = _library().bn_plan(m, c, elem_bytes, vec, plan)
    if err != 0:
        raise RuntimeError(f"bn_plan failed: CUDA error {err}")
    return plan


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("batch_norm")
    p, f, i, ll = ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_longlong
    lib.bn_plan.argtypes = [ll, i, i, i, p]
    lib.bn_forward.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, p, f, f, f, i, i, p]
    lib.bn_backward.argtypes = [p, p, p, p, p, p, p, p, ll, i, i, i, p, p]
    lib.bn_forward_sums.argtypes = [p, p, p, ll, i, i, i, p, p]
    lib.bn_forward_apply.argtypes = [p, p, p, p, p, p, p, p, p, ll, i, i, i, p, f, f, f, i, i, p]
    lib.bn_backward_sums.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, p, p]
    lib.bn_backward_apply.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, p, p]
    for fn in (lib.bn_plan, lib.bn_forward, lib.bn_backward, lib.bn_forward_sums,
               lib.bn_forward_apply, lib.bn_backward_sums, lib.bn_backward_apply):
        fn.restype = ctypes.c_int
    return lib
