"""Data parallelism across processes: the mesh, a rank's batch rows, and the
collectives that make P ranks compute one process's step on the global batch.

Counterpart of the JAX package's `parallel/mesh.py`.  There one `jit` runs
over a global batch sharded on the mesh's `data` axis, and GSPMD keeps
single-device semantics, so every reduction over the batch is global.  Here
each of P processes (`torch.distributed` ranks) holds rows
`[rank * B/P, (rank + 1) * B/P)` of the global batch of B rows, and the
reductions over the batch are made global where they happen:

  * train-mode BatchNorm all-reduces its sums of x and x^2 and its row count,
    with autograd, so the gradient flows through the global statistics
    (`models/layers.py`);
  * the SSD loss all-reduces its positives and nonzero-negative counts and
    takes its hard-negative threshold from the all-gathered negative losses
    (`losses/ssd_loss.py`);
  * the device augment and dropout draw for the global batch from the step's
    generator and keep the rank's rows (`ops/dct_augment.py`,
    `models/layers.py`);
  * the trainer sums the parameter gradients and the reported metrics over
    the ranks (`train/trainer.py`).

Each of these reads `active_mesh()`, which is the mesh inside
`data_parallel(mesh)` when it has more than one rank, and None otherwise:
then the single-process code runs unchanged.

Tensor parallelism (`n_model > 1`) is not ported yet (ROADMAP A13b);
`tensor_parallel_rule` is the JAX rule as pure logic, ready for it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P data-parallel ranks: `shape == {"data": P, "model": 1}`, this
    process's `rank` and the process group (None without one)."""

    shape: dict
    rank: int
    group: Any = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS]


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The mesh over the processes of the default process group (one rank
    without one).  `n_data`, when given, must be the world size."""
    if n_model != 1:
        raise NotImplementedError(
            "tensor parallelism (n_model > 1) is not ported to PyTorch yet (ROADMAP A13b)")
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_data is not None and n_data != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    return Mesh({DATA_AXIS: world, MODEL_AXIS: 1}, rank, group)


def _rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    b = n // mesh.size
    return x[mesh.rank * b:(mesh.rank + 1) * b]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows `[rank * B/P, (rank + 1) * B/P)` of every tensor or
    array in a nested dict, tuple or list of a global batch of B rows; other
    leaves are kept as they are."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)) and batch.ndim:
        return _rows(batch, mesh)
    return batch


def scale_learning_rate(base_lr: float, n_replicas: int, divider: float = 4.0):
    """Linear lr scaling used by the reference's Horovod config
    (`config/resnet/config_file.py:133-150`, Goyal et al. 2017):
    lr = base_lr * n_replicas / batch_size_divider."""
    return base_lr * n_replicas / divider


def tensor_parallel_rule(path: tuple[str, ...], shape: tuple, min_features: int = 1024):
    """The axis of a flax-layout leaf that tensor parallelism shards, or
    None (replicated): the last (output-feature) axis of a conv or dense
    `kernel` with at least `min_features` outputs, the JAX package's rule."""
    if len(shape) >= 2 and path and path[-1] == "kernel" and shape[-1] >= min_features:
        return len(shape) - 1
    return None


_ACTIVE: Mesh | None = None


@contextlib.contextmanager
def data_parallel(mesh: Mesh | None):
    """Scope in which the batch reductions span `mesh`'s ranks (a no-op for
    None or one rank)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.size > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing `data_parallel` scope, None outside one."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the gradient of the sum is the sum of the
    gradients (the JAX counterpart is `psum`'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` summed over the ranks, bit-identical on every rank, with autograd."""
    return _AllReduceSum.apply(x, mesh.group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' `x` (without gradient) concatenated on axis 0 in rank
    order: the global batch's tensor."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Sum the parameters' gradients over the ranks in place, one flat
    buffer a dtype.  The sum, not the mean: each rank's loss is already its
    share of the global loss (see `train/trainer.py`)."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (a no-op for one rank)."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
