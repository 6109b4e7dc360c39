"""Data and tensor parallelism across processes: the (data, model) mesh, a
rank's batch rows and parameter slices, and the collectives that make
`n_data x n_model` ranks compute one process's step on the global batch.

Counterpart of the JAX package's `parallel/mesh.py`.  There one `jit` runs
over a global batch sharded on the mesh's `data` axis, with the widest
kernels sharded on its `model` axis, and GSPMD keeps single-device
semantics.  Here each process (a `torch.distributed` rank) is one cell of
that grid, laid out model-axis-minor as the JAX grid `devices.reshape(
n_data, n_model)`: world rank r has data index r // n_model and model index
r % n_model.  The ranks of one model index form a data group, those of one
data index a model group (`Mesh.data_group`, `Mesh.model_group`).

Data axis.  The rank of data index d holds rows `[d * B/n_data, (d + 1) *
B/n_data)` of the global batch of B rows, and the reductions over the batch
are made global over the data group where they happen:

  * train-mode BatchNorm all-reduces its sums of x and x^2 and its row count,
    and backward the sums the input's gradient takes from them, so the
    gradient flows through the global statistics (`ops/batch_norm.py`);
  * the SSD loss all-reduces its positives and nonzero-negative counts and
    takes its hard-negative threshold from the all-gathered negative losses
    (`losses/ssd_loss.py`);
  * the device augment and dropout draw for the global batch from the step's
    generator and keep the data index's rows (`ops/dct_augment.py`,
    `models/layers.py`);
  * the trainer sums the parameter gradients and the reported metrics over
    the data group (`train/trainer.py`).

Each of these reads `active_mesh()`, which is the mesh inside
`data_parallel(mesh)` when its data axis has more than one rank, and None
otherwise: then the single-process code runs unchanged.

Model axis.  `shard_parameters` keeps, of every conv or dense kernel that
`tensor_parallel_rule` claims, the rank's contiguous slice of output
features, and marks the owning layer with a `ModelShard`.  A sharded layer
computes

    x -> copy_to_model_group -> conv(x, W_local) -> gather_from_model_group -> + bias

(`models/layers.py::column_parallel`): the copy is the identity forward and
sums the input gradient over the model group backward (each rank's is the
partial product of its own output slice); the gather all-gathers the ranks'
output channels on the last (NHWC channel) axis forward and hands back the
rank's own slice of the gradient.  So every rank of a model group holds the
full activations between layers, computes the same loss, and its replicated
parameters get the same gradient, which `broadcast_replicated_gradients`
makes bit-identical (the library's kernels are not all deterministic); the
bias is replicated (the rule shards the kernel only).  Kernels work on
plain tensors: B4's autograd Function computes the filter gradient of the
rank's output slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`shape == {"data": n_data, "model": n_model}` over the world's
    ranks, this process's world `rank`, and its data and model groups (None
    for a group of one rank)."""

    shape: dict
    rank: int
    data_group: Any = None
    model_group: Any = None

    @property
    def n_data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def n_model(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def _my_group(members, rank: int, world: int):
    """The group of the rank lists `members` that holds `rank`.  Every rank
    creates every group, in the same order (`dist.new_group`'s rule); a list
    of one rank needs no group, a list of all is the world."""
    mine = None
    for ranks in members:
        ranks = [int(r) for r in ranks]
        if len(ranks) == 1:
            group = None
        elif len(ranks) == world:
            group = dist.group.WORLD
        else:
            group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def make_mesh(n_data: int | None = None, n_model: int = 1) -> Mesh:
    """The (data, model) mesh over the processes of the default process
    group (one rank without one), model-axis-minor: `n_data` defaults to
    the world size over `n_model`, and `n_data * n_model` must be the world
    size.  Every rank must call it (it creates the groups)."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    data_group = model_group = None
    if world > 1:
        grid = np.arange(world).reshape(n_data, n_model)
        data_group = _my_group(grid.T, rank, world)
        model_group = _my_group(grid, rank, world)
    return Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank, data_group, model_group)


def _rows(x, mesh: Mesh):
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"{n} rows do not split over {mesh.n_data} data ranks")
    b = n // mesh.n_data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows `[d * B/n_data, (d + 1) * B/n_data)` (d its data
    index) of every tensor or array in a nested dict, tuple or list of a
    global batch of B rows; other leaves are kept as they are."""
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
    """Scope in which the batch reductions span `mesh`'s data group (a
    no-op for None or one data rank, whatever the model axis)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, (mesh if mesh is not None and mesh.n_data > 1 else None)
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Mesh | None:
    """The mesh of the enclosing `data_parallel` scope, None outside one."""
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the gradient of the sum is the sum of the
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
    """`x` summed over the data group, bit-identical on every rank of it,
    with autograd."""
    return _AllReduceSum.apply(x, mesh.data_group)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data group's `x` (without gradient) concatenated on axis 0 in
    data-index order: the global batch's tensor."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.n_data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


def _in_flat_buffers(tensors, collective) -> None:
    """`collective(flat)` on one flat buffer a dtype of `tensors`, in
    place, the result copied back into each tensor."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same_dtype in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same_dtype])
        collective(flat)
        offset = 0
        for t in same_dtype:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Sum the parameters' gradients over the data group in place, one flat
    buffer a dtype.  The sum, not the mean: each rank's loss is already its
    share of the global loss (see `train/trainer.py`).  The ranks of a data
    group hold the same slices, so their buffers line up."""
    _in_flat_buffers([p.grad for p in params if p.grad is not None],
                     lambda flat: dist.all_reduce(flat, group=mesh.data_group))


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the world (a no-op for one rank)."""
    if mesh.n_data * mesh.n_model > 1:
        dist.barrier()


# Collectives over a model group, counted where they run (the copy's
# backward, the gather's forward, `model_sum`, the checkpoint's gathers).
MODEL_COLLECTIVES = 0


def _count_model_collective() -> None:
    global MODEL_COLLECTIVES
    MODEL_COLLECTIVES += 1


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """How `shard_parameters` split a layer's weight: this rank holds slice
    `index` of `size` equal slices of the weight's output-feature axis
    `axis` (torch's layout), the model group `group` holds them all."""

    group: Any
    size: int
    index: int
    axis: int

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole tensor."""
        n = full.shape[self.axis] // self.size
        return full.narrow(self.axis, self.index * n, n)

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The model group's slices of `local` (without gradient) joined:
        the whole tensor (a collective: every rank of the group calls it)."""
        local = local.detach().contiguous()
        parts = [torch.empty_like(local) for _ in range(self.size)]
        _count_model_collective()
        dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts, dim=self.axis)


class _CopyToModelGroup(torch.autograd.Function):
    """Identity forward; backward, the input gradient summed over the model
    group (each rank's is the partial product of its own output slice)."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        _count_model_collective()
        dist.all_reduce(out, group=ctx.shard.group)
        return out, None


class _GatherFromModelGroup(torch.autograd.Function):
    """The model group's output slices all-gathered on the last (channel)
    axis forward; backward, this rank's slice of the gradient (every rank
    of the group holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(shard.size)]
        _count_model_collective()
        dist.all_gather(parts, y, group=shard.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[-1] // ctx.shard.size
        return grad.narrow(-1, ctx.shard.index * n, n).contiguous(), None


def copy_to_model_group(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, shard)


def gather_from_model_group(y: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    return _GatherFromModelGroup.apply(y, shard)


def model_sum(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """`x` (without gradient) summed over the model group."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    _count_model_collective()
    dist.all_reduce(out, group=shard.group)
    return out


def model_shards(module: nn.Module) -> dict[str, ModelShard]:
    """{state_dict key: ModelShard} of `module`'s sharded weights."""
    return {f"{name}.weight" if name else "weight": owner.model_shard
            for name, owner in module.named_modules()
            if getattr(owner, "model_shard", None) is not None}


def broadcast_replicated_gradients(module: nn.Module) -> None:
    """Hand every rank of the model group model index 0's gradients of
    `module`'s replicated parameters, one flat buffer a dtype (a no-op
    without sharded kernels).  The ranks compute the same gradients up to
    the library's nondeterministic kernels (a cuDNN filter gradient that
    sums with atomics), whose last-bit differences would otherwise let the
    replicas drift apart step by step."""
    shards = {id(module.get_parameter(k)): s for k, s in model_shards(module).items()}
    if not shards:
        return
    group = next(iter(shards.values())).group

    def broadcast(flat):
        _count_model_collective()
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)

    _in_flat_buffers([p.grad for p in module.parameters()
                      if id(p) not in shards and p.grad is not None], broadcast)


def shard_parameters(module: nn.Module, mesh: Mesh, rule=tensor_parallel_rule) -> nn.Module:
    """Shard `module`'s widest kernels over `mesh`'s model axis in place,
    the counterpart of the JAX package's `param_shardings`: each weight's
    flax path and shape (`compat.flax_bridge` naming) go to `rule`; a
    claimed output-feature axis that `n_model` divides is cut into equal
    contiguous slices, the rank keeping slice `model_index` as a new
    Parameter (so build the optimizer after this), and the owning layer
    gets its `ModelShard`; any other leaf stays replicated.  A no-op for
    one model rank."""
    if mesh.n_model == 1:
        return module
    # compat imports the layers, which import this module: import at call time.
    from jpeg_detection_resnet_ssd_torch.compat.flax_bridge import flax_kernel_axes, flax_leaf_name

    for scope, owner in list(module.named_modules()):
        weight = owner._parameters.get("weight")
        if weight is None or weight.dim() < 2 or flax_leaf_name(owner, "weight") != "kernel":
            continue
        axes = flax_kernel_axes(owner, weight.dim())
        shape = tuple(weight.shape[a] for a in axes)
        path = (*scope.split("."), "kernel") if scope else ("kernel",)
        axis = rule(path, shape)
        if axis is None or shape[axis] % mesh.n_model:
            continue  # never shard an axis that does not divide evenly
        if axis != len(shape) - 1:
            raise ValueError(f"{'.'.join(path)}: a kernel is sharded on its output features "
                             f"(axis {len(shape) - 1} of {shape}), not axis {axis}")
        if not hasattr(owner, "model_shard"):
            raise ValueError(f"{'.'.join(path)}: {type(owner).__name__} has no sharded forward")
        shard = ModelShard(mesh.model_group, mesh.n_model, mesh.model_index, axes[axis])
        owner.weight = nn.Parameter(shard.local(weight.detach()).clone(),
                                    requires_grad=weight.requires_grad)
        owner.model_shard = shard
    return module
