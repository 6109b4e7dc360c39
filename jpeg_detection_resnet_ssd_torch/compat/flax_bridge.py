"""Carry the JAX package's flax variables into a port module, by Keras name.

The port registers its layers under the same names as the flax modules, so a
flax path `("head", "fc7_mbox_loc", "kernel")` is the state_dict key
`head.fc7_mbox_loc.weight`.  Leaves are renamed and kernels laid out as
the module that owns them wants:

  params/kernel  Conv           HWIO -> OIHW                       weight
                 ConvTranspose  (k, k, in, out) -> (in, out, k, k),
                                flipped in both spatial axes       weight
                 Dense          (in, out) -> (out, in)             weight
  params/bias                                                      bias
  params/scale   (BatchNorm)                                       weight
  params/gamma   (L2Norm)                                          gamma
  batch_stats/mean                                                 running_mean
  batch_stats/var                                                  running_var

(flax's ConvTranspose with `transpose_kernel=False` correlates the dilated
input with its kernel as it is; `F.conv_transpose2d` with the flipped
kernel computes the same, see `models.layers.ConvTranspose`.)

The caller converts the pytree to NumPy (`jax.tree_util.tree_map(np.asarray,
variables)`); this module imports no jax.  `flax_variables` goes the other
way, so weights imported into a module (`compat.import_weights_by_name`)
can be handed to `train.fit(init_variables=...)`.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.models.layers import ConvTranspose, Dense
from jpeg_detection_resnet_ssd_torch.parallel.mesh import model_shards

_LEAF_NAMES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight", "gamma": "gamma"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def kernel_to_torch(owner: nn.Module, kernel: np.ndarray) -> np.ndarray | None:
    """A flax kernel in the layout of `owner`'s weight, or None when its rank
    is not the owner's (a Dense kernel for a conv, say)."""
    kernel = np.asarray(kernel)
    if isinstance(owner, ConvTranspose):
        return kernel[::-1, ::-1].transpose(2, 3, 0, 1) if kernel.ndim == 4 else None
    if isinstance(owner, Dense):
        return kernel.T if kernel.ndim == 2 else None
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else None


def flax_kernel_axes(owner: nn.Module, ndim: int) -> tuple[int, ...]:
    """Axis i of `owner`'s flax kernel is axis `result[i]` of its torch
    weight of `ndim` dims (the last, flax's output features, is axis 0,
    or 1 for a ConvTranspose)."""
    if isinstance(owner, ConvTranspose):
        return (2, 3, 0, 1)
    if isinstance(owner, Dense) or ndim == 2:
        return (1, 0)
    return (2, 3, 1, 0)


def kernel_to_flax(owner: nn.Module, weight: np.ndarray) -> np.ndarray:
    """The inverse of `kernel_to_torch`."""
    kernel = weight.transpose(flax_kernel_axes(owner, weight.ndim))
    return kernel[::-1, ::-1] if isinstance(owner, ConvTranspose) else kernel


def flax_leaf_name(owner: nn.Module, name: str) -> str:
    """The flax leaf name of `owner`'s parameter `name`: a BatchNorm's
    `weight` is its scale, any other layer's its kernel."""
    if name == "weight":
        return "scale" if isinstance(owner, nn.BatchNorm2d) else "kernel"
    return name


def _refuse_sharded(module: nn.Module) -> None:
    sharded = list(model_shards(module))
    if sharded:
        raise ValueError(f"{len(sharded)} layers hold a slice of their kernel over the model "
                         f"axis (e.g. {sharded[0]!r}): a tensor-parallel rank's module is not "
                         f"the whole model; save a checkpoint (it holds whole tensors) and "
                         f"load it into a module built in one process")


def _owner(module: nn.Module, scope) -> nn.Module | None:
    try:
        return module.get_submodule(".".join(scope))
    except AttributeError:
        return None


def _flax_to_state_dict(variables: Mapping, module: nn.Module | None = None) -> dict[str, np.ndarray]:
    """`{"params", "batch_stats"}` NumPy pytree -> {torch key: array}.  A
    kernel takes the layout of the layer of `module` that owns it; without
    a module (or an owner), a 4-dim kernel is a convolution's."""
    out: dict[str, np.ndarray] = {}
    for collection, tree in variables.items():
        if collection not in _LEAF_NAMES:
            raise KeyError(f"unknown flax collection {collection!r}")
        for path, value in _flatten(tree):
            *scope, leaf = path
            try:
                name = _LEAF_NAMES[collection][leaf]
            except KeyError:
                raise KeyError(f"unknown leaf {collection}/{'/'.join(path)}") from None
            arr = np.asarray(value)
            if leaf == "kernel":
                owner = None if module is None else _owner(module, scope)
                if owner is None:
                    arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
                else:
                    converted = kernel_to_torch(owner, arr)
                    if converted is None:
                        raise ValueError(f"kernel {'/'.join(scope)} has {arr.ndim} dims, which "
                                         f"{type(owner).__name__} does not take")
                    arr = converted
            out[".".join([*scope, name])] = arr
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `module`'s parameters and BatchNorm statistics from flax
    variables; raises on any missing, unused or mis-shaped entry.  The
    BatchNorm step counters (`num_batches_tracked`) have no flax counterpart
    and are left as they are."""
    _refuse_sharded(module)
    arrays = _flax_to_state_dict(variables, module)
    state = module.state_dict()
    expected = {k for k in state if not k.endswith("num_batches_tracked")}
    missing = sorted(expected - arrays.keys())
    unused = sorted(arrays.keys() - expected)
    if missing or unused:
        raise KeyError(f"flax variables do not fit the module: missing {missing}, unused {unused}")
    with torch.no_grad():
        for key, arr in arrays.items():
            target = state[key]
            if tuple(target.shape) != arr.shape:
                raise ValueError(f"{key}: module has {tuple(target.shape)}, flax gives {arr.shape}")
            target.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
    return module


def flax_variables(module: nn.Module) -> dict:
    """`module`'s parameters and BatchNorm statistics as a flax-layout
    `{"params", "batch_stats"}` NumPy pytree: the inverse of
    `load_flax_variables` (a BatchNorm's `weight` is its scale, any other
    layer's its kernel).  Refuses a module whose kernels are sharded over
    the model axis (`parallel.shard_parameters`)."""
    _refuse_sharded(module)
    out: dict = {"params": {}, "batch_stats": {}}
    for scope_name, owner in module.named_modules():
        scope = scope_name.split(".") if scope_name else []
        own = [*owner.named_parameters(recurse=False), *owner.named_buffers(recurse=False)]
        for name, tensor in own:
            if name == "num_batches_tracked":
                continue  # no flax counterpart
            arr = tensor.detach().cpu().numpy().copy()
            if name in ("running_mean", "running_var"):
                collection, leaf = "batch_stats", name[len("running_"):]
            else:
                collection, leaf = "params", flax_leaf_name(owner, name)
            if leaf == "kernel":
                arr = np.ascontiguousarray(kernel_to_flax(owner, arr))
            node = out[collection]
            for part in scope:
                node = node.setdefault(part, {})
            node[leaf] = arr
    return out
