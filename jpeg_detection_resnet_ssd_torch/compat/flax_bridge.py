"""Carry the JAX package's flax variables into a port module, by Keras name.

The port registers its layers under the same names as the flax modules, so a
flax path `("head", "fc7_mbox_loc", "kernel")` is the state_dict key
`head.fc7_mbox_loc.weight`.  Leaves are renamed and kernels transposed:

  params/kernel        HWIO -> OIHW   weight
  params/bias                         bias
  params/scale         (BatchNorm)    weight
  params/gamma         (L2Norm)       gamma
  batch_stats/mean                    running_mean
  batch_stats/var                     running_var

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


def _flax_to_state_dict(variables: Mapping) -> dict[str, np.ndarray]:
    """`{"params", "batch_stats"}` NumPy pytree -> {torch key: array}."""
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
                if arr.ndim != 4:
                    raise ValueError(f"kernel {'/'.join(scope)} has {arr.ndim} dims, expected HWIO")
                arr = arr.transpose(3, 2, 0, 1)
            out[".".join([*scope, name])] = arr
    return out


def load_flax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Fill `module`'s parameters and BatchNorm statistics from flax
    variables; raises on any missing, unused or mis-shaped entry.  The
    BatchNorm step counters (`num_batches_tracked`) have no flax counterpart
    and are left as they are."""
    arrays = _flax_to_state_dict(variables)
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
    `load_flax_variables` (a 4-dim `weight` is a conv kernel, any other
    `weight` a BatchNorm scale)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in module.state_dict().items():
        *scope, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        arr = tensor.detach().cpu().numpy().copy()
        if name in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", name[len("running_"):]
        elif name == "weight":
            collection, leaf = "params", "kernel" if arr.ndim == 4 else "scale"
            if arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
        else:
            collection, leaf = "params", name
        node = out[collection]
        for part in scope:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return out
