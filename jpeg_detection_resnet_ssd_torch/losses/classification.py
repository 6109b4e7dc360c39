"""The selective L2 penalty of the SSD neck and head (torch).

Counterpart of `l2_regularization_loss` and `default_ssd_reg_filter` in the
JAX package's `losses/classification.py`: the reference attaches Keras
`kernel_regularizer=l2(5e-4)` to its SSD neck and head convolutions, which
is `scale * sum(W^2)` (no 1/2) over exactly those kernels.  The filter takes
the JAX package's parameter path, so parameters are named here as flax
names them: a convolution's `weight` is its `kernel`, a BatchNorm's `weight`
its `scale`.  (`softmax_cross_entropy` and `top_k_accuracy` come with the
classification models, ROADMAP slice 5.)
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch
from torch import nn

# SSD neck and head layer names that carry l2(5e-4) in the reference.
_SSD_REGULARIZED_PREFIXES = (
    "fc6",
    "fc7",
    "conv6_",
    "conv7_",
    "conv8_",
    "conv9_",
    "conv1_1_dct",
    "conv4_",
    "conv5_",
)


def default_ssd_reg_filter(path: tuple[str, ...]) -> bool:
    """True for a kernel of an SSD neck or head layer (flax path)."""
    name = path[-2] if len(path) >= 2 else path[0]
    return (
        any(name.startswith(p) for p in _SSD_REGULARIZED_PREFIXES) or "_mbox_" in name
    ) and path[-1] == "kernel"


def _flax_leaf(module: nn.Module, name: str, param: torch.Tensor) -> str:
    if name == "weight":
        if isinstance(module, nn.BatchNorm2d):
            return "scale"
        if param.dim() == 4:
            return "kernel"
    return name


def regularized_parameters(
    model: nn.Module,
    name_filter: Callable[[tuple[str, ...]], bool] = default_ssd_reg_filter,
) -> Iterator[tuple[str, torch.Tensor]]:
    """(state_dict key, parameter) of every parameter `name_filter` selects."""
    for module_name, module in model.named_modules():
        scope = tuple(module_name.split(".")) if module_name else ()
        for name, param in module.named_parameters(recurse=False):
            if name_filter((*scope, _flax_leaf(module, name, param))):
                yield ".".join((*scope, name)), param


def l2_regularization_loss(
    model: nn.Module,
    scale: float = 5e-4,
    name_filter: Callable[[tuple[str, ...]], bool] = default_ssd_reg_filter,
) -> torch.Tensor:
    """sum(scale * ||W||^2) over the kernels `name_filter` selects."""
    terms = [scale * p.square().sum() for _, p in regularized_parameters(model, name_filter)]
    if not terms:
        return torch.zeros((), device=next(model.parameters()).device)
    return torch.stack(terms).sum()
