"""Classification loss and top-k accuracy, and the selective L2 penalty of
the SSD neck and head (torch).

Counterpart of the JAX package's `losses/classification.py`.  The models
emit logits, so the categorical cross-entropy is computed from logits.
`top_k_accuracy` counts a hit where the label is among the k largest
logits, ties going to the lower class index, as `lax.top_k` orders them.

`l2_regularization_loss` and `default_ssd_reg_filter`: the reference attaches Keras
`kernel_regularizer=l2(5e-4)` to its SSD neck and head convolutions, which
is `scale * sum(W^2)` (no 1/2) over exactly those kernels.  The filter takes
the JAX package's parameter path, so parameters are named here as flax
names them: a convolution's `weight` is its `kernel`, a BatchNorm's `weight`
its `scale`.
"""

from __future__ import annotations

from typing import Callable, Iterator

import torch
from torch import nn

def softmax_cross_entropy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    """Mean categorical cross-entropy from logits: log-softmax in the
    logits' dtype, then the one-hot weighted sum in the promoted dtype."""
    logp = torch.log_softmax(logits, dim=-1)
    return -(labels_onehot * logp).sum(-1).mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Share of rows whose int label is among the top min(k, C) logits
    (float32 scalar): the label's rank is the count of larger logits plus
    the equal ones at a lower index."""
    labels = labels.long()[:, None]
    at = logits.gather(-1, labels)
    idx = torch.arange(logits.shape[-1], device=logits.device)
    rank = (logits > at).sum(-1) + ((logits == at) & (idx < labels)).sum(-1)
    return (rank < min(k, logits.shape[-1])).float().mean()


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
