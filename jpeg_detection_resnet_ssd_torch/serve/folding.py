"""BatchNorm folding for serving modules.

Counterpart of the JAX package's `serve/folding.py`.  In eval mode a
BatchNorm computes the fixed affine map

    y = (x - mean) * rsqrt(var + eps) * scale + bias = x * a + b,
    a = scale / sqrt(var + eps),   b = bias - mean * a.

Where the BN's input is exactly one conv's output (every `res*`/`bn*`
bottleneck pair and the `conv1`/`bn_conv1` RGB stem), `a` and `b` absorb
into that conv's weight and bias and the BN becomes `nn.Identity`.  The
input-normalizing BNs (`bn_y_in`, `bn_cbcr_in`, `b_norm_*`, `bn_in`) have no
producing conv; each becomes a `ChannelAffine` that applies `x * a + b`.

Where the JAX package rewrites the variable pytree (folded BNs as exact
identities, input BNs as a bare affine) and keeps the module, the port
rewrites an eval-mode copy of the module, so the folded forward launches no
normalization at all.  The float32 arithmetic of `a`, `b` and the folded
weights is the JAX package's.  This is a SERVING transform: the copy holds
no running statistics and no gradients, so never train it.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from jpeg_detection_resnet_ssd_torch.models.layers import BN_EPSILON, Conv

# Keras-parity eps, the port's BatchNorm's (`models/layers.py`).
BN_EPS = BN_EPSILON


class ChannelAffine(nn.Module):
    """An input BatchNorm folded: `x * weight + bias` per channel of an NHWC
    tensor, computed in float32 and returned in the input's dtype, as the
    BatchNorm it replaces did."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addcmul(self.bias, x, self.weight).to(x.dtype)


def _conv_for_bn(bn_name: str) -> list[str]:
    """Candidate producing-conv names for a BN module name (same scope)."""
    cands = []
    if bn_name.startswith("bn") and not bn_name.startswith("bn_"):
        cands.append("res" + bn_name[2:])  # bn4a_branch2a -> res4a_branch2a
    if bn_name == "bn_conv1":
        cands.append("conv1")
    return cands


def bn_fold_pairs(module: nn.Module) -> tuple[dict[str, str], list[str]]:
    """Discover (bn module path -> conv module path) fold pairs.

    Returns (pairs, affine_only) where `affine_only` lists BN paths with no
    producing conv.  Paths are the dotted module names (the JAX package's
    '/'-joined flax paths with '.').  A name-derived candidate is accepted
    only if a `Conv` of that name exists in the same scope AND its output
    channels equal the BN's features.
    """
    modules = dict(module.named_modules())
    pairs, affine_only = {}, []
    for bn in sorted(p for p, m in modules.items() if isinstance(m, nn.BatchNorm2d)):
        scope, _, name = bn.rpartition(".")
        found = None
        for cand in _conv_for_bn(name):
            conv = f"{scope}.{cand}" if scope else cand
            owner = modules.get(conv)
            if isinstance(owner, Conv) and owner.weight.shape[0] == modules[bn].num_features:
                found = conv
                break
        if found is not None:
            pairs[bn] = found
        else:
            affine_only.append(bn)
    return pairs, affine_only


def _bn_affine(bn: nn.BatchNorm2d, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    mean = bn.running_mean.float()
    var = bn.running_var.float()
    # float32 sqrt correctly rounded, as XLA's (torch's CPU kernel is off by
    # an ulp at times): the float64 root of a float32 value, rounded once.
    std = torch.sqrt((var + eps).double()).float()
    a = bn.weight.detach().float() / std
    return a, bn.bias.detach().float() - mean * a


def _replace(root: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, new)


def fold_batch_norm(module: nn.Module, eps: float = BN_EPS) -> nn.Module:
    """An eval-mode copy of `module` with every BatchNorm folded.

    Each paired conv's weight is scaled by `a` per output channel and its
    bias becomes `bias * a + b` (a bias-free conv gets one); the BN becomes
    `nn.Identity`.  Each other BN becomes a `ChannelAffine(a, b)`.  The copy's
    parameters need no gradient; `module` is left as it is.
    """
    pairs, affine_only = bn_fold_pairs(module)
    folded = copy.deepcopy(module).eval().requires_grad_(False)
    with torch.no_grad():
        for bn_path, conv_path in pairs.items():
            a, b = _bn_affine(folded.get_submodule(bn_path), eps)
            conv = folded.get_submodule(conv_path)
            conv.weight.copy_(conv.weight.float() * a[:, None, None, None])
            cbias = torch.zeros_like(b) if conv.bias is None else conv.bias.float()
            conv.bias = nn.Parameter(cbias * a + b, requires_grad=False)
            _replace(folded, bn_path, nn.Identity())
        for bn_path in affine_only:
            _replace(folded, bn_path, ChannelAffine(*_bn_affine(folded.get_submodule(bn_path), eps)))
    return folded
