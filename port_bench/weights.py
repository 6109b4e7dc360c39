"""Seeded weights for a configuration, made on the device in a few calls.

The layer list of the configuration's reference network
(`reference/net_<network>.py`) names every tensor and its shape.  One normal draw from a generator on the device fills every
kernel at once, each scaled to its initializer's deviation and clipped at
two (he_normal for convolutions, lecun_normal for dense layers); biases
are zero, BatchNorm scales one (0.1 for the last BatchNorm of each
residual branch, as zero-init-residual recipes start it near zero), L2-norm
scales 20, running statistics zero and one.  The same dict goes to the
program (`load_into`) and to the reference.

The residual scale matters to the check: with every scale at one the
random network is chaotic (a 1e-3 change of its input moves its logits by
8%, and bf16 arithmetic by 25%), so no comparison could tell a sound bf16
program from a float8 one; at 0.1 a 1e-3 change moves them by 0.1%.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import nets

RESIDUAL_SCALE = 0.1


def make(layers: list, seed: int, device) -> dict:
    """name -> float32 tensor on `device` for every state-dict entry."""
    shapes = nets.state_shapes(layers)
    kernels = [(kind, name, shape) for kind, name, shape in layers if kind in ("conv", "dense")]
    total = sum(math.prod(s) for _, _, s in kernels)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for kind, name, shape in kernels:
        n = math.prod(shape)
        out[name + ".weight"] = (flat[at:at + n].view(shape).clamp(-2, 2)
                                 * nets.init_std(kind, shape))
        at += n
    for key, shape in shapes.items():
        if key in out:
            continue
        leaf = key.rsplit(".", 1)[1]
        fill = {"weight": 1.0, "running_var": 1.0, "gamma": 20.0}.get(leaf, 0.0)
        if key.endswith("_branch2c.weight"):
            fill = RESIDUAL_SCALE
        out[key] = torch.full(shape, fill, device=device)
    return out


def load_into(module: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into `module`'s parameters and buffers; every
    parameter must be named, with its shape (BatchNorm step counters
    aside)."""
    state = module.state_dict()
    missing = [k for k in state if k not in weights and not k.endswith("num_batches_tracked")]
    extra = [k for k in weights if k not in state]
    if missing or extra:
        raise KeyError(f"weights do not match the program's model: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for k, v in weights.items():
            if tuple(state[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: program {tuple(state[k].shape)}, weights {tuple(v.shape)}")
            state[k].copy_(v)
