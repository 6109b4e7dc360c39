"""Random draws of the augmentation chain, made on the host.

The JAX package draws inside its compiled step from a PRNG key; its streams
cannot be reproduced in torch.  The port splits every random op in two: a
sampler that draws the op's small parameter vectors ((B,) or (B, trials))
on the host with a CPU `torch.Generator` (the one `fit` passes), and a
deterministic apply function on the device.  `to_device` moves a whole
nested dict of draws to the device in one copy.
"""

from __future__ import annotations

import torch


def uniform(generator, shape, low=0.0, high=1.0) -> torch.Tensor:
    """float32 U[low, high)."""
    return torch.rand(shape, generator=generator) * (high - low) + low


def bernoulli(generator, p, shape) -> torch.Tensor:
    """bool, True with probability p."""
    return torch.rand(shape, generator=generator) < p


def randint(generator, shape, low, high) -> torch.Tensor:
    """int64 uniform on [low, high)."""
    return torch.randint(low, high, shape, generator=generator)


def _leaves(draws, prefix=()):
    for key, value in draws.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def param(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A scalar or tensor parameter as a `dtype` tensor on `device`.  A
    Python scalar is filled on the device: `torch.as_tensor(x, device=
    "cuda")` would copy from pageable host memory, which waits for the
    stream."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def to_device(draws: dict, device: torch.device) -> dict:
    """The same nested dict of tensors on `device`: the leaves are packed
    into one pinned byte buffer (each padded to 8 bytes), copied once
    without waiting for the stream, and viewed back as their dtypes and
    shapes without a kernel."""
    device = torch.device(device)
    leaves = list(_leaves(draws))
    if device.type == "cpu" or not leaves:
        return draws
    chunks, spans, offset = [], [], 0
    for path, t in leaves:
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        chunks.append(raw)
        if pad:
            chunks.append(torch.zeros(pad, dtype=torch.uint8))
        spans.append((path, offset, raw.numel(), t.dtype, t.shape))
        offset += raw.numel() + pad
    # the caching host allocator keeps the pinned buffer until the copy ends
    buf = torch.cat(chunks).pin_memory().to(device, non_blocking=True)
    out: dict = {}
    for path, start, nbytes, dtype, shape in spans:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = buf[start:start + nbytes].view(dtype).reshape(shape)
    return out
