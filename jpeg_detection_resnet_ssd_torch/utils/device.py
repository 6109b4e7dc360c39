"""Where the port's entry points run: the CUDA device unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means `"cuda"`.  A CUDA device without a card raises: the port
    never falls back to the CPU on its own; callers that want the CPU (the
    tests) pass `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
