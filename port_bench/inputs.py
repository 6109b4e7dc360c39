"""Seeded inputs of a run: DCT planes and ground-truth boxes.

A pool of `slots` batches is made once per run from `--seed`, on the
device with one generator and copied to host memory, as JPEG decoders hand
coefficients over: int16, luma (B, h8, h8, 64) and 4:2:0 chroma
(B, h8/2, h8/2, 128), Y ~ N(0, 100) and CbCr ~ N(0, 30) rounded.  The
detection traffic adds, per image, 1 + Binomial(5, p) boxes of a uniform
class (1-20), side shares U(lo, hi) of the source frame, placed uniformly
inside it, padded to `max_gt` rows.  Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import weights

MASK64 = (1 << 64) - 1


def mix_seed(seed: int, salt: int) -> int:
    """A 63-bit generator seed from a run seed and a salt (splitmix64)."""
    z = ((seed << 20) + salt + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator the benchmark hands to training step `step`."""
    return torch.Generator().manual_seed(mix_seed(seed, 1_000_000 + step))


def planes(seed: int, slots: int, batch: int, h8: int, device, pinned: bool) -> list:
    """`slots` (y, cbcr) int16 host batches."""
    g = torch.Generator(device=device).manual_seed(mix_seed(seed, 1))
    out = []
    for _ in range(slots):
        y = (torch.randn((batch, h8, h8, 64), generator=g, device=device) * 100).round()
        c = (torch.randn((batch, h8 // 2, h8 // 2, 128), generator=g, device=device) * 30).round()
        pair = tuple(t.to(torch.int16).cpu() for t in (y, c))
        out.append(tuple(t.pin_memory() for t in pair) if pinned else pair)
    return out


def boxes(seed: int, slots: int, batch: int, frame_px: int, spec: dict) -> list:
    """`slots` (gt (B, max_gt, 5) float32, mask (B, max_gt) bool) batches."""
    rng = np.random.default_rng(mix_seed(seed, 2))
    out = []
    lo, hi = spec["side_share"]
    for _ in range(slots):
        n = 1 + rng.binomial(spec["max_boxes"] - 1, spec["p_extra"], batch)
        gt = np.zeros((batch, spec["max_gt"], 5), np.float32)
        mask = np.arange(spec["max_gt"])[None, :] < n[:, None]
        wh = rng.uniform(lo, hi, (batch, spec["max_gt"], 2)) * frame_px
        xy = rng.uniform(0, 1, (batch, spec["max_gt"], 2)) * (frame_px - wh)
        gt[..., 0] = rng.integers(1, spec["n_classes"] + 1, (batch, spec["max_gt"]))
        gt[..., 1:3] = xy
        gt[..., 3:5] = xy + wh
        gt[~mask] = 0.0
        out.append((gt, mask))
    return out


def for_run(spec: dict, seed: int, device, pinned: bool = False):
    """A run's seeded weights (for the layers of the configuration's
    reference network), pool of planes and, for training, its ground truth
    (boxes and masks, or labels) of each pool slot."""
    cfg, mix = spec["config"], spec["traffic"]
    W = weights.make(spec["network"].layers(cfg["n_classes"]), mix_seed(seed, 3), device)
    B = mix["batch"]
    if mix["kind"] == "serve":
        return W, planes(seed, mix["slots"], B, cfg["input_blocks"], device, pinned), None
    pool = planes(seed, mix["slots"], B, mix["source_blocks"], device, pinned)
    if cfg["task"] == "detection":
        gts = boxes(seed, mix["slots"], B, mix["source_blocks"] * 8, mix["boxes"])
    else:
        g = torch.Generator().manual_seed(mix_seed(seed, 2))
        gts = [torch.randint(0, cfg["n_classes"], (B,), generator=g).numpy().astype("int32")
               for _ in range(mix["slots"])]
    return W, pool, gts
