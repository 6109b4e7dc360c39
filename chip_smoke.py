#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Three paths, each at the full width of `ssd300_ssd_custom`:
  * inference: `build_model` -> forward on seeded DCT planes ->
    `make_inference_fn` (candidate selection, batched greedy NMS on the CUDA
    kernel, global top-200) -> (B, 200, 6) detections;
  * training: `build_trainer(ExperimentConfig(pallas_wgrad=True,
    compute_dtype="bfloat16", batch_size=32))` with a `TargetEncoder` whose
    greedy bipartite matching runs on the CUDA kernel, driven by `fit` for 5
    steps; the filter gradient of every eligible 3x3 conv runs on the CUDA
    kernel;
  * training with device augmentation: the same `fit` on 44-block (352 px)
    source maps through `make_dct_detection_augment_v3(out_y_blocks=38)`
    (photometric, expand + min-IoU crop + resize, hflip on the CUDA flip
    kernel) and a `TargetEncoder(AnchorSpec(304, 304))`.

Phases (any failure exits non-zero):
  1. card name and power limit (nvidia-smi);
  2. build the four kernels from the sources in the checkout, one nvcc each,
     all started together; print ptxas' registers, shared memory, spills;
  3. NMS kernel against its plain version at the serving shape (N=640,
     K=400) and a ragged one, with pairs at IoU exactly the threshold:
     masks exactly equal;
  4. matching kernel against its plain version on the IoUs of seeded GT
     with the 8732 anchors at batch 32 (1-10 valid rows per image, one image
     with 64, one with none, duplicate boxes) and on tie-heavy (5, 64, 300)
     similarities: indices exactly equal;
  5. filter-gradient kernel against its plain version at each of the 24
     conv shapes of the train step at batch 32, in bf16 and float32
     (max |got - ref| <= 1e-4 max |ref|), two bf16 calls bit-identical; in
     bf16 also at K = 100 and 150 on 38x38 and 19x19 maps, C = 40 on a 7x9
     map, 1x1 and 3x3 maps at batch 1 and a view 2 bytes past an aligned
     base; the f32 kernel against a float64 oracle;
  5b. flip kernel against its plain version at the chain's two shapes in
     float32, a ragged shape and in bf16: bit for bit;
  5c. the augmentation chain's apply functions on the card (flip kernel,
     TF32 off) against the CPU (plain versions) with one set of host draws,
     at batch 4 from 44-block maps, for photometric True and "pixel_hsv" and
     for requantization at quality 75: GT masks exact, boxes within 1e-3 px,
     coefficients within 1e-5 (1e-4 pixel_hsv) of the largest CPU value;
     requantized, at most 1e-4 of them one quantizer step apart; flip
     launches read around the card's run;
  6. inference: a batch-32 bf16 and a batch-1 f32 request through both
     candidate selectors, NMS launch count read around them; kernel and
     plain NMS give identical detections; the f32 forward agrees with the
     port's CPU forward;
  7. training: `fit` for 5 steps into a temporary run directory, on
     batches whose images each carry the two GT boxes of `bench.py`'s train
     rows; kernel launch counts reset just before and read just after
     (matching 1 and filter gradient 24 per step), and the bf16 wrapper's
     padding copies; losses finite; the checkpoint restores to the same
     step and weights;
  7b. training with device augmentation: `fit` for 5 steps on 44-block
     batches with the same GT; launch counts reset just before and read
     just after (matching 1, filter gradient 24, flip 2 per step); losses
     finite;
  8. one float32 train step at batch 2 on the card (kernels, TF32 off)
     against the same step on the port's CPU path (plain versions) from the
     same weights and batch: targets, loss, head gradients, updated
     parameters; and each of the step's 24 kernel filter gradients against
     its plain version on the same activations and output gradients;
  9. CUDA-event timings (median and range of 5 windows): forward + decode at
     batch 32 bf16 and its parts, the NMS kernel; the train step at batch 32
     bf16 with both kernels, with cuDNN's filter gradient (matching kernel
     on) and with both off (plain matching), interleaved, and a profiler
     window of the first two; the matching
     kernel, its plain version and bound on the train batch's IoUs, and on
     phase 4's as a worst case; the filter-gradient kernel and cuDNN's
     filter gradient per shape queued behind a device sleep (warm in the
     L2: both are bound by operations), the padding copies' share, the
     plain version, the bound, TFLOP/s and share of the bound, and their
     sums per step; one conv's forward and backward through the switch on
     and off, on the device and the host, and the host time to enqueue dW
     alone in each; (9c) the augment alone at
     batch 32, its host time and kernel launches; the flip kernel per launch
     at both shapes (queued behind a device sleep, so the host's launch rate
     does not bound it; cycling through inputs and outputs 4x the L2, so
     from main memory, and also warm in the L2) beside its bound and its
     plain version; the augmented train step against the un-augmented one in
     four interleaved pairs, with the difference per pair, and a profiler
     window of the augmented step;
 10. the `kernels` JSON line, the card line, and the final JSON line.

Weights are the port's seeded init (torch.Generator seeded 0); for inference
the BatchNorm running statistics are calibrated on the batch-32 request (one
train-mode forward), since identity statistics on N(0, 100) DCT planes drive
the activations, and the box offsets, to overflow.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, same source
H100_BF16_FLOPS = 989e12  # bf16 dense on the tensor cores, same source
H100_L2_BYTES = 50 * 2**20  # L2 cache, same source
NMS_OPS_PER_PAIR = 16  # 2x(min, max, sub, add d, max 0), mul, add, sub, max, div, cmp
KERNELS = ("batched_nms", "bipartite_match", "conv3x3_wgrad", "dct_flip")
# The GT of every image in the JAX package's train benchmark (`bench.py:136-140`):
# (class, xmin, ymin, xmax, ymax) in pixels of the 300x300 image.  The train
# batches that `fit` and the step timings run carry the same two boxes.
BENCH_GT = ((3, 30, 40, 160, 170), (7, 150, 60, 280, 240))
WGRAD_TOL = 1e-4  # max |kernel - plain| <= WGRAD_TOL * max |plain|: both sum in f32, in another order

# The 24 filter gradients of one `ssd_custom` train step: (H, C, K, count).
# 18 bottleneck 3x3 convs, then the 6 fused conf+loc head convs.
WGRAD_SHAPES = (
    (38, 256, 256, 1), (38, 128, 128, 4), (19, 256, 256, 1), (19, 128, 128, 3),
    (10, 256, 256, 6), (5, 512, 512, 3),
    (38, 384, 100, 1), (19, 512, 150, 1), (10, 1024, 150, 1), (5, 1024, 150, 1),
    (3, 256, 100, 1), (1, 256, 100, 1),
)
# bf16 cases that the step does not reach, (B, H, W, C, K): dy rows of 200
# and 300 bytes, which TMA cannot describe (the wrapper pads K to 104, 152),
# H != W with C = 40, and maps smaller than a stage's box.
WGRAD_RAGGED = (
    (32, 38, 38, 128, 100), (32, 38, 38, 128, 150), (32, 19, 19, 256, 100), (32, 19, 19, 256, 150),
    (3, 7, 9, 40, 24), (1, 1, 1, 256, 100), (1, 3, 3, 256, 100),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def nms_problems(rng, n, k):
    """N sorted NMS problems with clustered boxes, exact-tie scores, zero tails
    and pairs at IoU exactly f32(0.45) (not suppressed) and one ulp above."""
    centers = rng.uniform(20, 280, (n, 4, 2))
    pick = rng.integers(0, 4, (n, k))
    xy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 12, (n, k, 2))
    wh = rng.uniform(10, 60, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.01, 1, (n, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[:, : k // 8] = 1.0
    scores[:, -(k // 5 + 1):] = 0.0
    boxes[:, 0] = [100.0, 100.0, 120.0, 101.0]
    boxes[:, 1] = [100.0, 100.0, 109.0, 101.0]
    boxes[:, 2] = [200.0, 200.0, 220.0, 201.0]
    boxes[:, 3] = [200.0, 200.0, np.nextafter(np.float32(209.0), np.float32(300.0)), 201.0]
    return np.ascontiguousarray(boxes), np.ascontiguousarray(scores)


def gt_batch(rng, n_valid, max_gt=64, img=300):
    """Padded GT (B, max_gt, 5) float32 (class, xmin, ymin, xmax, ymax) in
    pixels and a (B, max_gt) mask, n_valid[i] boxes in image i; the second
    box of an image repeats the first (exact ties in matching)."""
    gt = np.zeros((len(n_valid), max_gt, 5), np.float32)
    mask = np.zeros((len(n_valid), max_gt), bool)
    for i, k in enumerate(n_valid):
        xy0 = rng.uniform(0, img - 60, (k, 2))
        xy1 = np.minimum(xy0 + rng.uniform(8, 220, (k, 2)), img)
        rows = np.concatenate([rng.integers(1, 21, (k, 1)), xy0, xy1], -1)
        if k >= 2:
            rows[1] = rows[0]
        gt[i, :k] = rows
        mask[i, :k] = True
    return gt, mask


def bench_gt(b, max_gt=64):
    """Padded GT (B, max_gt, 5) and mask with `BENCH_GT` in every image."""
    gt = np.zeros((b, max_gt, 5), np.float32)
    gt[:, :len(BENCH_GT)] = BENCH_GT
    mask = np.zeros((b, max_gt), bool)
    mask[:, :len(BENCH_GT)] = True
    return gt, mask


def train_batch(rng, gt, mask, dev, blocks=38):
    """A synthetic train batch on `dev`: DCT planes as `bench.py` makes them
    (Y ~ N(0, 100), CbCr ~ N(0, 30)), `blocks` luma blocks a side (38: the
    304-px input frame; 44: the 352-px source of the augmented step), and
    the padded GT `gt`, `mask`."""
    b = len(gt)
    y = rng.normal(0, 100, (b, blocks, blocks, 64)).astype(np.float32)
    cbcr = rng.normal(0, 30, (b, blocks // 2, blocks // 2, 128)).astype(np.float32)
    return {"inputs": (torch.from_numpy(y).to(dev), torch.from_numpy(cbcr).to(dev)),
            "gt": torch.from_numpy(gt).to(dev), "gt_mask": torch.from_numpy(mask).to(dev)}


def nms_bound(keep: torch.Tensor) -> tuple[float, str, int]:
    """Least time for the greedy NMS these inputs need: each kept candidate i
    (the alive ones at step i) is tested against the K-1-i later ones."""
    n, k = keep.shape
    pairs = int(((k - 1 - torch.arange(k, device=keep.device)) * keep).sum().item())
    ops = NMS_OPS_PER_PAIR * pairs
    nbytes = n * k * (4 * 4 + 4 + 1)  # boxes, scores in; keep out
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), pairs


def match_bound(sims: torch.Tensor) -> tuple[float, str]:
    """Read the similarities once, write the indices; one compare each."""
    b, m, n = sims.shape
    t_bytes = (b * m * n * 4 + b * m * 4) / H100_BYTES_PER_S
    t_ops = b * m * n / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def wgrad_bound(p: int, c: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """2*9*P*C*K operations at the dtype's peak; x and dy read once, dW
    (float32) written once."""
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    elem = torch.tensor([], dtype=dtype).element_size()
    t_ops = 2 * 9 * p * c * k / peak
    t_bytes = ((p * c + p * k) * elem + 9 * c * k * 4) / H100_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flip_bound(x: torch.Tensor) -> tuple[float, str]:
    """Read x once, write the flipped copy once; no arithmetic to speak of."""
    return 2 * x.numel() * x.element_size() / H100_BYTES_PER_S * 1e3, "bytes"


def calibrate_batch_norm(model, inputs) -> None:
    """Set every BatchNorm's running statistics to those of `inputs` (one
    train-mode forward with a cumulative average), then return to eval."""
    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    with torch.no_grad():
        model(inputs)
    model.eval()
    for m, momentum in zip(norms, saved):
        m.momentum = momentum


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}")


def timed(fn, iters, warmup_s=0.5):
    from jpeg_detection_resnet_ssd_torch.utils import cuda_times_ms

    times = cuda_times_ms(fn, iters=iters, windows=5, warmup_s=warmup_s)
    return float(np.median(times)), f"[{min(times):.4f}-{max(times):.4f}]"


def queued_ms(fn, x, iters=100, windows=5, cold=True):
    """Device ms per call of `fn` on a short kernel's input `x`.  Each window
    of `iters` calls is queued behind a device sleep of 2e7 cycles (~10 ms
    at the H100's clocks), so the events
    time the calls back to back on the device and not the host's launch rate;
    a window whose calls took the host longer than the sleep to enqueue is
    marked "host-bound" in the range, since it timed the host.
    With `cold`, the calls cycle through copies of `x` that together hold 4x
    the L2, and each window keeps its outputs alive, so every call reads its
    input from and writes its output to main memory; without, every call
    flips the same `x` into the output the allocator hands back each time,
    both warm in the L2."""
    n_copies = -(-4 * H100_L2_BYTES // (x.numel() * x.element_size())) if cold else 1
    inputs = [x.clone() for _ in range(n_copies)]
    times, host_bound = [], False
    for w in range(windows + 1):  # the first window warms the allocator's cache
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sleep = torch.cuda.Event(enable_timing=True)
        sleep.record()
        torch.cuda._sleep(20_000_000)
        start.record()
        t0 = time.perf_counter()
        outs = []
        for i in range(iters):
            if cold:
                outs.append(fn(inputs[i % n_copies]))
            else:
                fn(x)
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        del outs
        if w:
            times.append(start.elapsed_time(end) / iters)
            host_bound |= host_ms > sleep.elapsed_time(start)
    return float(np.median(times)), (f"[{min(times):.5f}-{max(times):.5f}]"
                                     + (" host-bound" if host_bound else ""))


def build_kernels() -> None:
    """One nvcc per source, all started together."""
    from jpeg_detection_resnet_ssd_torch.ops import _build

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        logs = dict(zip(KERNELS, pool.map(lambda k: _build.build(k, force=True), KERNELS)))
    for name in KERNELS:
        _build.load(name)
    print(f"    nvcc builds of ops/csrc/{{{','.join(KERNELS)}}}.cu: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"    ptxas [{name}]: {line.strip()}")


def check_nms(dev) -> float:
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms

    max_err = 0.0
    for n, k in ((640, 400), (7, 37)):
        boxes, scores = nms_problems(np.random.default_rng(n), n, k)
        b, s = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
        for delta in (0.0, 1.0, -1.0):
            got = batched_nms.batched_nms_mask(b, s, 0.45, delta)
            torch.cuda.synchronize()
            ref = batched_nms.batched_nms_mask_reference(b, s, 0.45, delta)
            max_err = max(max_err, (got.int() - ref.int()).abs().max().item())
            check(torch.equal(got, ref), f"mask equal at N={n} K={k} border_delta={delta:+.0f} "
                                         f"({int(ref.sum())} kept of {int((s > 0).sum())})")
            if delta == 0.0:
                check(bool(got[:, 1].all()) and not bool(got[:, 3].any()),
                      "IoU == f32(0.45) keeps, one ulp above suppresses")
    return max_err


def iou_sims(gt, mask, anchors):
    """(B, 64, 8732) IoUs of padded GT with the anchors, invalid rows -1:
    the target encoder's similarities."""
    from jpeg_detection_resnet_ssd_torch.boxes import geometry

    cent = geometry.corners_to_centroids(gt[..., 1:5] / 300.0)
    sims = geometry.iou_matrix(cent, anchors[:, :4], "centroids")
    return torch.where(mask[..., None], sims, -1.0).contiguous()


def check_match(dev, anchors) -> tuple[float, torch.Tensor]:
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm

    rng = np.random.default_rng(4)
    n_valid = [int(v) for v in rng.integers(1, 11, 32)]
    n_valid[5], n_valid[17] = 64, 0
    gt, mask = gt_batch(rng, n_valid)
    sims = iou_sims(torch.from_numpy(gt).to(dev), torch.from_numpy(mask).to(dev), anchors)
    ties = (rng.integers(-4, 16, (5, 64, 300)).astype(np.float32) / 16)
    ties[:, -3:] = -1.0
    max_err = 0
    for name, s in (("IoU sims (32, 64, 8732)", sims),
                    ("tie-heavy sims (5, 64, 300)", torch.from_numpy(ties).to(dev))):
        got = bm.bipartite_match(s, impl="kernel")
        torch.cuda.synchronize()
        ref = bm.bipartite_match_reference(s)
        max_err = max(max_err, int((got - ref).abs().max()))
        check(torch.equal(got, ref), f"{name}: matched indices equal ({int((ref >= 0).sum())} pairs)")
    got = bm.bipartite_match(sims, impl="kernel")
    check(bool(((got >= 0) == (sims.amax(-1) >= 0)).all()) and bool((got[17] < 0).all())
          and bool((got[5] >= 0).all()), "every valid row matched, none of the padding")
    return float(max_err), sims


def check_wgrad(dev) -> float:
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad

    gen = torch.Generator().manual_seed(5)
    worst = 0.0

    def held(x, dy, what):
        nonlocal worst
        got = conv_grad.conv3x3_filter_grad(x, dy)
        torch.cuda.synchronize()
        ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        worst = max(worst, err)
        check(err <= WGRAD_TOL * scale, f"dW {what}: max |diff| {err:.3g} <= {WGRAD_TOL:g} * {scale:.4g}")
        return got

    for h, c, k, count in WGRAD_SHAPES:
        x32 = torch.randn(32, h, h, c, generator=gen).to(dev)
        dy32 = torch.randn(32, h, h, k, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, dy = x32.to(dtype), dy32.to(dtype)
            got = held(x, dy, f"{str(dtype)[6:]:8s} B=32 {h}x{h} {c}->{k} (x{count})")
            if dtype == torch.bfloat16:
                again = conv_grad.conv3x3_filter_grad(x, dy)
                check(torch.equal(again.view(torch.int32), got.view(torch.int32)),
                      f"dW bfloat16 B=32 {h}x{h} {c}->{k}: a second call gives the same bits")
    for b, h, w, c, k in WGRAD_RAGGED:
        x = torch.randn(b, h, w, c, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(b, h, w, k, generator=gen).to(dev, torch.bfloat16)
        held(x, dy, f"bfloat16 B={b} {h}x{w} {c}->{k}")
    x = torch.randn(2 * 38 * 38 * 128 + 1, generator=gen).to(dev, torch.bfloat16)[1:].view(2, 38, 38, 128)
    dy = torch.randn(2, 38, 38, 128, generator=gen).to(dev, torch.bfloat16)
    before = conv_grad.PAD_COPIES
    held(x, dy, f"bfloat16 B=2 38x38 128->128, x 2 bytes past an aligned base "
                f"(data_ptr % 16 = {x.data_ptr() % 16})")
    check(conv_grad.PAD_COPIES == before + 1, "the misaligned x was copied once")
    x = torch.randn(3, 7, 9, 40, generator=gen, dtype=torch.float64)
    dy = torch.randn(3, 7, 9, 24, generator=gen, dtype=torch.float64)
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    oracle = torch.stack([xp[:, i:i + 7, j:j + 9, :].reshape(-1, 40).T @ dy.reshape(-1, 24)
                          for i in range(3) for j in range(3)]).reshape(3, 3, 40, 24)
    got = conv_grad.conv3x3_filter_grad(x.float().to(dev), dy.float().to(dev)).cpu().double()
    err = float((got - oracle).abs().max())
    check(err <= 1e-5 * float(oracle.abs().max()),
          f"dW f32 kernel vs float64 oracle at (3, 7, 9, 40->24): max |diff| {err:.3g}")
    return worst


def check_flip(dev) -> float:
    from jpeg_detection_resnet_ssd_torch.ops import dct_flip

    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    for shape, dtype in (((32, 38, 38, 64), torch.float32), ((32, 19, 19, 128), torch.float32),
                         ((7, 13, 9, 192), torch.float32), ((32, 38, 38, 64), torch.bfloat16)):
        x = (50 * torch.randn(shape, generator=gen)).to(dev, dtype)
        x.view(-1)[:2] = 0.0  # 0.0 in an odd column flips to -0.0, as the multiply gives
        before = dct_flip.LAUNCHES
        got = dct_flip.dct_flip_horizontal(x, impl="kernel")
        torch.cuda.synchronize()
        ref = dct_flip.dct_flip_horizontal_reference(x)
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        worst = max(worst, float((got.float() - ref.float()).abs().max()))
        check(dct_flip.LAUNCHES == before + 1 and torch.equal(got.view(bits), ref.view(bits)),
              f"flip {tuple(shape)} {str(dtype)[6:]}: kernel equals its plain version bit for bit")
    return worst


def augment_close(got, ref, rtol, quality=None) -> tuple[bool, str]:
    """(y, cbcr, gt, mask) on the card vs the CPU: masks exact, boxes within
    1e-3 px, coefficients within rtol of the largest CPU value; requantized,
    at most 1e-4 of them one quantizer step apart."""
    from jpeg_detection_resnet_ssd_torch.ops.jpeg_quant import quant_tables

    got = [t.cpu() for t in got]
    ok = torch.equal(got[3], ref[3])
    box = float((got[2] - ref[2]).abs().max())
    ok &= box <= 1e-3
    notes = [f"boxes max |diff| {box:.3g} px"]
    for i, (a, b) in enumerate(zip(got[:2], ref[:2])):
        if quality is None:
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            ok &= err <= rtol * scale
            notes.append(f"{('y', 'cbcr')[i]} max |diff| {err:.3g} (scale {scale:.4g})")
            continue
        qy, qc = quant_tables(quality)
        q = torch.from_numpy(qy if i == 0 else np.concatenate([qc, qc])).float()
        diff = a != b
        n = int(diff.sum())
        ok &= n <= 1e-4 * a.numel() and bool(
            torch.allclose((a - b).abs()[diff], q.expand_as(a)[diff], rtol=1e-6))
        notes.append(f"{('y', 'cbcr')[i]} {n} of {a.numel()} one step apart")
    return bool(ok), "; ".join(notes)


def check_chain(dev) -> None:
    from jpeg_detection_resnet_ssd_torch.ops import _draws, dct_flip, make_dct_detection_augment_v3

    rng = np.random.default_rng(10)
    batch = train_batch(rng, *bench_gt(4), "cpu", blocks=44)
    for photometric, quality in ((True, None), ("pixel_hsv", None), (True, 75)):
        kw = dict(out_y_blocks=38, photometric=photometric, requantize_quality=quality)
        gpu, cpu = make_dct_detection_augment_v3(**kw), make_dct_detection_augment_v3(**kw, device="cpu")
        draws = cpu.sample(len(batch["gt"]), 44, 44, torch.Generator().manual_seed(11))
        dct_flip.LAUNCHES = 0
        out = gpu.apply(gpu.to_device(batch), _draws.to_device(draws, dev))
        torch.cuda.synchronize()
        launches = dct_flip.LAUNCHES
        ref = cpu.apply(cpu.to_device(batch), draws)
        ok, notes = augment_close([*out["inputs"], out["gt"], out["gt_mask"]],
                                  [*ref["inputs"], ref["gt"], ref["gt_mask"]],
                                  1e-4 if photometric == "pixel_hsv" else 1e-5, quality)
        check(ok and launches == 2, f"chain photometric={photometric!r} requantize={quality}: card "
                                    f"= CPU ({notes}); {launches} flip launches, "
                                    f"{int(ref['gt_mask'].sum())} GT boxes kept")


def run_inference(dev, card):
    """Phase 6 (checks) and the inference half of phase 9 (timings)."""
    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
    from jpeg_detection_resnet_ssd_torch.boxes.decode import decode_detections, select_candidates
    from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms

    print("[6] inference path (TF32 off for cuDNN convolutions and matmuls)")
    rng = np.random.default_rng(0)
    y32 = torch.from_numpy(rng.normal(0, 100, (32, 38, 38, 64)).astype(np.float32)).to(dev)
    c32 = torch.from_numpy(rng.normal(0, 30, (32, 19, 19, 128)).astype(np.float32)).to(dev)
    y1, c1 = y32[:1].clone(), c32[:1].clone()
    t0 = time.perf_counter()
    model_f32, _ = build_model("ssd300_ssd_custom", n_classes=20, dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
    calibrate_batch_norm(model_f32, (y32, c32))
    model_bf16, _ = build_model("ssd300_ssd_custom", n_classes=20, dtype=torch.bfloat16,
                                generator=torch.Generator().manual_seed(0))
    model_bf16.load_state_dict(model_f32.state_dict())
    n_params = sum(p.numel() for p in model_f32.parameters())
    print(f"    built, calibrated and copied the model ({n_params} parameters) "
          f"in {time.perf_counter() - t0:.2f} s")
    spec = AnchorSpec()
    decode = {sel: make_inference_fn(n_classes=20, spec=spec, candidate_selector=sel)
              for sel in ("shared", "exact")}

    batched_nms.LAUNCHES = 0
    with torch.no_grad():
        raw_bf16 = model_bf16((y32, c32))
        det_bf16 = {sel: fn(raw_bf16) for sel, fn in decode.items()}
        raw_f32 = model_f32((y1, c1))
        det_f32 = {sel: fn(raw_f32) for sel, fn in decode.items()}
    torch.cuda.synchronize()
    launches = batched_nms.LAUNCHES
    print(f"    NMS kernel launches on the inference path: {launches}")
    check(launches == 4, "every request and selector ran the NMS kernel")

    anchors = torch.from_numpy(build_anchors(spec, ssd_predictor_sizes("resnet_custom"))).to(dev)
    for name, raw, batch in (("bf16 batch 32", raw_bf16, 32), ("f32 batch 1", raw_f32, 1)):
        check(raw.shape == (batch, 8732, 33) and raw.dtype == torch.float32,
              f"{name}: raw predictions (B, 8732, 33) float32")
        check(bool(torch.isfinite(raw).all()), f"{name}: raw predictions finite")
        check(float((raw[..., :21].sum(-1) - 1).abs().max()) < 1e-5, f"{name}: softmax rows sum to 1")
        if batch == 1:  # the f32 request; bf16 compute rounds the anchor columns
            check(torch.equal(raw[0, :, 21 + 4:], anchors), f"{name}: anchors and variances exact")
    for name, dets, batch in (("bf16 batch 32", det_bf16, 32), ("f32 batch 1", det_f32, 1)):
        for sel, det in dets.items():
            n_det = int((det[..., 1] > 0).sum())
            check(det.shape == (batch, 200, 6) and bool(torch.isfinite(det).all()) and n_det > 0,
                  f"{name} {sel}: (B, 200, 6) finite detections, {n_det} with score > 0")

    kw = dict(n_classes=20, img_height=spec.img_height, img_width=spec.img_width)
    for name, raw in (("bf16 batch 32", raw_bf16), ("f32 batch 1", raw_f32)):
        for sel in ("shared", "exact"):
            got = decode_detections(raw, nms_impl="kernel", candidate_selector=sel, **kw)
            ref = decode_detections(raw, nms_impl="reference", candidate_selector=sel, **kw)
            check(torch.equal(got, ref), f"{name} {sel}: kernel and plain NMS detections identical")

    model_cpu, _ = build_model("ssd300_ssd_custom", n_classes=20, device="cpu")
    model_cpu.load_state_dict(model_f32.state_dict())
    with torch.no_grad():
        raw_cpu = model_cpu((y1.cpu(), c1.cpu()))
    # cuDNN's f32 algorithms and the CPU's sum in other orders over ~60
    # convolutions; on the calibrated model that moves conf and loc by ~1e-4
    # of their largest value (H100 run), so the check allows 1e-3.
    for block, cols in (("conf", slice(0, 21)), ("loc", slice(21, 25))):
        a, b = raw_f32[..., cols].cpu(), raw_cpu[..., cols]
        err = float((a - b).abs().max())
        tol = 1e-3 * float(b.abs().max())
        ok = bool(((a - b).abs() <= tol + 1e-3 * b.abs()).all())
        check(ok, f"f32 batch 1 {block}: card vs CPU forward max |diff| {err:.3g} "
                  f"(rtol 1e-3, atol {tol:.3g})")
    det_cpu = decode_detections(raw_f32.cpu(), candidate_selector="shared", **kw)
    det_gpu = det_f32["shared"].cpu()
    check(torch.equal(det_gpu[..., :2], det_cpu[..., :2])
          and float((det_gpu[..., 2:] - det_cpu[..., 2:]).abs().max()) <= 1e-3,
          "f32 batch 1 shared: card detections = CPU decode of the same raw predictions")
    with torch.no_grad():
        raw_f32_b32 = model_f32((y32, c32))
    print(f"    info: bf16 vs f32 raw predictions at batch 32: conf max |diff| "
          f"{float((raw_bf16[..., :21] - raw_f32_b32[..., :21]).abs().max()):.4g}, "
          f"loc max |diff| {float((raw_bf16[..., 21:25] - raw_f32_b32[..., 21:25]).abs().max()):.4g}")

    print(f"[9a] inference timings (CUDA events; median of 5 windows [min-max]) on {card}")
    with torch.no_grad():
        e2e_ms, e2e_spread = timed(lambda: decode["shared"](model_bf16((y32, c32))), 10)
        fwd_ms, fwd_spread = timed(lambda: model_bf16((y32, c32)), 10)
        dec_ms, dec_spread = timed(lambda: decode["shared"](raw_bf16), 10)
        dec_exact_ms, dec_exact_spread = timed(lambda: decode["exact"](raw_bf16), 10)
        with FlopCounterMode(display=False) as flops:
            model_bf16((y32, c32))
    fwd_flops = flops.get_total_flops()
    host_ms = []  # enqueue only: launches are asynchronous, the queue holds a whole forward
    with torch.no_grad():
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model_bf16((y32, c32))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"    forward + shared decode, batch 32 bf16: {e2e_ms:.4f} ms/batch {e2e_spread} = "
          f"{32e3 / e2e_ms:.1f} images/s  [{card}]")
    print(f"    forward alone: {fwd_ms:.4f} ms {fwd_spread}; shared decode alone: {dec_ms:.4f} ms "
          f"{dec_spread}; exact decode alone: {dec_exact_ms:.4f} ms {dec_exact_spread}  [{card}]")
    print(f"    forward host enqueue time: {float(np.median(host_ms)):.4f} ms "
          f"[{min(host_ms):.4f}-{max(host_ms):.4f}] (median of 10, host clock)")
    print(f"    forward: {fwd_flops / 1e9:.1f} GFLOP per batch of 32 -> "
          f"{fwd_flops / (fwd_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
          f"{100 * fwd_flops / (fwd_ms * 1e-3) / H100_BF16_FLOPS:.1f}% of the bf16 dense peak")

    top_scores, top_boxes = select_candidates(raw_bf16, n_classes=20, candidate_selector="shared")
    nb = top_boxes.reshape(32 * 20, -1, 4)
    ns = top_scores.reshape(32 * 20, -1)
    keep = batched_nms.batched_nms_mask(nb, ns)
    kernel_ms, kernel_spread = timed(lambda: batched_nms.batched_nms_mask(nb, ns), 50)
    plain_ms, plain_spread = timed(lambda: batched_nms.batched_nms_mask_reference(nb, ns), 1)
    bound_ms, bound_by, pairs = nms_bound(keep)
    alive = int((ns > 0).sum())
    print(f"    NMS at the inference path's shape N={nb.shape[0]} K={nb.shape[1]}: {alive} candidates "
          f"with score > 0, {int(keep.sum())} kept, {pairs} pair tests needed")
    print(f"    NMS kernel: {kernel_ms:.5f} ms {kernel_spread}; plain PyTorch version: "
          f"{plain_ms:.4f} ms {plain_spread}; bound {bound_ms:.6f} ms ({bound_by}); library: "
          f"none (no single PyTorch call computes a greedy-NMS keep mask)  [{card}]")
    return {"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def profile_steps(step, card, step_ms, n=3, label="train steps with both kernels"):
    """Where a train step's time goes: torch.profiler over n steps (after
    one untraced); the kernels' summed device time per step against the
    step's time without the profiler (`step_ms`, CUDA events), and the
    largest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        print("    profiler: no device time recorded; device busy share not measured")
        return
    print(f"    profiler, {n} {label}: kernels busy {busy_ms:.3f} ms per step, "
          f"{sum(e.count for e in kernels) // n} kernel launches per step; against the "
          f"{step_ms:.3f} ms step the device is idle {100 * max(0.0, 1 - busy_ms / step_ms):.1f}% "
          f" [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"      {e.self_device_time_total / 1e3 / n:9.3f} ms  x{e.count // n:<5d} {e.key[:90]}")


def encoder_sims(encoder, batch):
    """The similarities `encoder` hands the matching kernel for `batch`."""
    from jpeg_detection_resnet_ssd_torch.boxes import target_encoder

    match, seen = target_encoder.bipartite_match, []

    def record(sims, impl):
        seen.append(sims.clone())
        return match(sims, impl=impl)

    target_encoder.bipartite_match = record
    try:
        encoder(batch["gt"], batch["gt_mask"])
    finally:
        target_encoder.bipartite_match = match
    return seen[0]


def run_training(dev, card, stress_sims):
    """Phases 7 and 8 (checks) and the training half of phase 9 (timings)."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models import layers
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad
    from jpeg_detection_resnet_ssd_torch.train import (
        CheckpointManager, ExperimentConfig, build_trainer, fit,
    )

    sizes = ssd_predictor_sizes("resnet_custom")
    print("[7] training path: fit, 5 steps at batch 32 in bf16, both kernels on")
    rng = np.random.default_rng(7)
    batches = [train_batch(rng, *bench_gt(32), dev) for _ in range(5)]
    cfg = ExperimentConfig(model="ssd300_ssd_custom", pallas_wgrad=True, compute_dtype="bfloat16",
                           batch_size=32, epochs=5, steps_per_epoch=1)
    encoder = TargetEncoder(AnchorSpec(), sizes, bipartite_impl="auto")
    with tempfile.TemporaryDirectory() as run_dir:
        t0 = time.perf_counter()
        bm.LAUNCHES = conv_grad.LAUNCHES = conv_grad.LAYOUT_COPIES = conv_grad.PAD_COPIES = 0
        trainer, history = fit(cfg, batches, run_dir=run_dir, target_encoder=encoder,
                               log_every=1, save_every=5)
        torch.cuda.synchronize()
        launches = {"match": bm.LAUNCHES, "wgrad": conv_grad.LAUNCHES}
        copies, pads = conv_grad.LAYOUT_COPIES, conv_grad.PAD_COPIES
        print(f"    fit: {time.perf_counter() - t0:.2f} s (first step builds nothing: kernels "
              f"were built in phase 2); losses "
              + ", ".join(f"{r['total_loss']:.4f}" for r in history))
        print(f"    kernel launches on the training path: matching {launches['match']}, "
              f"filter gradient {launches['wgrad']}; layout copies before the filter-gradient "
              f"kernel: {copies}; padding copies for TMA: {pads} ({pads / 5:g} per step)")
        check(len(history) == 5 and all(np.isfinite(r["total_loss"]) for r in history),
              "5 steps, every loss finite")
        check(launches["match"] == 5, "the matching kernel ran once per step")
        check(launches["wgrad"] == 24 * 5, "the filter-gradient kernel ran 24 times per step")
        ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
        check(ckpt.all_steps() == [5], "a checkpoint was written at step 5")
        fresh, _, _ = build_trainer(cfg)
        ckpt.restore(fresh)
        same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                      trainer.model.state_dict().values()))
        check(fresh.step == 5 and same, "the checkpoint restores to step 5 with the same weights")
        del fresh

    print("[8] one float32 step at batch 2: card (kernels, TF32 off) vs the port's CPU path")
    cfg32 = ExperimentConfig(compute_dtype="float32", pallas_wgrad=True, batch_size=2)
    rng = np.random.default_rng(8)
    small = train_batch(rng, *gt_batch(rng, [3, 7]), dev)
    small_cpu = {"inputs": tuple(t.cpu() for t in small["inputs"]),
                 "gt": small["gt"].cpu(), "gt_mask": small["gt_mask"].cpu()}
    enc_gpu = TargetEncoder(AnchorSpec(), sizes)
    enc_cpu = TargetEncoder(AnchorSpec(), sizes, device="cpu")
    t_gpu = enc_gpu(small["gt"], small["gt_mask"]).cpu()
    t_cpu = enc_cpu(small_cpu["gt"], small_cpu["gt_mask"])
    check(torch.equal(t_gpu[..., :21], t_cpu[..., :21]) and torch.equal(t_gpu[..., 25:], t_cpu[..., 25:]),
          "targets: one-hot, anchor and variance columns identical")
    off_err = float((t_gpu[..., 21:25] - t_cpu[..., 21:25]).abs().max())
    check(off_err <= 1e-5, f"targets: offsets max |diff| {off_err:.3g} <= 1e-5")
    gpu, gpu_model, _ = build_trainer(cfg32, target_encoder=enc_gpu)
    cpu, cpu_model, _ = build_trainer(cfg32, target_encoder=enc_cpu, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    # Every filter gradient the card's step takes from the kernel, with the
    # activations and output gradients it was given.
    kernel, recorded = conv_grad.conv3x3_filter_grad, []

    def record(x, dy):
        dw = kernel(x, dy)
        recorded.append((x.clone(), dy.clone(), dw.clone()))
        return dw

    conv_grad.conv3x3_filter_grad = record
    try:
        m_gpu = gpu.train_step(small)
    finally:
        conv_grad.conv3x3_filter_grad = kernel
    m_cpu = cpu.train_step(small_cpu)
    check(len(recorded) == 24, f"the card's step took {len(recorded)} filter gradients from the kernel")
    step_err, worst_share, n_zero = 0.0, 0.0, 0
    for x, dy, got in recorded:
        ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        step_err = max(step_err, err)
        n_zero += scale == 0.0  # an all-zero input (a map that ReLU zeroed) or output gradient
        worst_share = max(worst_share, err / scale if scale else (0.0 if err == 0.0 else np.inf))
    check(worst_share <= WGRAD_TOL,
          f"kernel dW on the step's own activations and output gradients vs its plain version: "
          f"worst max |diff| {worst_share:.3g} <= {WGRAD_TOL:g} of max |ref| over the 24 convs "
          f"({n_zero} with dW exactly 0, matched exactly)")
    del recorded
    for key in ("loss", "reg", "total_loss"):
        a, b = float(m_gpu[key]), float(m_cpu[key])
        check(abs(a - b) <= 1e-4 * abs(b), f"{key}: card {a:.6f} vs CPU {b:.6f} (rtol 1e-4)")
    # The kernel's dW is held to its plain version on the step's own tensors
    # (above).  Against the CPU's step, the head's filter gradients are well
    # conditioned; the trunk's are not at this random init (a change of one
    # part in 1e7 of the input moves the port's own stage-4/5 gradients by
    # up to 30% of their largest entry, CPU measurement), so an updated
    # parameter is held to the step's own size: |card - CPU| <= 1e-6 max|p|
    # + lr * max|grad| (the first step moves p by lr * grad).  A bias whose
    # gradient is 0 in exact arithmetic (its conv feeds a train-mode
    # BatchNorm) is scaled by its layer's weight gradient.
    g_cpu = {k: p.grad for k, p in cpu_model.named_parameters()}
    worst_head = 0.0
    for k, p in gpu_model.named_parameters():
        if "_mbox_" in k and k.endswith("weight"):
            ref = g_cpu[k]
            worst_head = max(worst_head, float((p.grad.cpu() - ref).abs().max() / ref.abs().max()))
    check(worst_head <= 1e-3, f"head filter gradients within {worst_head:.3g} <= 1e-3 of max |ref|")
    ratios = {}
    for k, p in cpu_model.named_parameters():
        p = p.detach()
        zero_grad = k.endswith(".bias") and (k.startswith("res") or k.startswith("bn_"))
        scale = float(g_cpu[k[: -len("bias")] + "weight" if zero_grad else k].abs().max())
        diff = float((gpu_model.get_parameter(k).detach().cpu() - p).abs().max())
        ratios[k] = diff / (1e-6 * float(p.abs().max()) + cfg32.learning_rate * scale + 1e-30)
    worst = max(ratios, key=ratios.get)
    check(ratios[worst] <= 1.0, f"updated parameters: worst {worst} at {ratios[worst]:.3g} of its "
                                f"tolerance; median {float(np.median(list(ratios.values()))):.3g}")
    del gpu, cpu, gpu_model, cpu_model

    print(f"[9b] training timings (CUDA events; median of 5 windows [min-max]) on {card}")
    batch = batches[0]
    cfg_off = ExperimentConfig(compute_dtype="bfloat16", pallas_wgrad=False, batch_size=32)
    cudnn, _, _ = build_trainer(cfg_off, target_encoder=encoder)
    off, _, _ = build_trainer(cfg_off, target_encoder=TargetEncoder(AnchorSpec(), sizes,
                                                                    bipartite_impl="reference"))
    arms = {"on": trainer, "cudnn": cudnn, "off": off}
    step_ms = {arm: [] for arm in arms}
    for pair in range(4):  # the order turns round every pair
        for arm in (("on", "cudnn", "off") if pair % 2 == 0 else ("off", "cudnn", "on")):
            step_ms[arm].append(timed(lambda: arms[arm].train_step(batch), 2, warmup_s=1.0))
    for arm, label in (("on", "both kernels"), ("cudnn", "cuDNN dW, matching kernel"),
                       ("off", "both off: cuDNN dW, plain matching")):
        ms = [m for m, _ in step_ms[arm]]
        print(f"    train step, batch 32 bf16, {label}: " + ", ".join(
            f"{m:.3f} ms {spread}" for m, spread in step_ms[arm])
            + f" -> {32e3 / np.mean(ms):.1f} images/s  [{card}]")
    diffs = [a - c for (a, _), (c, _) in zip(step_ms["on"], step_ms["cudnn"])]
    print("    step with the B4 kernel minus step with cuDNN's dW, per round: "
          + ", ".join(f"{d:+.3f}" for d in diffs) + f" ms; median {float(np.median(diffs)):+.3f} ms "
          + ("(every round agrees in sign)" if min(diffs) > 0 or max(diffs) < 0
             else "(not resolved: the rounds differ in sign)"))
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"    train step (kernels) host time to return: {float(np.median(host_ms)):.3f} ms "
          f"[{min(host_ms):.3f}-{max(host_ms):.3f}] (median of 5, host clock)")
    profile_steps(lambda: cudnn.train_step(batch), card,
                  float(np.median([m for m, _ in step_ms["cudnn"]])),
                  label="train steps with cuDNN's dW and the matching kernel")
    del off, cudnn, arms
    profile_steps(lambda: trainer.train_step(batch), card,
                  float(np.median([m for m, _ in step_ms["on"]])))

    sims = encoder_sims(encoder, batch)
    m_ms, m_spread = timed(lambda: bm.bipartite_match(sims, impl="kernel"), 20, warmup_s=0.2)
    mp_ms, mp_spread = timed(lambda: bm.bipartite_match_reference(sims), 2, warmup_s=0.2)
    mb_ms, mb_by = match_bound(sims)
    print(f"    matching at (32, 64, 8732) on the train batch's IoUs ({len(BENCH_GT)} GT per image): "
          f"kernel {m_ms:.5f} ms {m_spread}; plain {mp_ms:.4f} ms {mp_spread}; bound {mb_ms:.6f} ms "
          f"({mb_by}); library: none  [{card}]")
    s_ms, s_spread = timed(lambda: bm.bipartite_match(stress_sims, impl="kernel"), 20, warmup_s=0.2)
    sp_ms, sp_spread = timed(lambda: bm.bipartite_match_reference(stress_sims), 2, warmup_s=0.2)
    print(f"    matching, worst case: phase 4's IoUs (1-10 GT per image, one image of 64, duplicate "
          f"boxes): kernel {s_ms:.5f} ms {s_spread}; plain {sp_ms:.4f} ms {sp_spread}  [{card}]")

    # B4 per shape, queued behind a device sleep so that the host's launch
    # rate does not bound it, on the same x and dy every call: warm in the
    # L2 as far as they fit (the largest conv's x and dy are 47 MB, the L2
    # 50 MB), which is right for a kernel bound by operations.  The
    # wrapper's time includes its padding copy (K = 100, 150), timed alone
    # beside it.
    print("    filter gradient per conv, bf16, batch 32, queued behind a device sleep, inputs warm "
          "in the L2 (bound by operations)")
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "pad_ms": 0.0}
    bound_by = {"operations": 0, "bytes": 0}
    gen = torch.Generator().manual_seed(9)
    for h, c, k, count in WGRAD_SHAPES:
        x = torch.randn(32, h, h, c, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(32, h, h, k, generator=gen).to(dev, torch.bfloat16)
        w = torch.zeros(k, c, 3, 3, device=dev, dtype=torch.bfloat16)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        plan = conv_grad.tiling_plan(32, h, h, c, k)
        kern, kern_s = queued_ms(lambda _: conv_grad.conv3x3_filter_grad(x, dy), x, iters=50, cold=False)
        lib, lib_s = queued_ms(lambda _: torch.ops.aten.convolution_backward(
            dyn, xn, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False]), x,
            iters=50, cold=False)
        pad = 0.0
        if plan.k_pad != k:
            pad, _ = queued_ms(lambda _: conv_grad._tma_operand(dy, plan.k_pad), x, iters=50, cold=False)
        plain, _ = timed(lambda: conv_grad.conv3x3_filter_grad_reference(x, dy), 3, warmup_s=0.1)
        bound, by = wgrad_bound(32 * h * h, c, k, torch.bfloat16)
        for key, v in (("ms", kern), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound),
                       ("pad_ms", pad)):
            sums[key] += count * v
        bound_by[by] += count
        tflops = 2 * 9 * 32 * h * h * c * k / (kern * 1e-3) / 1e12
        print(f"    dW bf16 B=32 {h:2d}x{h:<2d} {c:4d}->{k:<4d} x{count}: kernel {kern:.5f} ms {kern_s} "
              + (f"(padding dy to {plan.k_pad} channels {pad:.5f}) " if pad else "")
              + f"= {tflops:.1f} TFLOP/s, {100 * bound / kern:.1f}% of the bound {bound:.5f} ({by}); "
              f"cuDNN {lib:.5f} {lib_s}; kernel/cuDNN {kern / lib:.2f}; plain {plain:.4f}; tile "
              f"{conv_grad.BLOCK_C}x{plan.n_tile}, box {plan.w_box}x{plan.rows}x{plan.images}, "
              f"{plan.splits} splits, ring {plan.ring}")
    print(f"    dW per train step (24 convs): kernel {sums['ms']:.4f} ms (of which padding copies "
          f"{sums['pad_ms']:.4f}), {100 * sums['bound_ms'] / sums['ms']:.1f}% of the bound "
          f"{sums['bound_ms']:.4f} ms; cuDNN {sums['library_ms']:.4f} ms; plain {sums['plain_ms']:.4f} ms "
          f"({bound_by['operations']} convs bound by operations, {bound_by['bytes']} by bytes)  [{card}]")
    del sums["pad_ms"]

    # Where the step's difference between the arms comes from: one conv's
    # forward and backward through `layers.conv3x3_same` with the switch on
    # (the autograd Function: cuDNN forward, a separate dx call, the kernel,
    # dW cast to bf16, the bias added outside, as in the JAX package) and
    # off (one cuDNN conv with its bias), on the device and on the host.
    x = torch.randn(32, 38, 38, 128, generator=gen).to(dev, torch.bfloat16).requires_grad_(True)
    w = (0.05 * torch.randn(128, 128, 3, 3, generator=gen)).to(dev, torch.bfloat16).requires_grad_(True)
    bias = torch.zeros(128, device=dev, dtype=torch.bfloat16, requires_grad=True)
    g = torch.randn(32, 38, 38, 128, generator=gen).to(dev, torch.bfloat16)

    def conv_fwd_bwd(on):
        with layers.pallas_wgrad(on):
            torch.autograd.grad(layers.conv3x3_same(x, w, bias), (x, w, bias), g)

    for on, label in ((True, "switch on (B4)"), (False, "switch off (cuDNN)")):
        dev_ms, dev_s = queued_ms(lambda _: conv_fwd_bwd(on), x, iters=8, cold=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            conv_fwd_bwd(on)
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(f"    one 38x38 128->128 conv, forward + backward, {label}: device {dev_ms:.4f} ms {dev_s} "
              f"(queued behind a device sleep), host {host_ms:.4f} ms to enqueue (host clock)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        conv_grad.conv3x3_filter_grad(x.detach(), g)
    wrapper_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        torch.ops.aten.convolution_backward(g.permute(0, 3, 1, 2), x.detach().permute(0, 3, 1, 2), w.detach(),
                                            None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                                            [False, True, False])
    cudnn_ms = (time.perf_counter() - t0) / 50 * 1e3
    torch.cuda.synchronize()
    print(f"    host time to enqueue dW alone: B4's wrapper {wrapper_ms:.4f} ms, cuDNN's "
          f"convolution_backward {cudnn_ms:.4f} ms (host clock, mean of 50)")
    return {
        "match": {"launches": launches["match"], "ms": m_ms, "plain_ms": mp_ms,
                  "bound_ms": mb_ms, "bound_by": mb_by},
        "wgrad": {"launches": launches["wgrad"], **sums,
                  "bound_by": max(bound_by, key=bound_by.get)},
        "wgrad_step_err": step_err,
        "trainer": trainer,
        "batch": batch,
    }


def run_augmented_training(dev, card, trainer, batch):
    """Phase 7b (checks) and 9c (timings): the train step through the device
    augmentation chain; `trainer` and `batch` are phase 7's un-augmented
    ones, timed against it."""
    from torch.profiler import ProfilerActivity, profile

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad, dct_flip, make_dct_detection_augment_v3
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, fit

    print("[7b] training with device augmentation: fit, 5 steps at batch 32 in bf16, 352-px "
          "source maps, all three kernels on")
    rng = np.random.default_rng(12)
    batches = [train_batch(rng, *bench_gt(32), dev, blocks=44) for _ in range(5)]
    cfg = ExperimentConfig(model="ssd300_ssd_custom", pallas_wgrad=True, compute_dtype="bfloat16",
                           batch_size=32, epochs=5, steps_per_epoch=1)
    encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304),
                            ssd_predictor_sizes("resnet_custom"), bipartite_impl="auto")
    aug = make_dct_detection_augment_v3(out_y_blocks=38)
    t0 = time.perf_counter()
    bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
    aug_trainer, history = fit(cfg, batches, target_encoder=encoder, augment_fn=aug, log_every=1)
    torch.cuda.synchronize()
    launches = {"match": bm.LAUNCHES, "wgrad": conv_grad.LAUNCHES, "flip": dct_flip.LAUNCHES}
    print(f"    fit: {time.perf_counter() - t0:.2f} s; losses "
          + ", ".join(f"{r['total_loss']:.4f}" for r in history))
    print(f"    kernel launches on the augmented training path: matching {launches['match']}, "
          f"filter gradient {launches['wgrad']}, flip {launches['flip']}")
    check(len(history) == 5 and all(np.isfinite(r["total_loss"]) for r in history),
          "5 augmented steps, every loss finite")
    check(launches["match"] == 5, "the matching kernel ran once per step")
    check(launches["wgrad"] == 24 * 5, "the filter-gradient kernel ran 24 times per step")
    check(launches["flip"] == 2 * 5, "the flip kernel ran twice per step (luma and chroma)")

    print(f"[9c] augmentation timings (CUDA events; median of 5 windows [min-max]) on {card}")
    src = batches[0]
    gen = torch.Generator().manual_seed(13)
    aug_ms, aug_spread = timed(lambda: aug(src, gen), 10)
    host_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug(src, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        aug(src, gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    n_kernels = sum(e.count for e in kernels)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"    augment alone (v3, photometric + expand/crop/resize + flip), batch 32 from 44 "
          f"blocks: {aug_ms:.4f} ms {aug_spread}; host time to return {float(np.median(host_ms)):.4f} "
          f"ms [{min(host_ms):.4f}-{max(host_ms):.4f}] (median of 10, host clock); "
          f"{n_kernels} device kernels and copies, busy {busy_ms:.4f} ms (profiler)  [{card}]")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"      {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:90]}")

    flipped = aug(src, gen)["inputs"]
    sums = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for x in flipped:
        k_ms, k_spread = queued_ms(lambda t: dct_flip.dct_flip_horizontal(t, impl="kernel"), x)
        p_ms, p_spread = queued_ms(dct_flip.dct_flip_horizontal_reference, x)
        warm_ms, warm_spread = queued_ms(lambda t: dct_flip.dct_flip_horizontal(t, impl="kernel"),
                                         x, cold=False)
        ev_ms, ev_spread = timed(lambda: dct_flip.dct_flip_horizontal(x, impl="kernel"), 50,
                                 warmup_s=0.1)
        b_ms, b_by = flip_bound(x)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
            sums[key] += v
        print(f"    flip {tuple(x.shape)} {str(x.dtype)[6:]}, from main memory: kernel {k_ms:.5f} ms "
              f"{k_spread} ({100 * b_ms / k_ms:.1f}% of the bound); plain {p_ms:.5f} ms {p_spread}; "
              f"bound {b_ms:.5f} ms ({b_by}); library: none; the same input and output warm in the "
              f"L2: kernel {warm_ms:.5f} ms {warm_spread}; one call at the host's rate "
              f"{ev_ms:.5f} ms {ev_spread}  [{card}]")
    print(f"    flip per train step (2 launches): kernel {sums['ms']:.5f} ms, plain "
          f"{sums['plain_ms']:.5f} ms, bound {sums['bound_ms']:.5f} ms  [{card}]")

    # Four interleaved pairs, alternating which arm goes first; the host
    # moves the step by tens of ms from window to window, so the difference
    # is read pair by pair.
    step_ms = {"aug": [], "plain": []}
    for pair in range(4):
        for arm in (("aug", "plain") if pair % 2 == 0 else ("plain", "aug")):
            fn = ((lambda: aug_trainer.train_step(src, gen)) if arm == "aug"
                  else (lambda: trainer.train_step(batch)))
            step_ms[arm].append(timed(fn, 2, warmup_s=1.0))
    for arm, label in (("aug", "augmented (352-px source through the chain)"),
                       ("plain", "un-augmented (304-px input, no chain)")):
        ms = [m for m, _ in step_ms[arm]]
        print(f"    train step, batch 32 bf16, all kernels, {label}: " + ", ".join(
            f"{m:.3f} ms {spread}" for m, spread in step_ms[arm])
            + f" -> {32e3 / np.mean(ms):.1f} images/s  [{card}]")
    diffs = [a - p for (a, _), (p, _) in zip(step_ms["aug"], step_ms["plain"])]
    resolved = min(diffs) > 0 or max(diffs) < 0
    print("    augmented minus un-augmented, per pair: " + ", ".join(f"{d:+.3f}" for d in diffs)
          + f" ms; median {float(np.median(diffs)):+.3f} ms "
          + ("(every pair agrees in sign)" if resolved else "(not resolved: the pairs differ in sign)"))
    host_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aug_trainer.train_step(src, gen)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"    augmented train step host time to return: {float(np.median(host_ms)):.3f} ms "
          f"[{min(host_ms):.3f}-{max(host_ms):.3f}] (median of 5, host clock)")
    profile_steps(lambda: aug_trainer.train_step(src, gen), card,
                  float(np.median([m for m, _ in step_ms["aug"]])),
                  label="augmented train steps with all kernels")
    return {"launches": launches["flip"], **sums, "bound_by": "bytes"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    print("[2] build")
    build_kernels()

    print("[3] NMS kernel against its plain version")
    nms_err = check_nms(dev)

    # TF32 would round float32 matmul and convolution inputs to 10 bits:
    # every float32 check (plain versions, card vs CPU) runs in full float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print("[4] matching kernel against its plain version")
    anchors = torch.from_numpy(build_anchors(
        AnchorSpec(), ssd_predictor_sizes("resnet_custom"), coords="centroids")).to(dev)
    match_err, stress_sims = check_match(dev, anchors)

    print(f"[5] filter-gradient kernel against its plain version (tolerance {WGRAD_TOL:g} max |ref|)")
    wgrad_err = check_wgrad(dev)

    print("[5b] flip kernel against its plain version (bit for bit)")
    flip_err = check_flip(dev)

    print("[5c] augmentation chain: card (flip kernel, TF32 off) vs CPU, one set of host draws")
    check_chain(dev)

    nms = run_inference(dev, card)
    train = run_training(dev, card, stress_sims)
    flip = run_augmented_training(dev, card, train["trainer"], train["batch"])

    print(f"[10] done in {time.perf_counter() - t_start:.1f} s")
    source = "jpeg_detection_resnet_ssd_torch/ops/csrc/{}.cu"
    print(json.dumps({"kernels": [
        {"name": "batched_nms_mask", "route": "cuda", "source": source.format("batched_nms"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_nms.py:114",
         "max_abs_err": nms_err, "library_ms": None, **nms},
        {"name": "bipartite_match", "route": "cuda", "source": source.format("bipartite_match"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_match.py:174",
         "max_abs_err": match_err, "library_ms": None, **train["match"]},
        {"name": "conv3x3_filter_grad", "route": "cuda", "source": source.format("conv3x3_wgrad"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_conv_grad.py:128",
         "max_abs_err": max(wgrad_err, train["wgrad_step_err"]), **train["wgrad"]},
        {"name": "dct_flip_horizontal", "route": "cuda", "source": source.format("dct_flip"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/dct_augment.py:75",
         "max_abs_err": flip_err, "library_ms": None, **flip},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
