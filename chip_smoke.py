#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

Ten paths, the first five and the last three at the full width of
`ssd300_ssd_custom`:
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
    kernel) and a `TargetEncoder(AnchorSpec(304, 304))`;
  * evaluation: `eval.DetectionEvaluator` over `make_inference_fn(
    candidate_selector="exact")` (the decode of `cli evaluate`) on 64 seeded
    images at batch 8 in the pipeline's evaluation contract, and the other
    decoders of `boxes/decode.py` (`decode_detections_fast`,
    `decode_detections_debug`, `nms_per_class`), all through the NMS kernel;
  * `train-detect`: `cli.main(["train-detect", "--device-augment",
    "--pack-cache", ...])` in this process, from a VOC tree and its packed
    corpus written with NumPy, at batch 32 bf16 with all three training
    kernels, then `--restart`;
  * classification: `cli.main(["train-classify", "--device-augment",
    "--pack-cache", ..., "--pallas-wgrad"])` in this process, training
    `resnet50_dct_late_concat_rfa_thinner` at full width and depth with
    1000 classes from a NumPy-written 256-px corpus at batch 64 bf16, the
    v2 random-resized crop and flip (the flip kernel) in the step and every
    3x3 conv's filter gradient on the CUDA kernel, then `--restart`; and the
    forward of every ResNet-50 of the registry;
  * the other families: `cli.main(["train-detect", "--vgg",
    "--device-augment", "--pack-cache", ..., "--pallas-wgrad"])` training
    `ssd300_vgg_dct` (the reference's DCT VGG SSD300) at full width and
    depth at batch 32 bf16, then `--restart`, and `--archi y_cb4_cbcr_cb5`;
    the forward of all 13 VGG and other SSD300 names; B4 on maps wider than
    a stage (C3);
  * serving: phase 6's calibrated `ssd300_ssd_custom` with its BatchNorm
    folded (`serve.fold_batch_norm`), exported with its shared decode as a
    symbolic-batch `torch.export` artifact (`serve.export_serving_artifact`)
    and loaded back (`serve.load_serving_artifact`): the artifact's NMS is
    the custom operator that launches the NMS kernel; and the int8 model
    (`serve.quantize_for_serving`) and its artifact;
  * tensor parallelism: `build_trainer` on a (data, model) mesh of gloo
    ranks sharing the card, whose model axis shards the widest kernels
    (`parallel.shard_parameters`), and `cli.main(["train-detect",
    "--n-model-shards", "2", ...])` on two ranks, its checkpoint restored
    and decoded in one process;
  * the convergence proxies (ROADMAP A17): `scripts/torch_convergence_proxy.py`
    (`device_v3`) on the first 64 train and 16 held-out images of its
    generated 20-class corpus, `ssd300_ssd_custom` trained for 60 steps at
    batch 32 bf16 and scored by held-out mAP through both candidate
    selectors; `scripts/torch_cls_convergence_proxy.py` (`device`) for 40
    steps at batch 64.
The card's machine has no libjpeg: the DCT planes come from NumPy, written
directly or, in the proxies, computed from PIL-decoded pixels by the NumPy
JPEG codec (`data/dct_convert.py`, bit-exact with the libjpeg path).

Phases (any failure exits non-zero):
  1. card name and power limit (nvidia-smi);
  2. build the five kernels from the sources in the checkout, one nvcc each,
     all started together; print ptxas' registers, shared memory, spills;
  3. NMS kernel against its plain version at the serving shape (N=640,
     K=400), a ragged one and K=4096, with pairs at IoU exactly the
     threshold: masks exactly equal;
  4. matching kernel against its plain version on the IoUs of seeded GT
     with the 8732 anchors at batch 32 (1-10 valid rows per image, one image
     with 64, one with none, duplicate boxes) and on tie-heavy (5, 64, 300)
     similarities, without a row mask and with one (the GT mask; seeded
     holes for the ties): indices exactly equal;
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
  5d. train-mode BatchNorm kernels against their plain version (y, running
     statistics, step counter, dx, dweight, dbias) at the detector's 12
     BatchNorm shapes at batch 256 in bf16, three in float32, a 1x1 map, 3
     channels, a view 2 bytes past an aligned base, constant channels (0.1,
     inexact, its float32 tolerance widened by the rsqrt's conditioning;
     3.0, exact), frozen statistics and momentum=None; a second call gives
     the same bits; in float32 both held to the plain version in float64;
     then forward and backward of each shape timed behind a device sleep on
     inputs that cycle through 4x the L2, beside the two-pass bound (16
     bytes an element), ATen's `native_batch_norm` and the plain version, at
     least 60% of the bound at the largest; the host's microseconds a call;
  6. inference: a batch-32 bf16 and a batch-1 f32 request through both
     candidate selectors, NMS launch count read around them; kernel and
     plain NMS give identical detections; the f32 forward agrees with the
     port's CPU forward;
  7. training: `fit` for 5 steps into a temporary run directory, on
     batches whose images each carry the two GT boxes of `bench.py`'s train
     rows; kernel launch counts reset just before and read just after
     (matching 1, filter gradient 24 and BatchNorm 424 per step), and the bf16 wrapper's
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
     batch 32 bf16 and its parts; the NMS kernel at N=640, K=400 queued
     behind a device sleep, at the host's rate and in the profiler (its
     two launches), its bound, the full bitmask's operations and bytes and
     the pair tests its tiles issue; the
     train step at batch 32
     bf16 with both kernels, with cuDNN's filter gradient (matching kernel
     on) and with both off (plain matching), interleaved, and a profiler
     window of the first two; the matching kernel queued behind a device
     sleep (from main memory and warm in the L2), its plain version, its
     bound (live rows) and the full matrix's bound, on the train batch's
     IoUs with the GT row mask and without one, and on phase 4's as a worst
     case, with and without the mask; the filter-gradient kernel and cuDNN's
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
  9d. the evaluate path on phase 6's float32 model: the evaluator with the
     NMS kernel and with its plain version on the same raw predictions
     (identical per-class lists, equal mAP; one kernel call per batch, read
     around the run), then with each image's own detections >= 0.5 as its
     GT (11-point mAP exactly 1.0 over the classes present); the three
     other decoders with the kernel and the plain NMS on phase 6's raw f32
     batch-32 predictions (torch.equal, one kernel call each); timings: the
     evaluate loop's images/s at batch 8 in f32 and bf16, split into device
     time (CUDA events around the infer function) and host time, and the
     batch-1 latency of forward + exact decode in f32 and bf16;
 9e. `train-detect` from a packed corpus: a VOC tree of 96 annotations
     (1-4 boxes each) and its corpus at 352 px (int16 Y ~ N(0, 100), CbCr ~
     N(0, 30), the XML boxes scaled), written with NumPy; the CLI with
     `--device-augment --pack-cache --pallas-wgrad`, batch 32, 3 steps:
     the row's loss finite, a checkpoint, launches reset just before and
     read just after (matching 1, flip 2, filter gradient 24 a step); the
     same with `--restart --max-steps 6`: the same run dir, epoch 1; C2 in
     float32 at batch 2: `--steps-per-call 3` against `1` (losses within
     1e-4, parameters within 1e-3 of the largest), beside a second `1` run
     (the card's run-to-run spread); warm steps/s, a `PackedDctPipeline`
     batch's host time, one batch's copy from pinned and from pageable
     memory, and `prefetch_to_device` per batch;
 9f. classification: the forward of the 7 DCT ResNet-50s and resnet50_rgb
     at batch 2 in float32 (TF32 off; BatchNorm calibrated on the batch),
     card against the port's CPU path within 1e-3 of the largest logit; the
     filter-gradient kernel at the 6 shapes of the DCT step and resnet50_rgb's
     56x56 and 7x7x512 shapes at batch 64, bf16 and float32, within 1e-4 and
     bit-identical from call to call, then timed per shape against cuDNN and
     the bound; the v2 augment (batch 64, 32-block sources) on the card
     against the CPU within 1e-5, its two flips bit for bit, and the flip
     kernel timed at those shapes; one float32 step at batch 2 card vs CPU
     (loss 1e-4, fc1000 gradient 1e-3); the bf16 step at batch 64 through
     the v2 augment in three arms (B4; cuDNN's dW; B4 with remat and the
     bf16 momentum): peak memory per arm, launches a step, step ms and
     images/s in three rotating rounds, a profiler window; `train-classify
     --device-augment --pack-cache --pallas-wgrad` for 3 steps (launches
     reset just before and read just after: flip 2, filter gradient 18 a
     step) and `--restart` to 6; `ClassificationEvaluator` over the
     calibrated model, top-1/top-5 checked against its logits, images/s in
     float32 and bf16;
 9g. the other families (ROADMAP A12b): B4 at the VGG models' 30 conv
     shapes (batch 32 detection, 64 classification; 300-, 224- and
     150-column rows cut into column groups, C = 3 padded to 8), bf16 and
     float32 within 1e-4 and bit-identical call to call, then timed per
     shape against cuDNN and the bound; the forward of the 13 names at batch
     2 in float32 (BatchNorm calibrated), card vs CPU within 1e-3 of the
     largest output; `ssd300_vgg_dct`, `ssd300_vgg` and
     `ssd300_y_cb4_cbcr_cb5` at batch 32 bf16 through the shared decode
     (kernel NMS = plain NMS, one launch each); one float32 step at batch 2
     card vs CPU for `ssd300_vgg_dct` and `vgga` (dropout masks from one
     host generator; loss 1e-4, head gradients 1e-3, B4 13 and 8 launches);
     `train-detect --vgg --device-augment --pack-cache --pallas-wgrad` from
     phase 9e's corpus, 3 steps and `--restart` to 6 (B2 1, B3 2, B4 13 a
     step, warm steps/s), and `--archi y_cb4_cbcr_cb5` for 3 steps (B4 20 a
     step); the ssd300_vgg_dct bf16 step with B4 against cuDNN's dW in four
     rotating rounds, and a profiler window;
 9h. serving (ROADMAP A14a, A14b) on phase 6's calibrated model: the
     folded copy holds no BatchNorm and its f32 forward at batch 2 is within
     FOLD_TOL of the unfolded one; kernel launches and device time per
     forward (profiler), unfolded against folded, at batch 32 bf16 and
     batch 1 f32, and forward + shared decode in 3 rotating rounds of CUDA
     events; the folded f32 forward + shared decode exported on the card
     with a symbolic batch (export seconds and bytes), loaded and called at
     batches 1, 8 and 32 (NMS launches reset just before and read just
     after: one per call) and held to the in-process folded path and to the
     plain NMS's decode (ARTIFACT_TOL), the kernel mask equal to the plain
     mask on those candidates; the artifact against the in-process path at
     batch 32 (CUDA events) and at batch 1 (host clock), 2 rounds; int8
     calibrated on 4 seeded batches of 8: `torch._int_mm` accumulators on
     the card equal to the CPU's at every distinct conv shape of a batch-1
     request, the raw output's relative RMS against float, the int8
     artifact (= in-process at batch 32) and its bytes against the float
     artifact's, and the int8 forward at batch 32 against the folded bf16
     and f32 forwards in 3 rotating rounds;
 9i. weight tooling, profiling, `bench` and data parallelism (ROADMAP
     A14c, A13a): `cli.main(["bench", ...])` for `ssd300_ssd_custom` at
     batch 32 (51,984,110 parameters) and the classifier at batch 64; two
     worker processes (this script with `--dp-worker`) share the card over
     gloo and take 2 float32 steps (TF32 off) of `ssd300_ssd_custom` at a
     global batch of 32, 16 rows a rank, through B2, the v3 augment's B3
     and B4 and train-mode BatchNorm's kernels (each direction's totals
     all-reduced), against one process on the global batch (loss 1e-4,
     parameters 1e-3 of the largest, the ranks bit-identical; launches read
     in each rank: B2 1, B3 2, B4 24, BatchNorm 564 a step), and that one
     process's step on BatchNorm's plain version as a witness (first loss
     1e-6, parameters 1e-3 of the largest); phase 9e's `train-detect` command in a
     subprocess under `torchrun`'s environment for a world of 1 (NCCL) at
     batch 32 bf16, 3 steps, then `--restart` for 6 more (launches read in
     the subprocess, warm steps/s from the restart's second epoch, since each
     run is a new process); `utils.profile_trace` around 2 steps of the
     reference's trainer (a Chrome trace holding B4's kernel) and
     `StepTimer`'s steps/s;
 9j. tensor parallelism (ROADMAP A13b), phase 9i's step (f32, TF32 off,
     B2, B3, B4, the v3 augment, global batch 32) on gloo ranks sharing the
     card (this script with `--dp-worker`), each arm held to one process
     on the global batch (loss 1e-4, parameters 1e-3 of the largest, the
     ranks' gathered states bit-identical, B2 1, B3 2, B4 24 launches a
     step a rank, BatchNorm's 424, or 564 on the 2x2 mesh's 2 data ranks): a 1x2 mesh at the 1024 rule for 2 steps (against phase
     9i's one process; 38,352,622 parameters a rank), a 2x2 mesh for 1
     step, a 1x2 mesh at a 512 rule for 1 step with every B4 launch held to
     its plain version (1e-4), 3 of them on 256-column output slices; then
     `train-detect --n-model-shards 2` on 2 ranks (`--tp-cli-worker`), 3
     steps from phase 9e's corpus in f32 and `--restart` for 3 more, whose
     last checkpoint, restored in this process, equals the ranks' gathered
     parameters, gives their train-mode forward (1e-3 of the largest) and
     decodes through B1 once; each rank's launches, model-axis collectives
     a step, parameter and momentum bytes, peak memory and seconds;
 9k. the convergence proxies: the detection proxy's corpus generated by the
     port's generator (64 train, 16 held-out images of the seeded stream)
     and packed at 352 px by the NumPy codec (its SHA-256 printed beside the
     libjpeg path's pinned digest, PROXY_CORPUS_SHA256); `device_v3` for 60
     steps at batch 32 bf16 (launches reset just before and read just after:
     B2 1 and B3 2 a step, B1 1 in each held-out decode, 2 selectors x 2
     batches), losses finite and the last 10 steps' mean below the first
     10's, mAP in [0, 1], the selectors' predictions compared and their mAP
     delta printed; the classification proxy (`device`, 128 train and 32
     held-out images, 40 steps at batch 64 bf16: B3 2 a step), the same
     loss checks, top-1 in [0, 1]; warm steps/s and the phase's seconds;
 10. the `kernels` JSON line (B3's and B4's entries with a `classification`
     part: the train-classify run's launches and the per-step times at the
     classification shapes; every entry with a `vgg` part: the launches of
     `train-detect --vgg`'s 3 steps (B1: of 9g's three decodes), and for B4
     the per-step times at ssd300_vgg_dct's 13 shapes and the wide maps';
     B1's entry with a `serve` part: its launches inside 9h's artifact;
     B2's, B3's, B4's and BatchNorm's with a `data_parallel` part: each
     rank's launches in 9i's 2-rank step; every entry with a `tensor_parallel` part: each
     rank's launches in each arm of 9j, B1's in its decode; B1's, B2's and
     B3's with a `proxy` part: their launches in 9k, B3's also in the
     classification proxy; the BatchNorm entry first: its launches in phase
     7, phase 5d's per-step times, those at the largest shape and the host's
     microseconds a call), the card
     line, and the final JSON line.

Weights are the port's seeded init (torch.Generator seeded 0); for inference
the BatchNorm running statistics are calibrated on the batch-32 request (one
train-mode forward), since identity statistics on N(0, 100) DCT planes drive
the activations, and the box offsets, to overflow.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import functools
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, same source
H100_BF16_FLOPS = 989e12  # bf16 dense on the tensor cores, same source
H100_L2_BYTES = 50 * 2**20  # L2 cache, same source
NMS_OPS_PER_PAIR = 16  # 2x(min, max, sub, add d, max 0), mul, add, sub, max, div, cmp
KERNELS = ("batch_norm", "batched_nms", "bipartite_match", "conv3x3_wgrad", "dct_flip")
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

# The train-mode BatchNorm inputs of one `ssd_custom` step at batch 256:
# (H, C, count), 71 in all; the first BatchNorm of each input plane sees
# the model's inputs, which need no gradient.
BN_SHAPES = (
    (38, 384, 9), (38, 256, 6), (38, 128, 8), (38, 64, 1), (19, 512, 3), (19, 384, 2),
    (19, 256, 4), (19, 128, 9), (10, 1024, 7), (10, 256, 12), (5, 2048, 4), (5, 512, 6),
)
BN_INPUT_LAYERS = 2
# Launches a detector step: 3 a forward; 3 a backward, 2 where x needs no gradient.
BN_LAUNCHES_PER_STEP = 3 * 71 + 3 * (71 - BN_INPUT_LAYERS) + 2 * BN_INPUT_LAYERS
# The same on a rank of a mesh of 2+ data ranks: 4 each way (a rank's totals
# before the all-reduce), 2 where x needs no gradient.
BN_MESH_LAUNCHES_PER_STEP = 4 * 71 + 4 * (71 - BN_INPUT_LAYERS) + 2 * BN_INPUT_LAYERS


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


def nms_bitmask_work(n: int, k: int) -> tuple[int, int]:
    """What a full pair bitmask would spend: the operations of all K(K-1)/2
    pairs of each problem, and the bytes of an (N, K, ceil(K/64)) word mask
    written once and read once."""
    return NMS_OPS_PER_PAIR * n * k * (k - 1) // 2, 2 * n * k * (-(-k // 64)) * 8


def nms_tile_pairs(scores: torch.Tensor) -> int:
    """Pair tests the bitmask kernel issues on these inputs, counted per lane:
    every 64 x 64 tile on or above the diagonal whose row and column blocks
    hold a score > 0, in halves of 32 columns, with one row a lane on the
    diagonal's first half and in the last row block, two elsewhere."""
    n, k = scores.shape
    words = -(-k // 64)
    padded = torch.zeros(n, words * 64, dtype=torch.bool, device=scores.device)
    padded[:, :k] = scores > 0
    live = padded.reshape(n, words, 64).any(-1).cpu()
    total = 0
    for rb in range(words):
        two_rows = rb * 64 + 32 < k
        for cb in range(rb, words):
            cost = 32 * 32 * (2 if two_rows and cb != rb else 1)
            if k - cb * 64 > 32:
                cost += 32 * 32 * (2 if two_rows else 1)
            total += cost * int((live[:, rb] & live[:, cb]).sum())
    return total


def match_bound(sims: torch.Tensor, row_mask: torch.Tensor | None = None) -> tuple[float, str]:
    """Read the live rows (every row without a mask) once, and the mask;
    write the indices; one compare an element."""
    b, m, n = sims.shape
    live = b * m if row_mask is None else int(row_mask.sum())
    t_bytes = (live * n * 4 + b * m * 4 + (0 if row_mask is None else b * m)) / H100_BYTES_PER_S
    t_ops = live * n / H100_F32_FLOPS
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


def batch_norm_bound(x: torch.Tensor) -> tuple[float, float, str]:
    """The two-pass design's bytes, ms forward and backward: the forward
    reads x twice (statistics, apply) and writes y, the backward reads x and
    dy twice and writes dx: 16 bytes an element in bfloat16.  A few float32
    operations an element, far below that."""
    n = x.numel() * x.element_size()
    return 3 * n / H100_BYTES_PER_S * 1e3, 5 * n / H100_BYTES_PER_S * 1e3, "bytes"


def bn_params(c: int, gen: torch.Generator, dev) -> dict:
    """Seeded BatchNorm parameters and running statistics of `c` channels on `dev`."""
    return {"weight": (1 + 0.1 * torch.randn(c, generator=gen)).to(dev),
            "bias": (0.1 * torch.randn(c, generator=gen)).to(dev),
            "running_mean": (0.1 * torch.randn(c, generator=gen)).to(dev),
            "running_var": (1 + torch.rand(c, generator=gen)).to(dev),
            "num_batches_tracked": torch.tensor(3, device=dev)}


def bn_run(impl: str, x: torch.Tensor, params: dict, dy: torch.Tensor, momentum=0.01,
           update=True) -> dict:
    """One train-mode BatchNorm forward and backward of x by `impl`, on
    copies of `params`: y, the moved state, dx, dweight and dbias."""
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm

    p = {k: v.clone() for k, v in params.items()}
    x = x.detach().clone().requires_grad_(True)
    w, b = p["weight"].requires_grad_(True), p["bias"].requires_grad_(True)
    y = batch_norm.batch_norm_train(x, w, b, p["running_mean"], p["running_var"],
                                    p["num_batches_tracked"], momentum, 1e-3, update=update, impl=impl)
    y.backward(dy)
    return {"y": y.detach(), "running_mean": p["running_mean"], "running_var": p["running_var"],
            "num_batches_tracked": p["num_batches_tracked"], "dx": x.grad, "dweight": w.grad,
            "dbias": b.grad}


def _sums_exactly(v: torch.Tensor) -> torch.Tensor:
    """Per column of the float32 values v (rows, C): whether every partial
    sum, in any order, is a float32 (each a multiple of the smallest bit
    that any value holds, none 2^24 of them or more)."""
    mant, exp = torch.frexp(v.double())
    bits = (mant * 2.0 ** 24).long()
    low = torch.where(bits != 0, (bits & -bits).double() * torch.exp2(exp.double() - 24),
                      torch.full_like(mant, float("inf"))).amin(0)
    return v.double().abs().sum(0) < 2.0 ** 24 * low


def bn_conditioning(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Per channel of x, how far float32 rounding moves rsqrt(var + eps), as
    a share of it: E[x^2] - E[x]^2 takes three float32 sums' errors, each
    about log2(M) roundings (u = 2^-24) of E[x^2] (the plain version sums in
    a tree, the kernels a few rows a thread, then a tree), and rsqrt halves
    a relative change of var + eps:  3 log2(M) u E[x^2] / (2 (var + eps)).
    Large on a near-constant channel of mean^2 >> eps (0.1: ~10x a
    centred channel's), small elsewhere; 0 where float32 sums x and x^2
    exactly in any order (a constant 3.0)."""
    x32 = x.float().reshape(-1, x.shape[-1])
    xf = x32.double()
    exact = _sums_exactly(x32) & _sums_exactly(x32.square())
    ex2 = xf.square().mean(0)
    var = (ex2 - xf.mean(0).square()).clamp_min(0.0)
    rounds = 3 * math.ceil(math.log2(xf.shape[0])) * 2.0 ** -24
    return torch.where(exact, 0.0, rounds * ex2 / (2 * (var + eps))).float()


def bn_gaps(got: dict, ref: dict, kappa: torch.Tensor | None = None) -> dict:
    """Each output's worst |kernel - plain| over its tolerance: a bfloat16
    tensor (y, dx) may differ by one rounding of float32 values that agree
    to float32 summation order, 2^-7 |ref| + 1e-4 max |ref|; a float32 one
    by 1e-5 max |ref| (sums of up to 370k terms in another order), and the
    float32 y, dx and dweight, which scale with rsqrt(var + eps), also by
    `kappa` (`bn_conditioning` of x, a channel) of |ref|; the step counter
    not at all."""
    out = {}
    for k, r in ref.items():
        g = got[k]
        if k == "num_batches_tracked":
            out[k] = 0.0 if int(g) == int(r) else np.inf
            continue
        g, r = g.float(), r.float()
        scale = float(r.abs().max())
        bf16 = ref[k].dtype == torch.bfloat16
        tol = (2 ** -7 * r.abs() + 1e-4 * scale) if bf16 else torch.full_like(r, 1e-5 * scale)
        if kappa is not None and not bf16 and k in ("y", "dx", "dweight"):
            tol = tol + kappa.to(r.device) * r.abs()
        out[k] = float(((g - r).abs() / tol.clamp_min(1e-30)).max())
    return out


def calibrate_batch_norm(model, inputs) -> None:
    """Set every BatchNorm's running statistics to those of `inputs` (one
    train-mode forward with a cumulative average), then return to eval."""
    from jpeg_detection_resnet_ssd_torch.models import layers

    norms = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    # (a VGG classifier's train-mode dropout draws from a generator; it
    # comes after every BatchNorm, so it does not touch the statistics)
    with torch.no_grad(), layers.dropout_rng(torch.Generator().manual_seed(0)):
        model(inputs)
    model.eval()
    for m, momentum in zip(norms, saved):
        m.momentum = momentum


def scale_ssd_head(model, inputs) -> None:
    """Scale a random SSD head so that, on `inputs`, its box offsets stay
    within +-1 and its class logits within +-4: a seeded head over features
    that no BatchNorm keeps in range (`ssd300_vgg` on 0-255 pixels) gives
    offsets that overflow exp() into infinite boxes.  A predictor is a conv,
    so scaling its weight and bias scales its outputs."""
    n_total = model.head.n_classes + 1
    with torch.no_grad():
        raw = model(inputs).float()
        for suffix, out, limit in (("_mbox_conf", raw[..., :n_total], 4.0),
                                   ("_mbox_loc", raw[..., n_total:n_total + 4], 1.0)):
            factor = limit / float(out.abs().max())
            for name, conv in model.head.named_children():
                if suffix in name:
                    conv.weight.mul_(factor)
                    conv.bias.mul_(factor)


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
    for n, k in ((640, 400), (7, 37), (2, 4096)):
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
    holes = torch.from_numpy(rng.random((5, 64)) < 0.6).to(dev)
    gt_mask = torch.from_numpy(mask).to(dev)
    max_err = 0
    for name, s, row_mask in (("IoU sims (32, 64, 8732)", sims, None),
                              ("IoU sims (32, 64, 8732), GT row mask", sims, gt_mask),
                              ("tie-heavy sims (5, 64, 300)", torch.from_numpy(ties).to(dev), None),
                              ("tie-heavy sims (5, 64, 300), row mask with holes",
                               torch.from_numpy(ties).to(dev), holes)):
        got = bm.bipartite_match(s, impl="kernel", row_mask=row_mask)
        torch.cuda.synchronize()
        ref = bm.bipartite_match_reference(s, row_mask)
        max_err = max(max_err, int((got - ref).abs().max()))
        check(torch.equal(got, ref), f"{name}: matched indices equal ({int((ref >= 0).sum())} pairs)")
    got = bm.bipartite_match(sims, impl="kernel", row_mask=gt_mask)
    check(bool(((got >= 0) == (sims.amax(-1) >= 0)).all()) and bool((got[17] < 0).all())
          and bool((got[5] >= 0).all()), "every valid row matched, none of the padding")
    return float(max_err), sims, gt_mask


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


def check_batch_norm(dev) -> float:
    """The kernels against the plain version: every detector BatchNorm shape
    at batch 256 in bfloat16, three in float32, a 1x1 map, 3 channels (the
    scalar path), an unaligned view, constant channels (one of 0.1, whose
    sums are inexact, so its variance may be clipped at 0 and its rsqrt
    takes that difference's rounding: `bn_conditioning`), frozen
    statistics, momentum=None and repeatability.  In float32 both are also
    held to the plain version in float64, the kernels within the float32
    tolerance and no further from it than twice the plain version.
    Returns the worst gap (1 = at the tolerance)."""
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm

    gen = torch.Generator().manual_seed(11)
    worst = 0.0
    cases = [((256, h, h, c), torch.bfloat16) for h, c, _ in BN_SHAPES]
    cases += [((256, 38, 38, 384), torch.float32), ((256, 10, 10, 1024), torch.float32),
              ((256, 5, 5, 2048), torch.float32), ((256, 1, 1, 256), torch.bfloat16),
              ((4, 9, 7, 3), torch.float32), ((3, 5, 5, 100), torch.bfloat16)]
    for shape, dtype in cases:
        c = shape[-1]
        x = (2 * torch.randn(shape, generator=gen) + torch.randn(c, generator=gen)).to(dev, dtype)
        x[..., 1], x[..., 2] = 0.1, 3.0  # constant: inexact sums; exact, a variance of 0
        dy = torch.randn(shape, generator=gen).to(dev, dtype)
        params = bn_params(c, gen, dev)
        kappa = bn_conditioning(x)
        before = batch_norm.LAUNCHES
        got = bn_run("kernel", x, params, dy)
        torch.cuda.synchronize()
        launches = batch_norm.LAUNCHES - before
        again = bn_run("kernel", x, params, dy)
        plain = bn_run("reference", x, params, dy)
        gaps = bn_gaps(got, plain, kappa)
        worst = max(worst, *gaps.values())
        check(launches == 6 and max(gaps.values()) <= 1.0
              and all(torch.equal(got[k], again[k]) for k in got),
              f"batch norm {shape} {str(dtype)[6:]}: 6 launches, every output within its tolerance "
              f"(worst {max(gaps, key=gaps.get)} at {max(gaps.values()):.3g}), a second call gives "
              f"the same bits")
        if dtype == torch.float32:
            exact = bn_run("reference", x.double(), {k: v.double() if v.is_floating_point() else v
                                                     for k, v in params.items()}, dy.double())
            k64, p64 = bn_gaps(got, exact, kappa), bn_gaps(plain, exact, kappa)
            worst_k = max(k64, key=k64.get)
            check(max(k64.values()) <= max(1.0, 2 * max(p64.values())),
                  f"batch norm {shape} float32 against float64: kernels' worst {worst_k} "
                  f"{k64[worst_k]:.3g}, plain version's worst {max(p64, key=p64.get)} "
                  f"{max(p64.values()):.3g} (each {{" + ", ".join(
                      f"{k}: {k64[k]:.2g}/{p64[k]:.2g}" for k in k64) + "})")
    x = torch.randn(2 * 19 * 19 * 128 + 1, generator=gen).to(dev, torch.bfloat16)[1:].view(2, 19, 19, 128)
    dy = torch.randn(2, 19, 19, 128, generator=gen).to(dev, torch.bfloat16)
    params = bn_params(128, gen, dev)
    gaps = bn_gaps(bn_run("kernel", x, params, dy), bn_run("reference", x, params, dy))
    worst = max(worst, *gaps.values())
    check(max(gaps.values()) <= 1.0, f"batch norm on a view 2 bytes past an aligned base (scalar "
                                     f"loads): worst gap {max(gaps.values()):.3g}")
    x = torch.randn(8, 10, 10, 64, generator=gen).to(dev, torch.bfloat16)
    dy = torch.randn(8, 10, 10, 64, generator=gen).to(dev, torch.bfloat16)
    params = bn_params(64, gen, dev)
    got = bn_run("kernel", x, params, dy, update=False)
    check(all(torch.equal(got[k], params[k]) for k in ("running_mean", "running_var",
                                                       "num_batches_tracked")),
          "batch norm, statistics frozen: running statistics and step counter unchanged")
    gaps = bn_gaps(bn_run("kernel", x, params, dy, momentum=None),
                   bn_run("reference", x, params, dy, momentum=None))
    worst = max(worst, *gaps.values())
    check(max(gaps.values()) <= 1.0, f"batch norm, momentum=None (factor 1 / 4): worst gap "
                                     f"{max(gaps.values()):.3g}")
    return worst


def time_batch_norm(dev, card) -> dict:
    """Forward and backward of each detector BatchNorm shape at batch 256
    bf16, queued behind a device sleep on inputs that cycle through copies
    holding 4x the L2 (so every call reads main memory, whatever its size),
    against the bound, ATen's own train-mode BatchNorm on the channels_last
    view (`native_batch_norm` and its backward, as `library_ms`: Welford
    statistics and a running variance of another function, so timed, not
    compared) and the plain version; then the host's cost of a call."""
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm

    gen = torch.Generator().manual_seed(12)
    sums = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    largest = None
    aten = torch.ops.aten
    print(f"    train-mode BatchNorm per detector shape, batch 256 bf16 (forward / backward ms)  [{card}]")
    for h, c, count in BN_SHAPES:
        shape = (256, h, h, c)
        x = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
        pair = torch.stack([x, dy])  # one input for queued_ms' copies: x, then dy
        p = bn_params(c, gen, dev)
        w, b = p["weight"].requires_grad_(True), p["bias"].requires_grad_(True)
        state = (p["running_mean"], p["running_var"], p["num_batches_tracked"], 0.01, 1e-3)
        row = {}

        def forward(xi, impl="kernel"):
            with torch.no_grad():
                return batch_norm.batch_norm_train(xi, w, b, *state, impl=impl)

        saved = types.SimpleNamespace(save_for_backward=lambda *t: setattr(saved, "t", t))
        with torch.no_grad():  # the forward's (4, C) statistics, as the backward reads them
            batch_norm._TrainBatchNorm.forward(saved, x, w, b, p["running_mean"], p["running_var"],
                                               p["num_batches_tracked"], 0.01, True, 1e-3, None)
        stats = saved.t[1]
        xr = x.clone().requires_grad_(True)
        row["fwd"], row["fwd_s"] = queued_ms(forward, x, iters=20)
        row["bwd"], row["bwd_s"] = queued_ms(
            lambda xd: batch_norm._backward(xd[0], xd[1], stats, (), None, True), pair, iters=20)
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731  (channels_last: the same memory)
        try:
            _, mean, invstd = aten.native_batch_norm(
                nchw(x), w.detach(), b.detach(), p["running_mean"].clone(),
                p["running_var"].clone(), True, 0.01, 1e-3)
            row["lib_fwd"], _ = queued_ms(lambda xi: aten.native_batch_norm(
                nchw(xi), w.detach(), b.detach(), p["running_mean"], p["running_var"], True, 0.01,
                1e-3)[0], x, iters=20)
            row["lib_bwd"], _ = queued_ms(lambda xd: aten.native_batch_norm_backward(
                nchw(xd[1]), nchw(xd[0]), w.detach(), p["running_mean"], p["running_var"], mean,
                invstd, True, 1e-3, [True, True, True])[0], pair, iters=20)
        except (RuntimeError, TypeError, NotImplementedError) as e:  # no mixed-type path: say so
            print(f"    ATen native_batch_norm at {shape} bf16 with float32 parameters: {e}")
            row["lib_fwd"] = row["lib_bwd"] = float("nan")
        y = batch_norm.batch_norm_train(xr, w, b, *state, impl="reference")
        row["plain_fwd"], _ = timed(lambda: forward(xr, "reference"), 3, warmup_s=0.1)
        row["plain_bwd"], _ = timed(lambda: torch.autograd.grad(y, (xr, w, b), dy,
                                                                retain_graph=True), 3, warmup_s=0.1)
        del y, xr, pair
        f_bound, b_bound, by = batch_norm_bound(x)
        sums["ms"] += count * (row["fwd"] + row["bwd"])
        sums["bound_ms"] += count * (f_bound + b_bound)
        sums["plain_ms"] += count * (row["plain_fwd"] + row["plain_bwd"])
        sums["library_ms"] += count * (row["lib_fwd"] + row["lib_bwd"])
        print(f"    {shape} x{count}: kernel {row['fwd']:.5f} {row['fwd_s']} / {row['bwd']:.5f} "
              f"{row['bwd_s']} = {100 * f_bound / row['fwd']:.1f}% / {100 * b_bound / row['bwd']:.1f}% "
              f"of the bound {f_bound:.5f} / {b_bound:.5f} ({by}); ATen native_batch_norm "
              f"{row['lib_fwd']:.5f} / {row['lib_bwd']:.5f}; plain {row['plain_fwd']:.4f} / "
              f"{row['plain_bwd']:.4f}")
        if largest is None:
            largest = {"shape": list(shape), "forward_ms": row["fwd"], "backward_ms": row["bwd"],
                       "forward_bound_ms": f_bound, "backward_bound_ms": b_bound,
                       "library_forward_ms": row["lib_fwd"], "library_backward_ms": row["lib_bwd"],
                       "plain_forward_ms": row["plain_fwd"], "plain_backward_ms": row["plain_bwd"]}
            check(f_bound >= 0.6 * row["fwd"] and b_bound >= 0.6 * row["bwd"],
                  f"batch norm at the largest shape {shape}: forward and backward each at 60% or "
                  f"more of the bound")
    print(f"    BatchNorm per detector train step at batch 256 (71 layers, forward + backward): "
          f"kernel {sums['ms']:.4f} ms, {100 * sums['bound_ms'] / sums['ms']:.1f}% of the bound "
          f"{sums['bound_ms']:.4f} ms; ATen native_batch_norm {sums['library_ms']:.4f} ms; plain "
          f"{sums['plain_ms']:.4f} ms  [{card}]")
    return {**sums, "bound_by": "bytes", "largest": largest, "host_us": host_batch_norm(dev, card)}


def host_batch_norm(dev, card, layers=64, rounds=30) -> dict:
    """The host's microseconds a train-mode BatchNorm layer: a chain of
    `layers` BatchNorms, each with its own parameters, at (8, 5, 5, 256)
    bf16, forward alone (no autograd) and forward then one backward through
    the chain, as a train step runs them; the kernels take a few
    microseconds a launch, so the host paces them.  perf_counter around
    `rounds` chains after a warm round, one synchronize after them."""
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm

    gen = torch.Generator().manual_seed(13)
    x = torch.randn(8, 5, 5, 256, generator=gen).to(dev, torch.bfloat16).requires_grad_(True)
    chain = []
    for _ in range(layers):
        p = bn_params(256, gen, dev)
        chain.append((p["weight"].requires_grad_(True), p["bias"].requires_grad_(True),
                      p["running_mean"], p["running_var"], p["num_batches_tracked"], 0.01, 1e-3))

    def forward(impl):
        y = x
        for args in chain:
            y = batch_norm.batch_norm_train(y, *args, impl=impl)
        return y

    def no_grad(impl):
        with torch.no_grad():
            forward(impl)

    def both(impl):
        forward(impl).float().sum().backward()

    out = {}
    for name, fn in (("forward", no_grad), ("forward_backward", both)):
        for impl in ("kernel", "reference"):
            for n in (1, rounds):  # the first round warms up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn(impl)
                host_us = (time.perf_counter() - t0) / (n * layers) * 1e6
                torch.cuda.synchronize()
            out[f"{name}_{impl}"] = host_us
    print(f"    host per BatchNorm layer, a chain of {layers} at (8, 5, 5, 256) bf16: kernels "
          f"{out['forward_kernel']:.1f} us forward, {out['forward_backward_kernel']:.1f} us forward "
          f"+ backward; plain version {out['forward_reference']:.1f} / "
          f"{out['forward_backward_reference']:.1f} us  [{card}]")
    return out


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
    kernel_ms, kernel_spread = queued_ms(lambda _: batched_nms.batched_nms_mask(nb, ns), nb, cold=False)
    ev_ms, ev_spread = timed(lambda: batched_nms.batched_nms_mask(nb, ns), 50)
    plain_ms, plain_spread = timed(lambda: batched_nms.batched_nms_mask_reference(nb, ns), 1)
    bound_ms, bound_by, pairs = nms_bound(keep)
    full_ops, mask_bytes = nms_bitmask_work(*ns.shape)
    alive = int((ns > 0).sum())
    print(f"    NMS at the inference path's shape N={nb.shape[0]} K={nb.shape[1]}: {alive} candidates "
          f"with score > 0, {int(keep.sum())} kept, {pairs} pair tests needed")
    print(f"    NMS kernel (pair bitmask + scan, two launches a call), queued behind a device sleep, "
          f"inputs warm in the L2: {kernel_ms:.5f} ms {kernel_spread}; at the host's launch rate "
          f"(events over 50 calls): {ev_ms:.5f} ms {ev_spread}; plain PyTorch version: "
          f"{plain_ms:.4f} ms {plain_spread}; bound {bound_ms:.6f} ms ({bound_by}); library: "
          f"none (no single PyTorch call computes a greedy-NMS keep mask)  [{card}]")
    lane_pairs = nms_tile_pairs(ns)
    print(f"    NMS bitmask's work: {full_ops} operations for all K(K-1)/2 pairs "
          f"({full_ops / (NMS_OPS_PER_PAIR * pairs):.3f}x the bound's {NMS_OPS_PER_PAIR * pairs}; "
          f"{full_ops / H100_F32_FLOPS * 1e3:.6f} ms at the f32 peak), {lane_pairs} pair tests issued "
          f"by the tiles ({lane_pairs / pairs:.3f}x the bound's pairs), mask {mask_bytes} bytes written "
          f"and read ({mask_bytes / H100_BYTES_PER_S * 1e3:.6f} ms at the HBM rate)")
    for name, ms in device_split(lambda: batched_nms.batched_nms_mask(nb, ns)):
        print(f"      profiler: {ms:.5f} ms per call  {name[:80]}")
    return ({"launches": launches, "ms": kernel_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by},
            {"model_f32": model_f32, "model_bf16": model_bf16, "raw_f32": raw_f32_b32,
             "request": (y1, c1), "planes": (y32, c32)})


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


def device_split(fn, n=20):
    """(kernel name, device ms per call) for each kernel `fn` launches:
    torch.profiler over n calls, after one untraced call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return split or [("no device time recorded (not measured)", float("nan"))]


def forward_launches(fn, n=3):
    """(kernel launches, kernels' device ms) per call of `fn`, from
    torch.profiler over n calls after one untraced call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in kernels) / n, sum(e.self_device_time_total for e in kernels) / 1e3 / n


def request_ms(fn, requests=20, windows=5):
    """Host ms of one request (`fn()` then synchronize), mean of `requests` a
    window, after 5 untimed requests: (median, range) over `windows`
    windows."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per_window = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(requests):
            fn()
            torch.cuda.synchronize()
        per_window.append((time.perf_counter() - t0) * 1e3 / requests)
    return float(np.median(per_window)), f"[{min(per_window):.4f}-{max(per_window):.4f}]"


def rounds(arms: dict, measure, n_rounds: int) -> dict:
    """`measure(fn)` -> (ms, range) of each arm in `n_rounds` rotating
    rounds (round r starts at arm r mod len(arms)); {arm: [ms per round]}."""
    names = list(arms)
    out = {name: [] for name in names}
    for r in range(n_rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            out[name].append(measure(arms[name])[0])
    return out


def encoder_sims(encoder, batch):
    """The similarities and row mask `encoder` hands the matching kernel for
    `batch`."""
    from jpeg_detection_resnet_ssd_torch.boxes import target_encoder

    match, seen = target_encoder.bipartite_match, []

    def record(sims, impl, row_mask=None):
        seen.append((sims.clone(), row_mask.clone()))
        return match(sims, impl=impl, row_mask=row_mask)

    target_encoder.bipartite_match = record
    try:
        encoder(batch["gt"], batch["gt_mask"])
    finally:
        target_encoder.bipartite_match = match
    return seen[0]


def run_training(dev, card, stress_sims, stress_mask):
    """Phases 7 and 8 (checks) and the training half of phase 9 (timings)."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models import layers
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import batch_norm
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
        batch_norm.LAUNCHES = 0
        trainer, history = fit(cfg, batches, run_dir=run_dir, target_encoder=encoder,
                               log_every=1, save_every=5)
        torch.cuda.synchronize()
        launches = {"match": bm.LAUNCHES, "wgrad": conv_grad.LAUNCHES, "bn": batch_norm.LAUNCHES}
        copies, pads = conv_grad.LAYOUT_COPIES, conv_grad.PAD_COPIES
        print(f"    fit: {time.perf_counter() - t0:.2f} s (first step builds nothing: kernels "
              f"were built in phase 2); losses "
              + ", ".join(f"{r['total_loss']:.4f}" for r in history))
        print(f"    kernel launches on the training path: matching {launches['match']}, "
              f"filter gradient {launches['wgrad']}, BatchNorm {launches['bn']}; layout copies before the filter-gradient "
              f"kernel: {copies}; padding copies for TMA: {pads} ({pads / 5:g} per step)")
        check(len(history) == 5 and all(np.isfinite(r["total_loss"]) for r in history),
              "5 steps, every loss finite")
        check(launches["match"] == 5, "the matching kernel ran once per step")
        check(launches["wgrad"] == 24 * 5, "the filter-gradient kernel ran 24 times per step")
        check(launches["bn"] == BN_LAUNCHES_PER_STEP * 5,
              f"the BatchNorm kernels ran {BN_LAUNCHES_PER_STEP} times per step (71 layers)")
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

    # Matching, queued behind a device sleep: from main memory (the calls
    # cycle through copies of the similarities, 4x the L2) and warm in the
    # L2; the bound reads the live rows once, and the full matrix's bound
    # (every row read) is printed beside it.
    sims, gt_mask = encoder_sims(encoder, batch)
    print("    matching at (32, 64, 8732), queued behind a device sleep; plain version at the host's rate")
    match_row = None
    for label, s, row_mask in (
            (f"train batch's IoUs ({len(BENCH_GT)} GT per image), GT row mask (the main path)", sims, gt_mask),
            (f"train batch's IoUs ({len(BENCH_GT)} GT per image), no mask", sims, None),
            ("phase 4's stress IoUs (1-10 GT per image, one image of 64, duplicate boxes), GT row mask",
             stress_sims, stress_mask),
            ("phase 4's stress IoUs, no mask", stress_sims, None)):
        k_ms, k_spread = queued_ms(lambda t: bm.bipartite_match(t, impl="kernel", row_mask=row_mask), s)
        w_ms, w_spread = queued_ms(lambda t: bm.bipartite_match(t, impl="kernel", row_mask=row_mask), s,
                                   cold=False)
        p_ms, p_spread = timed(lambda: bm.bipartite_match_reference(s, row_mask), 2, warmup_s=0.2)
        b_ms, b_by = match_bound(s, row_mask)
        full_ms, _ = match_bound(s)
        print(f"    matching, {label}: kernel {k_ms:.5f} ms {k_spread} from main memory, {w_ms:.5f} ms "
              f"{w_spread} warm in the L2; plain {p_ms:.4f} ms {p_spread}; bound {b_ms:.6f} ms ({b_by}; "
              f"full-matrix bound {full_ms:.6f} ms); library: none  [{card}]")
        if match_row is None:
            match_row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by}

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
        "match": {"launches": launches["match"], **match_row},
        "bn_launches": launches["bn"],
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



EVAL_IMAGES, EVAL_BATCH = 64, 8  # the evaluate loop's images and `evaluate`'s default batch


def eval_batches(rng, infer, n_images=EVAL_IMAGES, batch=EVAL_BATCH):
    """Batches in `DetectionPipeline`'s evaluation contract: seeded DCT
    planes as NumPy arrays (Y ~ N(0, 100), CbCr ~ N(0, 30), as phase 6 makes
    them) and GT in the 300x300 frame (so no inverters): in each image 1-4
    random boxes and 2-5 of the model's detections (from `infer`, a pass
    before the evaluator's) shifted by up to 8 pixels, so that the mAP
    compared below is not 0; a quarter of the boxes 'difficult'."""
    out = []
    for b in range(n_images // batch):
        inputs = (rng.normal(0, 100, (batch, 38, 38, 64)).astype(np.float32),
                  rng.normal(0, 30, (batch, 19, 19, 128)).astype(np.float32))
        dets = infer(inputs).cpu().numpy()
        labels, difficult = [], []
        for i in range(batch):
            k = int(rng.integers(1, 5))
            xy0 = rng.uniform(0, 240, (k, 2))
            xy1 = np.minimum(xy0 + rng.uniform(10, 200, (k, 2)), 300)
            near = dets[i, rng.choice(50, int(rng.integers(2, 6)), replace=False)][:, [0, 2, 3, 4, 5]]
            near[:, 1:] += rng.uniform(-8, 8, (len(near), 4))
            rows = np.concatenate([np.concatenate([rng.integers(1, 21, (k, 1)), xy0, xy1], 1), near])
            labels.append(rows.astype(np.float32))
            difficult.append(rng.random(len(rows)) < 0.25)
        out.append({
            "inputs": inputs, "labels": labels, "difficult": difficult,
            "inverters": [None] * batch, "image_ids": [f"{b * batch + i:06d}" for i in range(batch)],
        })
    return out


def run_evaluate(card, model_f32, model_bf16, raw_f32, request, planes):
    """Phase 9d: the evaluate path (`DetectionEvaluator` over the `exact`
    inference function) and the A16 decoders on phase 6's calibrated model,
    in float32 with TF32 off; then the evaluate loop's and a request's
    times.  The card's machine has no libjpeg (no header, no library: the
    installation probe recorded in README.md), so this phase has no JPEG
    step; the JPEG half of the path runs in the CPU tests."""
    from jpeg_detection_resnet_ssd_torch.boxes import decode as dec
    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.eval import DetectionEvaluator, num_gt_per_class
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms

    print(f"[9d] evaluate path: DetectionEvaluator over the exact decode, {EVAL_IMAGES} images at "
          f"batch {EVAL_BATCH}, f32 (TF32 off); A16 decoders")
    decode = {impl: make_inference_fn(n_classes=20, spec=AnchorSpec(), candidate_selector="exact",
                                      nms_impl=impl)
              for impl in ("kernel", "reference")}
    with torch.no_grad():
        batches = eval_batches(np.random.default_rng(5), lambda x: decode["kernel"](model_f32(x)))
    raws, dets = [], []

    def infer_kernel(inputs):
        with torch.no_grad():
            raw = model_f32(inputs)
        raws.append(raw)
        dets.append(decode["kernel"](raw))
        return dets[-1]

    replay = iter(raws)
    batched_nms.LAUNCHES = 0
    ev_kernel = DetectionEvaluator(infer_kernel, batches, n_classes=20)
    map_kernel, aps_kernel, _ = ev_kernel()
    torch.cuda.synchronize()
    launches = batched_nms.LAUNCHES
    print(f"    NMS kernel launches on the evaluate path: {launches}")
    check(launches == len(batches), f"one NMS kernel call per batch ({len(batches)} batches)")
    ev_plain = DetectionEvaluator(lambda _: decode["reference"](next(replay)), batches, n_classes=20)
    map_plain, aps_plain, _ = ev_plain()
    n_preds = sum(map(len, ev_kernel.prediction_results))
    check(batched_nms.LAUNCHES == launches, "the plain run launched no NMS kernel")
    check(ev_kernel.prediction_results == ev_plain.prediction_results and n_preds > 0,
          f"kernel and plain NMS: identical per-class prediction lists ({n_preds} predictions)")
    check(map_kernel == map_plain and aps_kernel == aps_plain and map_kernel > 0,
          f"kernel and plain NMS: equal mAP ({map_kernel!r}) and per-class APs")
    check(all(d.shape == (EVAL_BATCH, 200, 6) and bool(torch.isfinite(d).all()) for d in dets),
          f"evaluate detections: ({EVAL_BATCH}, 200, 6) and finite in every batch")

    # Each image's own detections with score >= 0.5 as its ground truth.
    own = []
    for batch, det in zip(batches, dets):
        rows = [d[d[:, 1] >= 0.5].cpu().numpy() for d in det]
        own.append({**batch, "labels": [r[:, [0, 2, 3, 4, 5]] for r in rows],
                    "difficult": [np.zeros(len(r), bool) for r in rows]})
    replay_dets = iter(dets)
    ev_own = DetectionEvaluator(lambda _: next(replay_dets), own, n_classes=20)
    _, aps_own, _ = ev_own(average_precision_mode="sample")
    n_gt = num_gt_per_class(ev_own.ground_truth, 20)
    present = [c for c in range(1, 21) if n_gt[c] > 0]
    map_own = float(np.mean([aps_own[c] for c in present])) if present else float("nan")
    check(bool(present) and map_own == 1.0,
          f"mAP exactly 1.0 on the model's own detections >= 0.5 as GT "
          f"({int(n_gt.sum())} GT boxes in {len(present)} classes; 11-point AP)")

    # The A16 decoders on phase 6's raw f32 predictions (batch 32).
    _, boxes = dec.decode_raw_predictions(raw_f32[0], img_height=300, img_width=300)
    cls = int((raw_f32[0, :, 1:21] > 0.01).sum(0).argmax()) + 1
    a16 = {
        "decode_detections_fast": lambda impl: dec.decode_detections_fast(raw_f32, nms_impl=impl),
        "decode_detections_debug": lambda impl: dec.decode_detections_debug(
            raw_f32, n_classes=20, nms_impl=impl),
        f"nms_per_class (image 0, class {cls}, K = 400)": lambda impl: torch.cat(
            [t.reshape(400, -1) for t in dec.nms_per_class(boxes, raw_f32[0, :, cls], nms_impl=impl)], 1),
    }
    for name, fn in a16.items():
        batched_nms.LAUNCHES = 0
        got = fn("kernel")
        torch.cuda.synchronize()
        n_launch = batched_nms.LAUNCHES
        ref = fn("reference")
        check(n_launch == 1 and torch.equal(got, ref),
              f"{name}: kernel == plain NMS (torch.equal), {n_launch} NMS kernel call, "
              f"{int((got[..., -5] > 0).sum())} rows kept")

    print(f"[9d] evaluate timings on {card}: median [min-max] of 5 windows, each one "
          f"DetectionEvaluator run over {EVAL_IMAGES} images at batch {EVAL_BATCH}")
    for label, model in (("f32", model_f32), ("bf16", model_bf16)):
        walls, devs, hosts = [], [], []
        for w in range(6):  # the first run warms up
            spans = []

            def infer(inputs):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                with torch.no_grad():
                    out = decode["kernel"](model(inputs))
                end.record()
                spans.append((start, end))
                return out

            ev = DetectionEvaluator(infer, batches, n_classes=20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev()
            wall_ms = (time.perf_counter() - t0) * 1e3
            dev_ms = sum(a.elapsed_time(b) for a, b in spans)
            if w:
                walls.append(wall_ms)
                devs.append(dev_ms)
                hosts.append(wall_ms - dev_ms)
        if label == "f32":
            profile_steps(lambda: DetectionEvaluator(infer, batches, n_classes=20)(), card,
                          float(np.median(walls)), n=2, label="evaluate runs (f32)")
        rate = [EVAL_IMAGES / (x * 1e-3) for x in walls]
        print(f"    evaluate loop {label}: {float(np.median(rate)):.1f} images/s "
              f"[{min(rate):.1f}-{max(rate):.1f}]; {float(np.median(walls)):.3f} ms a run "
              f"[{min(walls):.3f}-{max(walls):.3f}]; device (events around the infer function) "
              f"{float(np.median(devs)):.3f} ms [{min(devs):.3f}-{max(devs):.3f}]; host (the rest of "
              f"predict_on_dataset, then matching and AP) {float(np.median(hosts)):.3f} ms "
              f"[{min(hosts):.3f}-{max(hosts):.3f}]  [{card}]")

    decode_exact = decode["kernel"]
    for label, model in (("f32", model_f32), ("bf16", model_bf16)):
        with torch.no_grad():
            ms, spread = request_ms(lambda: decode_exact(model(request)))
        print(f"    batch-1 latency, forward + exact decode, {label}: {ms:.4f} ms {spread} "
              f"(host clock to synchronize, mean of 20 requests a window)  [{card}]")


DETECT_IMAGES, DETECT_SIDE = 96, 352  # phase 9e's corpus: 96 images at 352 px (44 luma blocks)


def write_detect_inputs(root: str, n: int = DETECT_IMAGES, side: int = DETECT_SIDE,
                        seed: int = 95) -> tuple[str, str]:
    """Phase 9e's inputs, written with NumPy alone (the card's machine has no
    libjpeg): a VOC tree of `n` annotations (`Annotations/*.xml`, 1-4 boxes
    in images of 200-500 px a side, `ImageSets/Main/trainval.txt`) and its
    packed corpus at `side` px (a multiple of 16) in `data/packed.py`'s
    files: Y ~ N(0, 100) and CbCr ~ N(0, 30) as int16, the XML boxes scaled
    as `PackedDctDataset.create` scales them.  Returns (VOC root, corpus
    stem)."""
    from jpeg_detection_resnet_ssd_torch.data.datasets import VOC_CLASSES

    rng = np.random.default_rng(seed)
    voc, stem = os.path.join(root, "voc"), os.path.join(root, "pack", f"voc{side}")
    for sub in ("Annotations", os.path.join("ImageSets", "Main"), "JPEGImages"):
        os.makedirs(os.path.join(voc, sub), exist_ok=True)
    os.makedirs(os.path.dirname(stem))
    b8 = side // 8
    gt = np.zeros((n, 64, 5), np.float32)
    mask = np.zeros((n, 64), bool)
    ids = [f"{i:06d}" for i in range(n)]
    for i, image_id in enumerate(ids):
        h, w = (int(v) for v in rng.integers(200, 501, 2))
        k = int(rng.integers(1, 5))
        x0, y0 = rng.integers(0, w - 40, k), rng.integers(0, h - 40, k)
        x1 = np.minimum(x0 + rng.integers(20, w // 2, k), w)
        y1 = np.minimum(y0 + rng.integers(20, h // 2, k), h)
        cls = rng.integers(0, 20, k)
        objs = "".join(
            f"<object><name>{VOC_CLASSES[c]}</name><difficult>0</difficult><bndbox>"
            f"<xmin>{xa}</xmin><ymin>{ya}</ymin><xmax>{xb}</xmax><ymax>{yb}</ymax></bndbox></object>"
            for c, xa, ya, xb, yb in zip(cls, x0, y0, x1, y1))
        with open(os.path.join(voc, "Annotations", image_id + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>{w}</width><height>{h}</height></size>{objs}"
                    "</annotation>")
        labels = np.stack([cls + 1, x0, y0, x1, y1], 1).astype(np.float32)
        labels[:, [1, 3]] *= side / w
        labels[:, [2, 4]] *= side / h
        gt[i, :k], mask[i, :k] = labels, True
    with open(os.path.join(voc, "ImageSets", "Main", "trainval.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    np.save(stem + ".y.npy", rng.normal(0, 100, (n, b8, b8, 64)).astype(np.int16))
    np.save(stem + ".cbcr.npy", rng.normal(0, 30, (n, b8 // 2, b8 // 2, 128)).astype(np.int16))
    np.savez(stem + ".labels.npz", gt=gt, gt_mask=mask, image_ids=np.asarray(ids))
    with open(stem + ".meta.json", "w") as f:
        json.dump({"n": n, "img_height": side, "img_width": side, "max_gt": 64, "quality": 75}, f)
    return voc, stem


def run_cli(argv) -> tuple[str, dict]:
    """`cli.main(argv)` in this process; returns the run dir and the last
    history row that it prints."""
    import re

    from jpeg_detection_resnet_ssd_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return re.search(r"run dir: (\S+)", out.getvalue()).group(1), json.loads(lines[-1])


def run_train_detect(card):
    """Phase 9e: `python -m jpeg_detection_resnet_ssd_torch.cli train-detect
    --device-augment --pack-cache` in this process, from a NumPy-written
    corpus, at batch 32 bf16 with all three kernels; a restart; the fused
    steps against single steps in float32 (C2); the data path's times."""
    from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset, PackedDctPipeline
    from jpeg_detection_resnet_ssd_torch.data.pipeline import prefetch_to_device
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad, dct_flip
    from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig

    print(f"[9e] the train-detect CLI from a packed corpus ({DETECT_IMAGES} images at "
          f"{DETECT_SIDE} px): batch 32 bf16, --device-augment --pallas-wgrad")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        voc, stem = write_detect_inputs(tmp)
        print(f"    wrote the VOC tree and its corpus with NumPy in {time.perf_counter() - t0:.2f} s "
              f"({sum(os.path.getsize(stem + e) for e in ('.y.npy', '.cbcr.npy')) / 1e6:.1f} MB)")
        common = ["train-detect", "--voc-root", voc, "--device-augment", "--pack-cache", stem]
        bf16 = common + ["--output-dir", os.path.join(tmp, "exp"), "--pallas-wgrad",
                         "--batch-size", 32, "--steps-per-epoch", 3, "--epochs", 2]
        runs = []
        for extra in (["--max-steps", 3], ["--max-steps", 6, "--restart"]):
            bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
            t0 = time.perf_counter()
            run_dir, row = run_cli(bf16 + extra)
            torch.cuda.synchronize()
            launches = {"match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES, "wgrad": conv_grad.LAUNCHES}
            runs.append((run_dir, row, launches))
            print(f"    {' '.join(map(str, extra))}: {time.perf_counter() - t0:.2f} s in cli.main; "
                  f"row {json.dumps(row)}; kernel launches: matching {launches['match']}, flip "
                  f"{launches['flip']}, filter gradient {launches['wgrad']}")
            check(np.isfinite(row["total_loss"]) and row["step"] == 3 * len(runs),
                  f"run {len(runs)}: the row's total_loss is finite at step {3 * len(runs)}")
            check(launches == {"match": 3, "flip": 6, "wgrad": 72},
                  "3 steps launched matching 1, flip 2 and filter gradient 24 times a step")
        (run_dir, _, _), (run_dir2, row2, _) = runs
        check(CheckpointManager(os.path.join(run_dir, "checkpoints")).all_steps() == [3, 6],
              "checkpoints at steps 3 and 6")
        check(run_dir2 == run_dir and row2["epoch"] == 1, "--restart reused the run dir for epoch 1")
        warm_ms = row2["time_s"] * 1e3 / 3
        print(f"    warm steps (the restart's epoch, 3 steps after a cold first run; fit's time_s, "
              f"10 ms resolution): {warm_ms:.1f} ms a step, {1e3 / warm_ms:.3f} steps/s, "
              f"{32e3 / warm_ms:.1f} images/s; first run's epoch with its cold first step "
              f"{runs[0][1]['time_s'] * 1e3 / 3:.1f} ms a step  [{card}]")

        # C2: --steps-per-call 3 trains what --steps-per-call 1 trains.  The
        # card's backward is not bit-reproducible from run to run (atomic
        # adds, e.g. in the overlapping max pool's backward), and the f32
        # gradients at this random init amplify a last-bit difference; so
        # the filter gradient runs on B4 (a fixed summation order), cuDNN
        # takes deterministic algorithms, and a second --steps-per-call 1
        # run measures what is left of the run-to-run spread.
        cfg = os.path.join(tmp, "f32.json")
        with open(cfg, "w") as f:
            f.write(ExperimentConfig(compute_dtype="float32", model_kwargs={"n_classes": 20},
                                     batch_size=2).to_json())
        finals = []
        torch.backends.cudnn.deterministic = True
        for i, spc in enumerate((3, 1, 1)):
            run_dir, row = run_cli(common + ["--config", cfg, "--output-dir", os.path.join(tmp, f"c2_{i}"),
                                             "--pallas-wgrad", "--steps-per-epoch", 3, "--epochs", 1,
                                             "--steps-per-call", spc])
            state = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000003.pt"),
                               map_location="cpu", weights_only=True)["model"]
            finals.append((row["total_loss"], state))
        torch.backends.cudnn.deterministic = False

        def differ(a, b):
            (loss_a, p_a), (loss_b, p_b) = a, b
            keys = [k for k, v in p_b.items() if v.is_floating_point()]
            p_err = max(float((p_a[k] - p_b[k]).abs().max()) for k in keys)
            p_max = max(float(p_b[k].abs().max()) for k in keys)
            same = all(torch.equal(p_a[k], p_b[k]) for k in p_b)
            return abs(loss_a - loss_b) / abs(loss_b), p_err, p_max, same

        c2 = differ(finals[0], finals[1])
        floor = differ(finals[2], finals[1])
        for label, (loss_err, p_err, p_max, same) in (("--steps-per-call 3 vs 1", c2),
                                                      ("1 vs 1 again (run-to-run)", floor)):
            print(f"    C2, float32 at batch 2, TF32 off, B4, deterministic cuDNN, 3 steps, {label}: "
                  f"total_loss relative diff {loss_err:.3g}; parameters max |diff| {p_err:.3g} of "
                  f"max |p| {p_max:.4g}; bit-identical: {same}")
        check(c2[0] <= 1e-4, "C2: the losses agree within 1e-4")
        check(c2[1] <= 1e-3 * c2[2], "C2: the parameters agree within 1e-3 of the largest")

        # The data path's host and copy times.
        pipe = PackedDctPipeline(PackedDctDataset(stem), 32, seed=0, ship_dtype="int16")
        batch_ms = []
        for _ in range(5):
            it = iter(pipe)
            for _ in range(len(pipe)):
                t0 = time.perf_counter()
                batch = next(it)
                batch_ms.append((time.perf_counter() - t0) * 1e3)
        nbytes = sum(a.nbytes for a in (*batch["inputs"], batch["gt"], batch["gt_mask"]))
        print(f"    PackedDctPipeline batch of 32 (gather + cast to int16), host: "
              f"{float(np.median(batch_ms)):.4f} ms [{min(batch_ms):.4f}-{max(batch_ms):.4f}] "
              f"(median of {len(batch_ms)}, host clock), {nbytes / 1e6:.3f} MB a batch  [{card}]")
        arrays = [*batch["inputs"], batch["gt"], batch["gt_mask"]]
        pinned = [torch.from_numpy(a).pin_memory() for a in arrays]
        pin_ms, pin_spread = timed(lambda: [t.to("cuda", non_blocking=True) for t in pinned], 20)
        page_ms, page_spread = timed(lambda: [torch.from_numpy(a).to("cuda") for a in arrays], 20)
        staged_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = sum(1 for _ in prefetch_to_device(iter(pipe), size=2, device="cuda"))
            torch.cuda.synchronize()
            staged_ms.append((time.perf_counter() - t0) * 1e3 / n)
        print(f"    one batch to the card: from pinned memory {pin_ms:.4f} ms {pin_spread} "
              f"({nbytes / pin_ms / 1e6:.2f} GB/s), from pageable memory {page_ms:.4f} ms "
              f"{page_spread} ({nbytes / page_ms / 1e6:.2f} GB/s) (CUDA events, median of 5 "
              f"windows of 20); prefetch_to_device over an epoch (gather, pin, copy on a side "
              f"stream): {float(np.median(staged_ms)):.4f} ms a batch "
              f"[{min(staged_ms):.4f}-{max(staged_ms):.4f}] (host clock)  [{card}]")


# Phase 9f: resnet50_dct_late_concat_rfa_thinner at 224 px (28-block Y maps).
CLS_MODEL = "resnet50_dct_late_concat_rfa_thinner"
CLS_IMAGES, CLS_SIDE, CLS_BATCH, CLS_CLASSES = 192, 256, 64, 8  # phase 9f's corpus: 256 px sources
# The 18 filter gradients of one step of CLS_MODEL: (H, C, K, count); and
# resnet50_rgb's 3x3 convs at maps the DCT stem does not reach.
CLS_WGRAD_SHAPES = (
    (28, 256, 256, 1), (28, 128, 128, 4), (14, 256, 256, 1), (14, 128, 128, 3),
    (7, 256, 256, 6), (4, 512, 512, 3),
)
RGB_WGRAD_SHAPES = ((56, 64, 64, 3), (7, 512, 512, 3))


def cls_planes(rng, b, blocks=28, split=False, dtype=np.float32):
    """Seeded classification planes as NumPy arrays: Y ~ N(0, 100) with
    `blocks` luma blocks a side, CbCr ~ N(0, 30) (as Cb and Cr with `split`)."""
    y = rng.normal(0, 100, (b, blocks, blocks, 64)).astype(dtype)
    cbcr = rng.normal(0, 30, (b, blocks // 2, blocks // 2, 128)).astype(dtype)
    return (y, cbcr[..., :64].copy(), cbcr[..., 64:].copy()) if split else (y, cbcr)


def write_classify_inputs(root: str, n: int = CLS_IMAGES, side: int = CLS_SIDE,
                          n_classes: int = CLS_CLASSES, seed: int = 97) -> tuple[str, str]:
    """Phase 9f's inputs, written with NumPy alone (the card's machine has no
    libjpeg): an ImageFolder of `n` empty `.jpeg` names in `n_classes` class
    dirs (`ImageFolderDataset` lists them; nothing decodes them) and its
    packed classification corpus at `side` px in `data/packed.py`'s files:
    Y ~ N(0, 100) and CbCr ~ N(0, 30) as int16, the labels in the
    dataset's order.  Returns (ImageFolder root, corpus stem)."""
    rng = np.random.default_rng(seed)
    folder, stem = os.path.join(root, "imagenet"), os.path.join(root, "pack", f"cls{side}")
    os.makedirs(os.path.dirname(stem))
    per = n // n_classes
    labels = np.repeat(np.arange(n_classes, dtype=np.int32), per)
    ids = []
    for c in range(n_classes):
        os.makedirs(os.path.join(folder, f"c{c:03d}"))
        for j in range(per):
            open(os.path.join(folder, f"c{c:03d}", f"{j:04d}.jpeg"), "w").close()
            ids.append(f"{j:04d}.jpeg")
    y, cbcr = cls_planes(rng, len(labels), side // 8, dtype=np.int16)
    np.save(stem + ".y.npy", y)
    np.save(stem + ".cbcr.npy", cbcr)
    np.savez(stem + ".labels.npz", labels=labels, image_ids=np.asarray(ids))
    with open(stem + ".meta.json", "w") as f:
        json.dump({"n": len(labels), "img_size": side, "quality": 75, "task": "classification"}, f)
    return folder, stem


def run_classification(dev, card):
    """Phase 9f: the classification path of the port on the card."""
    import copy

    from jpeg_detection_resnet_ssd_torch.eval import ClassificationEvaluator
    from jpeg_detection_resnet_ssd_torch.models import CLASSIFICATION_ARCHIS, build_model
    from jpeg_detection_resnet_ssd_torch.ops import _draws, conv_grad, dct_augment, dct_flip
    from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig, build_trainer

    print(f"[9f] classification: {CLS_MODEL} and the other ResNet-50s at 224 px, 1000 classes")
    # 1. Forward parity, float32 (TF32 off), batch 2, BatchNorm calibrated on
    # the batch (identity statistics would overflow on N(0, 100) planes).
    rng = np.random.default_rng(90)
    calibrated = None
    for name in [f"resnet50_dct_{a}" for a in CLASSIFICATION_ARCHIS] + ["resnet50_rgb"]:
        cpu_model, example = build_model(name, device="cpu")
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        inputs = example(rng)
        on_dev = (tuple(torch.from_numpy(a).to(dev) for a in inputs) if isinstance(inputs, tuple)
                  else torch.from_numpy(inputs).to(dev))
        calibrate_batch_norm(gpu_model, on_dev)
        cpu_model.load_state_dict(gpu_model.state_dict())
        with torch.no_grad():
            got = gpu_model(on_dev).cpu()
            ref = cpu_model(inputs)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        check(got.shape == (2, 1000) and bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
              f"{name}: card forward = CPU forward, max |diff| {err:.3g} <= 1e-3 * {scale:.4g}")
        if name == CLS_MODEL:
            calibrated = gpu_model
        del cpu_model

    # 2. B4 at the classification shapes, batch 64: bf16 and float32 against
    # the plain version, two bf16 calls bit-identical; then timed per shape
    # queued behind a device sleep (warm in the L2) against cuDNN's filter
    # gradient and the bound.
    gen = torch.Generator().manual_seed(91)
    worst = 0.0
    for h, c, k, count in CLS_WGRAD_SHAPES + RGB_WGRAD_SHAPES:
        x32 = torch.randn(CLS_BATCH, h, h, c, generator=gen).to(dev)
        dy32 = torch.randn(CLS_BATCH, h, h, k, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, dy = x32.to(dtype), dy32.to(dtype)
            got = conv_grad.conv3x3_filter_grad(x, dy)
            torch.cuda.synchronize()
            ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            worst = max(worst, err)
            again = conv_grad.conv3x3_filter_grad(x, dy)
            check(err <= WGRAD_TOL * scale and torch.equal(again.view(torch.int32), got.view(torch.int32)),
                  f"dW {str(dtype)[6:]:8s} B={CLS_BATCH} {h}x{h} {c}->{k} (x{count}): max |diff| "
                  f"{err:.3g} <= {WGRAD_TOL:g} * {scale:.4g}; a second call gives the same bits")
    print(f"    filter gradient per conv, bf16, batch {CLS_BATCH}, queued behind a device sleep, "
          "inputs warm in the L2")
    wsum = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    wby = {"operations": 0, "bytes": 0}
    for h, c, k, count in CLS_WGRAD_SHAPES + RGB_WGRAD_SHAPES:
        x = torch.randn(CLS_BATCH, h, h, c, generator=gen).to(dev, torch.bfloat16)
        dy = torch.randn(CLS_BATCH, h, h, k, generator=gen).to(dev, torch.bfloat16)
        w = torch.zeros(k, c, 3, 3, device=dev, dtype=torch.bfloat16)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        plan = conv_grad.tiling_plan(CLS_BATCH, h, h, c, k)
        kern, kern_s = queued_ms(lambda _: conv_grad.conv3x3_filter_grad(x, dy), x, iters=50, cold=False)
        lib, lib_s = queued_ms(lambda _: torch.ops.aten.convolution_backward(
            dyn, xn, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False]), x,
            iters=50, cold=False)
        plain, _ = timed(lambda: conv_grad.conv3x3_filter_grad_reference(x, dy), 3, warmup_s=0.1)
        bound, by = wgrad_bound(CLS_BATCH * h * h, c, k, torch.bfloat16)
        on_path = (h, c, k, count) in CLS_WGRAD_SHAPES
        if on_path:
            for key, v in (("ms", kern), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
                wsum[key] += count * v
            wby[by] += count
        tflops = 2 * 9 * CLS_BATCH * h * h * c * k / (kern * 1e-3) / 1e12
        print(f"    dW bf16 B={CLS_BATCH} {h:2d}x{h:<2d} {c:3d}->{k:<3d} x{count}"
              f"{'' if on_path else ' (resnet50_rgb)'}: kernel {kern:.5f} ms {kern_s} = {tflops:.1f} "
              f"TFLOP/s, {100 * bound / kern:.1f}% of the bound {bound:.5f} ({by}); cuDNN {lib:.5f} "
              f"{lib_s}; kernel/cuDNN {kern / lib:.2f}; plain {plain:.4f}; box {plan.w_box}x"
              f"{plan.rows}x{plan.images}, tile {conv_grad.BLOCK_C}x{plan.n_tile}, {plan.splits} "
              f"splits  [{card}]")
    print(f"    dW per classification step (18 convs): kernel {wsum['ms']:.4f} ms, "
          f"{100 * wsum['bound_ms'] / wsum['ms']:.1f}% of the bound {wsum['bound_ms']:.4f} ms; cuDNN "
          f"{wsum['library_ms']:.4f} ms; plain {wsum['plain_ms']:.4f} ms  [{card}]")

    # 3. B3 inside the v2 augment: each flip the augment asks for, kernel
    # against the plain version bit for bit; and the card's apply against the
    # CPU's on one set of host draws, within 1e-4 of the largest value: the
    # resize's two batched einsums each sum 256 products per output in
    # another order on the card (TF32 off), which moved the 64 images'
    # coefficients by up to 3.5e-5 of the largest on an H100 80GB HBM3 at 700 W.
    aug = dct_augment.make_dct_classification_augment_v2(28)
    aug_cpu = dct_augment.make_dct_classification_augment_v2(28, device="cpu")
    src = {"inputs": cls_planes(rng, CLS_BATCH, CLS_SIDE // 8, dtype=np.int16),
           "labels": rng.integers(0, 1000, CLS_BATCH).astype(np.int32)}
    draws = aug_cpu.sample(CLS_BATCH, CLS_SIDE // 8, CLS_SIDE // 8, torch.Generator().manual_seed(92))
    flips, real_flip = [], dct_augment.dct_flip_horizontal

    def recording_flip(t, *a, **kw):
        out = real_flip(t, *a, **kw)
        flips.append((t, out))
        return out

    dct_augment.dct_flip_horizontal = recording_flip
    try:
        before = dct_flip.LAUNCHES
        out = aug.apply(aug.to_device(src), _draws.to_device(draws, dev))
        torch.cuda.synchronize()
        launches = dct_flip.LAUNCHES - before
    finally:
        dct_augment.dct_flip_horizontal = real_flip
    ref = aug_cpu.apply(aug_cpu.to_device(src), draws)
    errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max())
            for a, b in zip(out["inputs"], ref["inputs"])]
    check(launches == 2 and max(errs) <= 1e-4,
          f"v2 augment, batch {CLS_BATCH} from {CLS_SIDE // 8} blocks: card = CPU within "
          f"{max(errs):.3g} of the largest value; {launches} flip launches")
    flip_err = 0.0
    for t, got in flips:
        want = dct_flip.dct_flip_horizontal_reference(t)
        flip_err = max(flip_err, float((got - want).abs().max()))
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"flip {tuple(t.shape)} in the augment: kernel equals its plain version bit for bit")
    fsum = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for x in out["inputs"]:
        k_ms, k_spread = queued_ms(lambda t: dct_flip.dct_flip_horizontal(t, impl="kernel"), x)
        p_ms, _ = queued_ms(dct_flip.dct_flip_horizontal_reference, x)
        b_ms, b_by = flip_bound(x)
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
            fsum[key] += v
        print(f"    flip {tuple(x.shape)} float32, from main memory: kernel {k_ms:.5f} ms {k_spread} "
              f"({100 * b_ms / k_ms:.1f}% of the bound {b_ms:.5f}, {b_by}); plain {p_ms:.5f} ms  [{card}]")

    # 4. One float32 step at batch 2: card (kernels, TF32 off) vs the CPU.
    cfg32 = ExperimentConfig(model=CLS_MODEL, task="classification", compute_dtype="float32",
                             pallas_wgrad=True, model_kwargs={"num_classes": 1000}, learning_rate=0.1,
                             nesterov=True, l2_regularization=0.0)
    small = {"inputs": cls_planes(rng, 2), "labels": np.asarray([3, 998], np.int32)}
    gpu, gpu_model, _ = build_trainer(cfg32)
    cpu, cpu_model, _ = build_trainer(cfg32, device="cpu")
    cpu_model.load_state_dict(gpu_model.state_dict())
    conv_grad.LAUNCHES = 0
    m_gpu = gpu.train_step(small)
    torch.cuda.synchronize()
    n_wgrad = conv_grad.LAUNCHES
    m_cpu = cpu.train_step(small)
    a, b = float(m_gpu["loss"]), float(m_cpu["loss"])
    check(abs(a - b) <= 1e-4 * abs(b) and n_wgrad == 18,
          f"float32 step: loss card {a:.6f} vs CPU {b:.6f} (rtol 1e-4); {n_wgrad} filter gradients on B4")
    # The gradient is read from the momentum buffer, which the first step
    # sets to it: torch's multi-tensor Nesterov SGD on the card adds the
    # buffer into .grad in place.
    g = gpu.optimizer.state[gpu_model.fc1000.weight]["momentum_buffer"].cpu()
    r = cpu.optimizer.state[cpu_model.fc1000.weight]["momentum_buffer"]
    err = float((g - r).abs().max() / r.abs().max())
    check(err <= 1e-3, f"fc1000 gradient within {err:.3g} <= 1e-3 of max |ref|")
    del gpu, cpu, gpu_model, cpu_model

    # 5. The bf16 step at batch 64 through the v2 augment, three arms: B4;
    # cuDNN's dW; B4 with remat and the bf16 momentum.  Peak memory per arm
    # (the arm built and stepped alone above what was allocated before it),
    # then step times in rotating rounds.
    batch = {"inputs": tuple(torch.from_numpy(a).to(dev) for a in src["inputs"]),
             "labels": src["labels"]}
    arms, memory = {}, {}
    for arm, kw in (("B4", dict(pallas_wgrad=True)), ("cuDNN dW", dict(pallas_wgrad=False)),
                    ("B4 + remat + bf16 momentum", dict(pallas_wgrad=True, remat=True,
                                                        momentum_dtype="bfloat16"))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cfg = ExperimentConfig(model=CLS_MODEL, task="classification", compute_dtype="bfloat16",
                               model_kwargs={"num_classes": 1000}, learning_rate=0.1, nesterov=True,
                               l2_regularization=0.0, batch_size=CLS_BATCH, **kw)
        trainer, _, _ = build_trainer(cfg, augment_fn=aug)
        step_gen = torch.Generator().manual_seed(93)
        for _ in range(2):
            trainer.train_step(batch, step_gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
        m = trainer.train_step(batch, step_gen)
        torch.cuda.synchronize()
        memory[arm] = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"    {arm}: loss {float(m['loss']):.4f}; peak memory {memory[arm]:.1f} MiB "
              f"(torch.cuda.max_memory_allocated over a step, above what was allocated before the "
              f"arm was built); launches a step: B4 {conv_grad.LAUNCHES}, B3 {dct_flip.LAUNCHES}  [{card}]")
        check(np.isfinite(float(m["loss"])) and dct_flip.LAUNCHES == 2
              and conv_grad.LAUNCHES == (0 if arm == "cuDNN dW" else 18),
              f"{arm}: loss finite; 2 flips and {0 if arm == 'cuDNN dW' else 18} filter gradients "
              "on the kernels a step")
        arms[arm] = (trainer, step_gen)
    lever = "B4 + remat + bf16 momentum"
    check(memory[lever] < memory["B4"],
          f"remat + bf16 momentum lower the peak: {memory[lever]:.1f} < {memory['B4']:.1f} MiB")
    names = list(arms)
    step_ms = {arm: [] for arm in names}
    for rnd in range(3):  # each arm goes first once
        for arm in names[rnd:] + names[:rnd]:
            trainer, step_gen = arms[arm]
            step_ms[arm].append(timed(lambda: trainer.train_step(batch, step_gen), 2, warmup_s=0.5))
    for arm in names:
        ms = [m for m, _ in step_ms[arm]]
        print(f"    classification step, batch {CLS_BATCH} bf16 with the v2 augment, {arm}: "
              + ", ".join(f"{m:.3f} ms {spread}" for m, spread in step_ms[arm])
              + f" -> {CLS_BATCH * 1e3 / np.mean(ms):.1f} images/s  [{card}]")
    trainer, step_gen = arms["B4"]
    profile_steps(lambda: trainer.train_step(batch, step_gen), card,
                  float(np.median([m for m, _ in step_ms["B4"]])),
                  label="classification steps (B4, v2 augment)")
    del arms, trainer

    # 6. train-classify in this process from a NumPy-written packed corpus.
    with tempfile.TemporaryDirectory() as tmp:
        folder, stem = write_classify_inputs(tmp)
        common = ["train-classify", "--train-dir", folder, "--device-augment", "--pack-cache", stem,
                  "--pallas-wgrad", "--batch-size", CLS_BATCH, "--steps-per-epoch", 3, "--epochs", 2,
                  "--output-dir", os.path.join(tmp, "exp")]
        runs = []
        for extra in (["--max-steps", 3], ["--max-steps", 6, "--restart"]):
            conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
            t0 = time.perf_counter()
            run_dir, row = run_cli(common + extra)
            torch.cuda.synchronize()
            launches = {"flip": dct_flip.LAUNCHES, "wgrad": conv_grad.LAUNCHES}
            runs.append((run_dir, row, launches))
            print(f"    {' '.join(map(str, extra))}: {time.perf_counter() - t0:.2f} s in cli.main; row "
                  f"{json.dumps(row)}; kernel launches: flip {launches['flip']}, filter gradient "
                  f"{launches['wgrad']}")
            check(np.isfinite(row["loss"]) and row["step"] == 3 * len(runs),
                  f"train-classify run {len(runs)}: loss finite at step {3 * len(runs)}")
            check(launches == {"flip": 6, "wgrad": 54},
                  "3 steps launched flip 2 and filter gradient 18 times a step")
        (run_dir, _, _), (run_dir2, row2, _) = runs
        check(CheckpointManager(os.path.join(run_dir, "checkpoints")).all_steps() == [3, 6]
              and run_dir2 == run_dir and row2["epoch"] == 1,
              "checkpoints at steps 3 and 6; --restart reused the run dir for epoch 1")
        warm_ms = row2["time_s"] * 1e3 / 3
        print(f"    train-classify warm steps (the restart's epoch; fit's time_s, 10 ms resolution): "
              f"{warm_ms:.1f} ms a step, {CLS_BATCH * 1e3 / warm_ms:.1f} images/s  [{card}]")

    # 7. ClassificationEvaluator over the calibrated float32 model: half the
    # labels are the model's own top-1, so top-1 is known from the logits.
    eval_rng = np.random.default_rng(94)
    batches = []
    for _ in range(4):
        inputs = cls_planes(eval_rng, CLS_BATCH)
        with torch.no_grad():
            logits = calibrated(inputs).float().cpu()
        labels = eval_rng.integers(0, 1000, CLS_BATCH).astype(np.int32)
        labels[::2] = logits.argmax(-1).numpy()[::2]
        batches.append({"inputs": inputs, "labels": labels, "logits": logits})
    want1 = np.mean([float((b["logits"].argmax(-1).numpy() == b["labels"]).mean()) for b in batches])
    want5 = np.mean([float((b["logits"].topk(5).indices.numpy() == b["labels"][:, None]).any(-1).mean())
                     for b in batches])
    for dtype in (torch.float32, torch.bfloat16):
        calibrated.dtype = dtype
        ev = ClassificationEvaluator(calibrated, batches)
        res, run_s = None, []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev()
            run_s.append(time.perf_counter() - t0)
        if dtype == torch.float32:
            check(res["count"] == 4 * CLS_BATCH and abs(res["top1"] - want1) < 1e-12
                  and abs(res["top5"] - want5) < 1e-12,
                  f"evaluator: top-1 {res['top1']:.4f}, top-5 {res['top5']:.4f} as the logits give")
        print(f"    ClassificationEvaluator, {4 * CLS_BATCH} images at batch {CLS_BATCH}, "
              f"{str(dtype)[6:]}: top-1 {res['top1']:.4f}, top-5 {res['top5']:.4f}; "
              f"{4 * CLS_BATCH / float(np.median(run_s)):.1f} images/s (median of 3 runs, host clock)"
              f"  [{card}]")
    # launches: the 3-step train-classify run (the main path); the rest are
    # per classification step (18 convs, 2 flips at batch 64)
    return ({"launches": runs[0][2]["wgrad"], "max_abs_err": worst, **wsum,
             "bound_by": max(wby, key=wby.get), "shapes": [list(t) for t in CLS_WGRAD_SHAPES]},
            {"launches": runs[0][2]["flip"], "max_abs_err": flip_err, **fsum, "bound_by": "bytes",
             "library_ms": None, "shapes": [list(x.shape) for x in out["inputs"]]})


# Phase 9g: the other model families (ROADMAP A12b).  The 13 registry names
# beyond ssd300_ssd_custom and the ResNet-50s.
FAMILY_NAMES = ("vgga", "vggd", "vgga_dct", "vggd_dct", "vgga_dct_8x8", "vggd_dct_8x8",
                "ssd300_deconv", "ssd300_up_sampling", "ssd300_cb5_only", "ssd300_y_cb4_cbcr_cb5",
                "ssd300_vgg", "ssd300_vgg_dct", "ssd300_vgg_dct_image")
# B4 at the VGG models' 3x3 convs, (B, H = W, C, K, count on one ssd300_vgg_dct
# step).  First the 13 of `train-detect --vgg` (blocks 1, 4, 5 and the six
# head convs); then ssd300_vgg's blocks 1-3, whose 300- and 150-column rows
# are cut into column groups (C3), and the DCT image's conv4_1 (C = 196); then
# the VGG classifiers' convs at batch 64 (224 columns in block 1).
VGG_WGRAD_SHAPES = (
    (32, 38, 64, 256, 1), (32, 38, 256, 512, 1), (32, 38, 512, 512, 2), (32, 19, 640, 512, 1),
    (32, 19, 512, 512, 2), (32, 38, 512, 100, 1), (32, 19, 1024, 150, 1), (32, 10, 512, 150, 1),
    (32, 5, 256, 150, 1), (32, 3, 256, 100, 1), (32, 1, 256, 100, 1),
    (32, 300, 3, 64, 0), (32, 300, 64, 64, 0), (32, 150, 64, 128, 0), (32, 150, 128, 128, 0),
    (32, 75, 128, 256, 0), (32, 75, 256, 256, 0), (32, 38, 196, 512, 0),
    (64, 224, 3, 64, 0), (64, 224, 64, 64, 0), (64, 112, 64, 128, 0), (64, 112, 128, 128, 0),
    (64, 56, 128, 256, 0), (64, 56, 256, 256, 0), (64, 28, 256, 512, 0), (64, 28, 512, 512, 0),
    (64, 14, 512, 512, 0), (64, 28, 64, 256, 0), (64, 14, 640, 512, 0), (64, 28, 196, 512, 0),
)
# B4 launches per train step with --pallas-wgrad.
VGG_DCT_B4, IDENTICAL_B4 = 13, 20


def family_inputs(name, rng, batch):
    """Seeded inputs in `name`'s contract at `batch`, as NumPy arrays: the
    registry's example maker (batch 2, the JAX package's distributions)
    drawn from `rng` until the batch is full."""
    from jpeg_detection_resnet_ssd_torch.models.zoo import MODEL_REGISTRY

    with torch.device("meta"):
        _, example = MODEL_REGISTRY[name]()
    parts = [example(rng) for _ in range(-(-batch // 2))]
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate(planes)[:batch] for planes in zip(*parts))
    return np.concatenate(parts)[:batch]


def to_dev(inputs, dev):
    if isinstance(inputs, tuple):
        return tuple(torch.from_numpy(a).to(dev) for a in inputs)
    return torch.from_numpy(inputs).to(dev)


def run_other_families(dev, card):
    """Phase 9g: the VGG classifiers and the other SSD300 families (ROADMAP
    A12b) on the card, and B4 on maps wider than a stage (C3)."""
    import copy

    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.boxes.decode import decode_detections
    from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn, ssd_family
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms, conv_grad, dct_flip
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig, build_trainer

    print("[9g] the other model families: 6 VGG classifiers, 4 ResNet 'identical' and 3 VGG SSD300s")
    # 1. B4 at the VGG shapes, bf16 and float32, against the plain version;
    # two bf16 calls bit-identical.  Inputs drawn on the card.
    gen = torch.Generator(device=dev).manual_seed(101)
    worst = 0.0
    for b, h, c, k, _ in VGG_WGRAD_SHAPES:
        x32 = torch.randn(b, h, h, c, device=dev, generator=gen)
        dy32 = torch.randn(b, h, h, k, device=dev, generator=gen)
        plan = conv_grad.tiling_plan(b, h, h, c, k)
        for dtype in (torch.bfloat16, torch.float32):
            x, dy = x32.to(dtype), dy32.to(dtype)
            got = conv_grad.conv3x3_filter_grad(x, dy)
            ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            worst = max(worst, err)
            again = conv_grad.conv3x3_filter_grad(x, dy)
            check(err <= WGRAD_TOL * scale and torch.equal(again.view(torch.int32), got.view(torch.int32)),
                  f"dW {str(dtype)[6:]:8s} B={b} {h}x{h} {c}->{k} ({plan.w_groups} column group"
                  f"{'s' if plan.w_groups > 1 else ''}): max |diff| {err:.3g} <= {WGRAD_TOL:g} * "
                  f"{scale:.4g}; a second call gives the same bits")
        del x32, dy32, x, dy
    print("    filter gradient per conv, bf16, queued behind a device sleep, inputs warm in the L2")
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    step_by = {"operations": 0, "bytes": 0}
    wide = []
    for b, h, c, k, count in VGG_WGRAD_SHAPES:
        x = torch.randn(b, h, h, c, device=dev, generator=gen).to(torch.bfloat16)
        dy = torch.randn(b, h, h, k, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.zeros(k, c, 3, 3, device=dev, dtype=torch.bfloat16)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        plan = conv_grad.tiling_plan(b, h, h, c, k)
        bound, by = wgrad_bound(b * h * h, c, k, torch.bfloat16)
        iters = int(np.clip(20.0 / max(4 * bound, 1e-3), 3, 50))  # windows of ~20 ms
        kern, kern_s = queued_ms(lambda _: conv_grad.conv3x3_filter_grad(x, dy), x, iters=iters, cold=False)
        lib, lib_s = queued_ms(lambda _: torch.ops.aten.convolution_backward(
            dyn, xn, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False]), x,
            iters=iters, cold=False)
        plain, _ = timed(lambda: conv_grad.conv3x3_filter_grad_reference(x, dy), 2, warmup_s=0.05)
        for key, v in (("ms", kern), ("plain_ms", plain), ("library_ms", lib), ("bound_ms", bound)):
            step[key] += count * v
        step_by[by] += count
        if plan.w_groups > 1 or c < 8:
            wide.append({"shape": [b, h, h, c, k], "w_groups": plan.w_groups, "ms": kern,
                         "library_ms": lib, "plain_ms": plain, "bound_ms": bound, "bound_by": by})
        tflops = 2 * 9 * b * h * h * c * k / (kern * 1e-3) / 1e12
        print(f"    dW bf16 B={b} {h:3d}x{h:<3d} {c:4d}->{k:<4d} x{count}: kernel {kern:.5f} ms {kern_s} = "
              f"{tflops:.1f} TFLOP/s, {100 * bound / kern:.1f}% of the bound {bound:.5f} ({by}); cuDNN "
              f"{lib:.5f} {lib_s}; kernel/cuDNN {kern / lib:.2f}; plain {plain:.4f}; box "
              f"{plan.w_box}x{plan.rows}x{plan.images} x{plan.w_groups} column groups, tile "
              f"{conv_grad.BLOCK_C}x{plan.n_tile}, {plan.splits} splits, c_pad {plan.c_pad}  [{card}]")
    print(f"    dW per ssd300_vgg_dct step ({VGG_DCT_B4} convs): kernel {step['ms']:.4f} ms, "
          f"{100 * step['bound_ms'] / step['ms']:.1f}% of the bound {step['bound_ms']:.4f} ms; cuDNN "
          f"{step['library_ms']:.4f} ms; plain {step['plain_ms']:.4f} ms  [{card}]")

    # 2. Forward of every new name at batch 2 in float32 (TF32 off),
    # BatchNorm calibrated on the batch, card against the port's CPU path.
    rng = np.random.default_rng(102)
    for name in FAMILY_NAMES:
        t0 = time.perf_counter()
        cpu_model, _ = build_model(name, device="cpu")
        built_s = time.perf_counter() - t0
        gpu_model = copy.deepcopy(cpu_model).to(dev)
        inputs = family_inputs(name, rng, 2)
        on_dev = to_dev(inputs, dev)
        calibrate_batch_norm(gpu_model, on_dev)
        cpu_model.load_state_dict(gpu_model.state_dict())
        with torch.no_grad():
            got = gpu_model(on_dev).cpu()
            ref = cpu_model(inputs)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        rows = f", {got.shape[1]} boxes" if name.startswith("ssd300") else ""
        check(bool(torch.isfinite(got).all()) and err <= 1e-3 * scale,
              f"{name}: card forward = CPU forward, max |diff| {err:.3g} <= 1e-3 * {scale:.4g}{rows} "
              f"(built in {built_s:.1f} s)")
        del cpu_model, gpu_model

    # 3. Forward + shared decode at batch 32 bf16; kernel and plain NMS
    # identical; the NMS launches read around the run.
    decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), candidate_selector="shared")
    kw = dict(n_classes=20, img_height=300, img_width=300, candidate_selector="shared")
    nms_launches = 0
    for name in ("ssd300_vgg_dct", "ssd300_vgg", "ssd300_y_cb4_cbcr_cb5"):
        model, _ = build_model(name, dtype=torch.bfloat16)
        inputs = to_dev(family_inputs(name, rng, 32), dev)
        calibrate_batch_norm(model, inputs)
        scale_ssd_head(model, inputs)
        batched_nms.LAUNCHES = 0
        with torch.no_grad():
            raw = model(inputs)
            det = decode(raw)
        torch.cuda.synchronize()
        nms_launches += batched_nms.LAUNCHES
        n_rows = {"vgg_dct": 8732, "vgg": 8732, "resnet_identical": 6716}[ssd_family(name)]
        ref = decode_detections(raw, nms_impl="reference", **kw)
        kept = det[det[..., 1] > 0]
        n_boxes = int((torch.isfinite(kept).all(-1) & (kept[:, 4] > kept[:, 2])
                       & (kept[:, 5] > kept[:, 3])).sum())
        check(raw.shape == (32, n_rows, 33) and bool(torch.isfinite(raw).all())
              and torch.equal(det, ref) and batched_nms.LAUNCHES == 1
              and n_boxes == len(kept) >= 32 * 10,
              f"{name} batch 32 bf16: {n_rows} boxes, {len(kept)} detections, all finite with "
              f"positive area (at least 10 an image); kernel and plain NMS detections identical; "
              "1 NMS launch")
        with torch.no_grad():
            e2e, e2e_s = timed(lambda: decode(model(inputs)), 5)
        print(f"    {name}: forward + shared decode, batch 32 bf16: {e2e:.4f} ms {e2e_s} = "
              f"{32e3 / e2e:.1f} images/s  [{card}]")
        del model

    # 4. One float32 step at batch 2, card (kernels, TF32 off) vs the CPU:
    # ssd300_vgg_dct and vgga (dropout masks from one host generator).
    sizes = ssd_predictor_sizes("vgg_dct")
    det_batch = train_batch(rng, *gt_batch(rng, [3, 6]), dev)
    cls_batch = {"inputs": torch.from_numpy(family_inputs("vgga", rng, 2)).to(dev),
                 "labels": np.asarray([3, 998], np.int32)}
    for name, cfg, batch, head in (
            ("ssd300_vgg_dct", ExperimentConfig(model="ssd300_vgg_dct", compute_dtype="float32",
                                                pallas_wgrad=True, batch_size=2), det_batch, "_mbox_"),
            ("vgga", ExperimentConfig(model="vgga", task="classification", compute_dtype="float32",
                                      pallas_wgrad=True, batch_size=2, l2_regularization=0.0,
                                      model_kwargs={"num_classes": 1000}), cls_batch, "predictions")):
        enc = (TargetEncoder(AnchorSpec(), sizes), TargetEncoder(AnchorSpec(), sizes, device="cpu"))
        detect = cfg.task == "detection"
        gpu, gpu_model, _ = build_trainer(cfg, target_encoder=enc[0] if detect else None)
        cpu, cpu_model, _ = build_trainer(cfg, target_encoder=enc[1] if detect else None, device="cpu")
        cpu_model.load_state_dict(gpu_model.state_dict())
        batch_cpu = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                         else v.cpu() if torch.is_tensor(v) else v) for k, v in batch.items()}
        conv_grad.LAUNCHES = 0
        m_gpu = gpu.train_step(batch, dropout_generator=torch.Generator().manual_seed(103))
        torch.cuda.synchronize()
        n_wgrad = conv_grad.LAUNCHES
        m_cpu = cpu.train_step(batch_cpu, dropout_generator=torch.Generator().manual_seed(103))
        a, b_ = float(m_gpu["loss"]), float(m_cpu["loss"])
        want = VGG_DCT_B4 if detect else 8
        check(abs(a - b_) <= 1e-4 * abs(b_) and n_wgrad == want,
              f"{name} float32 step: loss card {a:.6f} vs CPU {b_:.6f} (rtol 1e-4); {n_wgrad} filter "
              f"gradients on B4")
        worst_head = 0.0
        for k, p in gpu_model.named_parameters():
            if head in k and k.endswith("weight"):
                g = gpu.optimizer.state[p]["momentum_buffer"].cpu()
                r = cpu.optimizer.state[cpu_model.get_parameter(k)]["momentum_buffer"]
                worst_head = max(worst_head, float((g - r).abs().max() / r.abs().max()))
        check(worst_head <= 1e-3, f"{name}: {head.strip('_')} gradients within {worst_head:.3g} <= 1e-3 "
                                  "of max |ref|")
        del gpu, cpu, gpu_model, cpu_model

    # 5. train-detect --vgg and one identical archi from a NumPy-written
    # packed corpus, batch 32 bf16, all three training kernels.
    with tempfile.TemporaryDirectory() as tmp:
        voc, stem = write_detect_inputs(tmp)
        common = ["train-detect", "--voc-root", voc, "--device-augment", "--pack-cache", stem,
                  "--pallas-wgrad", "--batch-size", 32, "--steps-per-epoch", 3, "--epochs", 2]
        runs = []
        for label, extra, b4 in (
                ("--vgg", ["--vgg", "--output-dir", os.path.join(tmp, "vgg"), "--max-steps", 3],
                 VGG_DCT_B4),
                ("--vgg --restart", ["--vgg", "--output-dir", os.path.join(tmp, "vgg"), "--max-steps", 6,
                                     "--restart"], VGG_DCT_B4),
                ("--archi y_cb4_cbcr_cb5", ["--archi", "y_cb4_cbcr_cb5", "--output-dir",
                                            os.path.join(tmp, "ident"), "--max-steps", 3], IDENTICAL_B4)):
            bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
            t0 = time.perf_counter()
            run_dir, row = run_cli(common + extra)
            torch.cuda.synchronize()
            launches = {"match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES, "wgrad": conv_grad.LAUNCHES}
            runs.append((run_dir, row, launches))
            print(f"    train-detect {label}: {time.perf_counter() - t0:.2f} s in cli.main; row "
                  f"{json.dumps(row)}; kernel launches: matching {launches['match']}, flip "
                  f"{launches['flip']}, filter gradient {launches['wgrad']}")
            check(np.isfinite(row["total_loss"]) and row["step"] == (6 if "restart" in label else 3),
                  f"train-detect {label}: total_loss finite at step {row['step']}")
            check(launches == {"match": 3, "flip": 6, "wgrad": 3 * b4},
                  f"3 steps launched matching 1, flip 2 and filter gradient {b4} times a step")
        (run_dir, _, vgg_launches), (run_dir2, row2, _), _ = runs
        check(CheckpointManager(os.path.join(run_dir, "checkpoints")).all_steps() == [3, 6]
              and run_dir2 == run_dir and row2["epoch"] == 1,
              "--vgg: checkpoints at steps 3 and 6; --restart reused the run dir for epoch 1")
        warm_ms = row2["time_s"] * 1e3 / 3
        print(f"    train-detect --vgg warm steps (the restart's epoch; fit's time_s, 10 ms resolution): "
              f"{warm_ms:.1f} ms a step, {1e3 / warm_ms:.3f} steps/s, {32e3 / warm_ms:.1f} images/s  "
              f"[{card}]")

    # 6. The ssd300_vgg_dct bf16 step at batch 32 (bench.py's two GT boxes an
    # image), B4 against cuDNN's dW in rotating rounds, then a profiler window.
    batch = train_batch(rng, *bench_gt(32), dev)
    arms = {}
    for arm, on in (("B4", True), ("cuDNN dW", False)):
        cfg = ExperimentConfig(model="ssd300_vgg_dct", compute_dtype="bfloat16", pallas_wgrad=on,
                               batch_size=32)
        arms[arm], _, _ = build_trainer(cfg, target_encoder=TargetEncoder(AnchorSpec(), sizes))
    step_ms = {arm: [] for arm in arms}
    for rnd in range(4):
        for arm in (("B4", "cuDNN dW") if rnd % 2 == 0 else ("cuDNN dW", "B4")):
            step_ms[arm].append(timed(lambda: arms[arm].train_step(batch), 2, warmup_s=0.5))
    for arm in arms:
        ms = [m for m, _ in step_ms[arm]]
        print(f"    ssd300_vgg_dct train step, batch 32 bf16, {arm}: "
              + ", ".join(f"{m:.3f} ms {spread}" for m, spread in step_ms[arm])
              + f" -> {32e3 / np.mean(ms):.1f} images/s  [{card}]")
    diffs = [a - c for (a, _), (c, _) in zip(step_ms["B4"], step_ms["cuDNN dW"])]
    print("    B4 minus cuDNN dW per round: " + ", ".join(f"{d:+.3f}" for d in diffs) + " ms")
    profile_steps(lambda: arms["B4"].train_step(batch), card,
                  float(np.median([m for m, _ in step_ms["B4"]])),
                  label="ssd300_vgg_dct train steps (B4, matching kernel)")
    del arms
    return {"launches": vgg_launches, "nms_launches": nms_launches,
            "wgrad": {"launches": vgg_launches["wgrad"], "max_abs_err": worst, **step,
                      "bound_by": max(step_by, key=step_by.get),
                      "shapes": [list(t[:4]) for t in VGG_WGRAD_SHAPES if t[4]], "wide": wide}}


# Phase 9h: serving (ROADMAP A14a, A14b) on phase 6's calibrated ssd_custom.
SERVE_TOP_K = 200  # `export`'s default decode
FOLD_TOL = 1e-3  # folded vs unfolded f32 forward, times max |unfolded| (see run_serving)
ARTIFACT_TOL = 1e-5  # loaded artifact vs in-process folded path, times max |in-process|


def run_serving(dev, card, model_f32, model_bf16, raw_f32, request, planes):
    """Phase 9h: BatchNorm folding, the exported artifact and int8 on phase
    6's calibrated `ssd300_ssd_custom` (full width and depth), TF32 off.

    The folded forward is held to the unfolded one within FOLD_TOL of the
    largest output: this random calibrated model's float32 forward is itself
    ~1.2e-4 of its largest output away from a float64 forward (CPU
    measurement), and folding reassociates one multiply per BatchNorm, so
    1e-4 is inside its rounding noise.  The artifact replays the in-process
    folded path's operations (ARTIFACT_TOL)."""
    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.boxes.decode import select_candidates
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms
    from jpeg_detection_resnet_ssd_torch.serve import (
        build_serving_fn, export_serving_artifact, fold_batch_norm, load_serving_artifact,
        quantize_for_serving,
    )
    from jpeg_detection_resnet_ssd_torch.serve.quantize import QuantizedConv
    from jpeg_detection_resnet_ssd_torch.cli import main as cli
    from jpeg_detection_resnet_ssd_torch.eval import DetectionEvaluator
    from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig, build_trainer
    from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir

    y32, c32 = planes
    print("[9h] serving: BatchNorm folding, the torch.export artifact (B1 inside), int8")
    t_phase = time.perf_counter()
    shared = make_inference_fn(n_classes=20, spec=AnchorSpec(), candidate_selector="shared")
    folded = {"f32": fold_batch_norm(model_f32), "bf16": fold_batch_norm(model_bf16)}
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model_f32.modules())
    check(not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded["f32"].modules()),
          f"the folded copy holds none of the model's {n_bn} BatchNorms")

    # 1. Folding: outputs, launches, forward + shared decode in rotating rounds.
    x2 = (y32[:2], c32[:2])
    with torch.no_grad():
        a, b = model_f32(x2), folded["f32"](x2)
    err = float((a - b).abs().max()) / float(a.abs().max())
    check(bool(torch.isfinite(b).all()) and err <= FOLD_TOL,
          f"folded vs unfolded f32 forward at batch 2: max |diff| {err:.3g} of the largest output "
          f"(tolerance {FOLD_TOL:g})")
    arms = {
        "bf16 batch 32": ((y32, c32), model_bf16, folded["bf16"]),
        "f32 batch 1": (request, model_f32, folded["f32"]),
    }
    with torch.no_grad():
        for label, (x, plain, fold) in arms.items():
            (l0, d0), (l1, d1) = forward_launches(lambda: plain(x)), forward_launches(lambda: fold(x))
            print(f"    forward launches (profiler), {label}: unfolded {l0:.0f}, folded {l1:.0f} "
                  f"({l1 - l0:+.0f}); kernels' device time {d0:.4f} -> {d1:.4f} ms  [{card}]")
        for label, (x, plain, fold) in arms.items():
            times = rounds({"unfolded": lambda: shared(plain(x)), "folded": lambda: shared(fold(x))},
                           lambda fn: timed(fn, 10), 3)
            print(f"    forward + shared decode, {label}, 3 rotating rounds (CUDA events, median of 5 "
                  f"windows each): unfolded {times['unfolded']}, folded {times['folded']} ms  [{card}]")

    # 2. The artifact through the command line: a run dir holding phase 6's
    # calibrated weights, `export --symbolic-batch --candidate-selector
    # shared` on the card (the folded f32 forward + the shared decode), then
    # the loaders of `serve` and of `evaluate/infer --exported`.
    work = tempfile.mkdtemp(prefix="serve_")
    config = ExperimentConfig(compute_dtype="float32", output_dir=os.path.join(work, "exp"))
    run_dir = create_run_dir(config)
    trainer, module, _ = build_trainer(config, device=dev)
    module.load_state_dict(model_f32.state_dict())
    CheckpointManager(os.path.join(run_dir, "checkpoints")).save(0, trainer)
    del trainer, module
    out_dir = os.path.join(work, "artifact")
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli.main(["export", "--run-dir", run_dir, "--output", out_dir, "--symbolic-batch",
                  "--batch-size", "2", "--candidate-selector", "shared"])
    export_s = time.perf_counter() - t0
    printed = json.loads(printed.getvalue().strip().splitlines()[-1])
    fn, manifest = load_serving_artifact(out_dir)
    print(f"    cli export --run-dir (build, restore, fold, torch.export, save): {export_s:.2f} s, "
          f"{manifest['bytes']} bytes, device {manifest['device']}, inputs {manifest['inputs']}")
    check(sorted(os.listdir(out_dir)) == ["manifest.json", "model.pt2"]
          and printed["bytes"] == manifest["bytes"] and manifest["device"].startswith("cuda")
          and manifest["symbolic_batch"] and manifest["decode"]["candidate_selector"] == "shared",
          "export wrote model.pt2 and manifest.json: a symbolic-batch CUDA program")
    serving = build_serving_fn(model_f32, decode_fn=make_inference_fn(
        n_classes=20, spec=AnchorSpec(), candidate_selector="shared", top_k=SERVE_TOP_K))
    batches = ((y32[:1], c32[:1]), (y32[:8], c32[:8]), (y32, c32))
    batched_nms.LAUNCHES = 0  # the main path of this phase: the loaded artifact at 3 batches
    got = [fn(*x) for x in batches]
    torch.cuda.synchronize()
    serve_launches = batched_nms.LAUNCHES
    check(serve_launches == len(batches), f"B1 launched inside the artifact: {serve_launches} "
          f"launches for {len(batches)} calls")
    kw = dict(n_classes=20, candidate_selector="shared", top_k=SERVE_TOP_K, device=dev)
    plain_nms = make_inference_fn(spec=AnchorSpec(), nms_impl="reference", **kw)
    mask_err = 0
    for x, det in zip(batches, got):
        n = x[0].shape[0]
        with torch.no_grad():
            want = serving(*x)
            raw = serving.model(x)
        diff = float((det - want).abs().max())
        check(det.shape == (n, SERVE_TOP_K, 6) and torch.equal(det[..., 0], want[..., 0])
              and diff <= ARTIFACT_TOL * float(want.abs().max()),
              f"artifact = in-process folded path at batch {n}: classes equal, max |diff| {diff:.3g}")
        ref = plain_nms(raw)
        check(torch.equal(det[..., 0], ref[..., 0])
              and float((det - ref).abs().max()) <= ARTIFACT_TOL * float(ref.abs().max()),
              f"artifact at batch {n} = the plain NMS's decode of the in-process raw predictions")
        scores, boxes = select_candidates(raw, n_classes=20, candidate_selector="shared")
        nb, ns = boxes.reshape(n * 20, -1, 4), scores.reshape(n * 20, -1)
        keep = batched_nms.batched_nms_mask(nb, ns)
        mask_err += int((keep != batched_nms.batched_nms_mask_reference(nb, ns)).sum())
    check(mask_err == 0, "kernel mask = plain mask on the artifact's candidates at batches 1, 8, 32")
    # `evaluate --exported`'s inference function (the JPEG half of the
    # command needs libjpeg, which the card's machine lacks) in the evaluator on
    # phase 9d's kind of batches, against the in-process serving module.
    infer_exported, _ = cli._exported_infer(out_dir)
    ev_batches = eval_batches(np.random.default_rng(6), infer_exported)
    batched_nms.LAUNCHES = 0
    ev_art = DetectionEvaluator(infer_exported, ev_batches, n_classes=20)
    map_art, _, _ = ev_art()
    torch.cuda.synchronize()
    eval_launches = batched_nms.LAUNCHES

    def infer_in_process(inputs):
        with torch.no_grad():
            return serving(*inputs)

    ev_in = DetectionEvaluator(infer_in_process, ev_batches, n_classes=20)
    map_in, _, _ = ev_in()
    n_preds = sum(map(len, ev_art.prediction_results))
    check(ev_art.prediction_results == ev_in.prediction_results and map_art == map_in
          and n_preds > 0 and eval_launches == len(ev_batches),
          f"evaluate --exported's inference: the in-process lists ({n_preds} predictions) and "
          f"mAP ({map_art!r}); {eval_launches} B1 launches for {len(ev_batches)} batches")
    with torch.no_grad():
        t32 = rounds({"artifact": lambda: fn(y32, c32), "in-process": lambda: serving(y32, c32)},
                     lambda f: timed(f, 10), 2)
        t1 = rounds({"artifact": lambda: fn(*request), "in-process": lambda: serving(*request)},
                    lambda f: request_ms(f), 2)
    print(f"    folded f32 forward + shared decode, batch 32, 2 rotating rounds (CUDA events): "
          f"artifact {t32['artifact']}, in-process {t32['in-process']} ms  [{card}]")
    print(f"    batch-1 latency, folded f32 forward + shared decode (host clock to synchronize, "
          f"mean of 20 a window, median of 5), 2 rounds: artifact {t1['artifact']}, "
          f"in-process {t1['in-process']} ms  [{card}]")

    # 3. int8: calibrate on 4 seeded batches, the accumulators card vs CPU, the
    # raw output against float, the artifact's size, the forward's time.
    rng = np.random.default_rng(9)
    calib = [(torch.from_numpy(rng.normal(0, 100, (8, 38, 38, 64)).astype(np.float32)).to(dev),
              torch.from_numpy(rng.normal(0, 30, (8, 19, 19, 128)).astype(np.float32)).to(dev))
             for _ in range(4)]
    qmodel, info = quantize_for_serving(model_f32, calib)
    print(f"    int8: {len(info['quantized'])} convs quantized, kept float {info['kept_float']}, "
          f"{info['n_calibration_batches']} calibration batches of 8")
    inputs, seen = {}, set()

    def record(path):
        def hook(mod, args):
            inputs[path] = args[0].detach()
        return hook

    qconvs = {p: m for p, m in qmodel.named_modules() if isinstance(m, QuantizedConv)}
    hooks = [m.register_forward_pre_hook(record(p)) for p, m in qconvs.items()]
    with torch.no_grad():
        qmodel(request)
    for h in hooks:
        h.remove()
    n_shapes = 0
    for path, mod in qconvs.items():
        x = inputs[path]
        key = (tuple(x.shape), mod.kernel, mod.stride, tuple(mod.weight_q.shape))
        if key in seen:
            continue
        seen.add(key)
        n_shapes += 1
        acc = mod.accumulate(x)
        ref = copy.deepcopy(mod).cpu().accumulate(x.cpu())
        check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), ref),
              f"int8 accumulators card = CPU exactly: {path} ({mod.kernel}x{mod.kernel}/"
              f"{mod.stride}, map {x.shape[1]}x{x.shape[2]}, {x.shape[3]}->{mod.features})")
    with torch.no_grad():
        q_raw = qmodel(x2)
    for block, cols in (("conf", slice(0, 21)), ("loc", slice(21, 25))):
        rel = float(((q_raw[..., cols] - b[..., cols]) ** 2).mean().sqrt()
                    / (b[..., cols] ** 2).mean().sqrt())
        print(f"    int8 vs folded f32 raw output at batch 2, {block}: relative RMS {rel:.4g}")
    check(bool(torch.isfinite(q_raw).all()), "int8 raw output finite")
    q_dir = tempfile.mkdtemp(prefix="serve_int8_")
    q_serving = build_serving_fn(qmodel, decode_fn=serving.decode_fn, fold_bn=False)
    q_manifest = export_serving_artifact(q_serving, (y32[:2], c32[:2]), q_dir, symbolic_batch=True)
    q_fn, _ = load_serving_artifact(q_dir)
    with torch.no_grad():
        q_det, q_want = q_fn(y32, c32), q_serving(y32, c32)
    check(torch.equal(q_det[..., 0], q_want[..., 0])
          and float((q_det - q_want).abs().max()) <= ARTIFACT_TOL * float(q_want.abs().max()),
          "int8 artifact = in-process int8 path at batch 32")
    print(f"    artifact bytes: float {manifest['bytes']}, int8 {q_manifest['bytes']} "
          f"({q_manifest['bytes'] / manifest['bytes']:.3f} of float)")
    with torch.no_grad():
        tq = rounds({"int8": lambda: qmodel((y32, c32)), "bf16": lambda: folded["bf16"]((y32, c32)),
                     "f32": lambda: folded["f32"]((y32, c32))}, lambda f: timed(f, 10), 3)
    print(f"    folded forward at batch 32, 3 rotating rounds (CUDA events): int8 {tq['int8']}, "
          f"bf16 {tq['bf16']}, f32 {tq['f32']} ms  [{card}]")
    ql, qd = forward_launches(lambda: qmodel((y32, c32)))
    print(f"    int8 forward launches (profiler): {ql:.0f}, kernels' device time {qd:.4f} ms  [{card}]")
    for d in (work, q_dir):
        shutil.rmtree(d)
    print(f"    phase 9h took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": serve_launches, "evaluate_launches": eval_launches}


DP_BATCH, DP_STEPS, DP_TIMEOUT_S = 32, 2, 300  # phase 9i's data-parallel step
DP_LOSS_TOL, DP_PARAM_TOL = 1e-4, 1e-3
# The first step's loss, before any update: the same weights, so a gap of
# float32 rounding alone (the kernels' against the plain version's sums).
DP_FIRST_LOSS_TOL = 1e-6


def dp_batches():
    """Phase 9i's global batches: 44-block (352-px) source planes as NumPy
    arrays (Y ~ N(0, 100), CbCr ~ N(0, 30)) and `bench.py`'s two GT boxes."""
    rng = np.random.default_rng(21)
    out = []
    for _ in range(DP_STEPS):
        gt, mask = bench_gt(DP_BATCH)
        out.append({"inputs": (rng.normal(0, 100, (DP_BATCH, 44, 44, 64)).astype(np.float32),
                               rng.normal(0, 30, (DP_BATCH, 22, 22, 128)).astype(np.float32)),
                    "gt": gt, "gt_mask": mask})
    return out


@contextlib.contextmanager
def plain_batch_norm():
    """Inside the block, train-mode BatchNorm in this process runs on its
    plain version."""
    from jpeg_detection_resnet_ssd_torch.models import layers

    kernels = layers.batch_norm_train
    layers.batch_norm_train = functools.partial(kernels, impl="reference")
    try:
        yield
    finally:
        layers.batch_norm_train = kernels


def dp_train(n_model=1, min_features=1024, steps=DP_STEPS, record_wgrad=False):
    """Phase 9i's data-parallel step and phase 9j's tensor-parallel one:
    `ssd300_ssd_custom` in float32 (TF32 off) with the matching kernel,
    `pallas_wgrad` and the v3 augment, `steps` steps on this rank's rows of
    `dp_batches()`, on `make_mesh(n_model=n_model)` with the kernels of at
    least `min_features` outputs sharded over the model axis; without a
    process group, one process on the global batch.  Returns the per-step
    losses, the final state (whole: the sharded kernels gathered), the
    kernel launches, the model-axis collectives and the seconds of the
    steps, this rank's parameter and momentum bytes and peak memory, and
    the trainer; with `record_wgrad`, each filter gradient of the steps
    against its plain version."""
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import (
        batch_norm, conv_grad, dct_flip, make_dct_detection_augment_v3,
    )
    from jpeg_detection_resnet_ssd_torch.parallel import mesh as pmesh
    from jpeg_detection_resnet_ssd_torch.parallel import make_mesh, shard_batch, tensor_parallel_rule
    from jpeg_detection_resnet_ssd_torch.train import (
        ExperimentConfig,
        build_trainer,
        checkpoint_state,
    )

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(n_model=n_model)
    config = ExperimentConfig(model="ssd300_ssd_custom", compute_dtype="float32", pallas_wgrad=True,
                              batch_size=DP_BATCH, n_model_shards=n_model)
    encoder = TargetEncoder(AnchorSpec(img_height=304, img_width=304),
                            ssd_predictor_sizes("resnet_custom"))
    trainer, module, _ = build_trainer(
        config, target_encoder=encoder, augment_fn=make_dct_detection_augment_v3(38), mesh=mesh,
        tp_rule=functools.partial(tensor_parallel_rule, min_features=min_features))
    batches = [shard_batch(b, mesh) for b in dp_batches()[:steps]]
    kernel, recorded = conv_grad.conv3x3_filter_grad, []

    def record(x, dy):
        dw = kernel(x, dy)
        recorded.append((x.clone(), dy.clone(), dw.clone()))
        return dw

    if record_wgrad:
        conv_grad.conv3x3_filter_grad = record
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = pmesh.MODEL_COLLECTIVES = 0
    batch_norm.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        metrics = trainer.train_steps(batches, config.seed + 1)
        torch.cuda.synchronize()
    finally:
        conv_grad.conv3x3_filter_grad = kernel
    seconds = time.perf_counter() - t0
    out = {"loss": metrics["total_loss"].cpu(), "seconds": seconds,
           "launches": {"match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES,
                        "wgrad": conv_grad.LAUNCHES, "bn": batch_norm.LAUNCHES},
           "model_collectives": pmesh.MODEL_COLLECTIVES,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "param_bytes": sum(p.numel() * p.element_size() for p in module.parameters()),
           "momentum_bytes": sum(s["momentum_buffer"].numel() * s["momentum_buffer"].element_size()
                                 for s in trainer.optimizer.state.values()),
           "n_params": sum(p.numel() for p in module.parameters())}
    if record_wgrad:
        shares = []
        for x, dy, got in recorded:
            ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            shares.append((tuple(x.shape[1:]), dy.shape[-1],
                           err / scale if scale else (0.0 if err == 0.0 else float("inf"))))
        out["wgrad_shares"] = shares
        del recorded
    out["state"] = {k: v.detach().cpu().clone()
                    for k, v in checkpoint_state(trainer)["model"].items()}
    return {**out, "trainer": trainer, "batches": batches}


def dp_worker(argv) -> int:
    """`chip_smoke.py --dp-worker RANK WORLD STORE OUT [N_MODEL MIN_FEATURES
    STEPS RECORD]`: one gloo rank of phase 9i's step (or 9j's, on a mesh of
    N_MODEL model ranks) on the card (NCCL refuses two ranks on one
    device)."""
    import datetime

    from jpeg_detection_resnet_ssd_torch.utils import maybe_initialize_distributed

    rank, world, store, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    n_model, min_features, steps, record = (int(a) for a in argv[4:8] or (1, 1024, DP_STEPS, 0))
    maybe_initialize_distributed(init_method=f"file://{store}", world_size=world, rank=rank,
                                 backend="gloo", timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        result = dp_train(n_model, min_features, steps, bool(record))
        result.pop("trainer"), result.pop("batches")
        torch.save(result, f"{out}.{rank}")
    finally:
        torch.distributed.destroy_process_group()
    return 0


def cli_worker(argv) -> int:
    """`chip_smoke.py --cli-worker ARGS`: `cli.main(ARGS)` in this process,
    then the kernel launches it made as a JSON line."""
    from jpeg_detection_resnet_ssd_torch.cli import main as cli
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad, dct_flip

    bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
    cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    print(json.dumps({"launches": {"match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES,
                                   "wgrad": conv_grad.LAUNCHES}}))
    return 0


def self_command(*args) -> list[str]:
    return [sys.executable, os.path.abspath(__file__), *map(str, args)]


def run_data_parallel(card) -> dict:
    """Phase 9i: `bench`, the 2-rank gloo step against one process, the
    NCCL world-of-1 `train-detect` and its restart, and `profile_trace`.
    Returns each rank's launches of the 2-rank step and the one-process
    reference's losses and state (phase 9j's 1x2 arm takes the same
    steps)."""
    import socket

    from jpeg_detection_resnet_ssd_torch.cli import main as cli
    from jpeg_detection_resnet_ssd_torch.utils import StepTimer, profile_trace

    t_phase = time.perf_counter()
    print(f"[9i] bench, data parallelism and profiling on {card}")
    # 1. bench, full width and depth, float32 (TF32 off since phase 4).
    for model, batch in (("ssd300_ssd_custom", 32), (CLS_MODEL, 64)):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["bench", "--model", model, "--batch-size", str(batch), "--runs", "10"])
        row = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"    bench {json.dumps(row)} (eval forward, f32, TF32 off, best of 3 CUDA-event "
              f"windows of 10 calls)  [{card}]")
        check(row["images_per_sec"] > 0 and row["device"] == torch.cuda.get_device_name(0),
              f"bench {model} timed on the card")
        if model == "ssd300_ssd_custom":
            check(row["params"] == 51_984_110, "bench counts 51,984,110 detector parameters")

    # B4's bf16 tiling plans at a rank's rows (16 of the global 32).
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad

    gen = torch.Generator().manual_seed(22)
    for h, c, k, _ in WGRAD_SHAPES:
        x = torch.randn(DP_BATCH // 2, h, h, c, generator=gen).to("cuda", torch.bfloat16)
        dy = torch.randn(DP_BATCH // 2, h, h, k, generator=gen).to("cuda", torch.bfloat16)
        got = conv_grad.conv3x3_filter_grad(x, dy)
        ref = conv_grad.conv3x3_filter_grad_reference(x, dy)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        check(err <= WGRAD_TOL * scale, f"dW bfloat16 B={DP_BATCH // 2} {h}x{h} {c}->{k} "
                                        f"(a rank's rows): max |diff| {err:.3g}")
    del x, dy, got, ref

    # 2. Two gloo ranks on the card against one process on the global batch.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "dp")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(self_command("--dp-worker", r, 2, store, out),
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=DP_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0, f"data-parallel rank {r} exited 0:\n{log[-4000:]}")
        ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
        print(f"    2 gloo ranks: {time.perf_counter() - t0:.1f} s with start-up; their "
              f"{DP_STEPS} steps {ranks[0]['seconds']:.2f} / {ranks[1]['seconds']:.2f} s "
              f"(host clock, gloo stages every collective through host memory)  [{card}]")
    torch.cuda.empty_cache()
    # The ranks and one process run train-mode BatchNorm on its kernels (the
    # ranks all-reduce each direction's totals); the plain version's one
    # process is the witness that the kernels' own gap is float32 rounding:
    # its first loss (the same weights) within DP_FIRST_LOSS_TOL, its
    # parameters within DP_PARAM_TOL; after an update the gap grows as the
    # ranks' reordered sums make it grow (printed side by side).
    ref = dp_train()
    with plain_batch_norm():
        plain = dp_train()
    plain.pop("trainer"), plain.pop("batches")
    one_process = {k: ref[k] for k in ("loss", "state", "peak_bytes", "param_bytes",
                                       "momentum_bytes")}
    keys = [k for k, v in ref["state"].items() if v.is_floating_point()]
    largest = max(float(ref["state"][k].abs().max()) for k in keys)

    def gaps(res):
        per_step = (res["loss"] - ref["loss"]).abs() / ref["loss"].abs()
        p_err = max(float((res["state"][k] - ref["state"][k]).abs().max()) for k in keys)
        return [float(v) for v in per_step], p_err

    print(f"    one process, global batch {DP_BATCH}, BatchNorm on its kernels: {DP_STEPS} steps "
          f"{ref['seconds']:.2f} s; losses {[round(float(v), 6) for v in ref['loss']]}; launches "
          f"{ref['launches']}")
    plain_steps, plain_p = gaps(plain)
    print(f"    the same on the plain version: losses {[round(float(v), 6) for v in plain['loss']]}, "
          f"relative diff by step {[f'{v:.3g}' for v in plain_steps]}; parameters max |diff| "
          f"{plain_p:.3g} of max |p| {largest:.4g}")
    check(plain_steps[0] <= DP_FIRST_LOSS_TOL and plain_p <= DP_PARAM_TOL * largest,
          f"the plain version's first loss within {DP_FIRST_LOSS_TOL:g} of the kernels' and its "
          f"parameters within {DP_PARAM_TOL:g} of the largest")
    for r, res in enumerate(ranks):
        rank_steps, p_err = gaps(res)
        loss_err = max(rank_steps)
        print(f"    rank {r}: losses {[round(float(v), 6) for v in res['loss']]}, relative diff by "
              f"step {[f'{v:.3g}' for v in rank_steps]}; parameters max |diff| {p_err:.3g} of max "
              f"|p| {largest:.4g}; launches {res['launches']}")
        check(loss_err <= DP_LOSS_TOL, f"rank {r}'s losses within {DP_LOSS_TOL:g} of one process's")
        check(p_err <= DP_PARAM_TOL * largest,
              f"rank {r}'s parameters within {DP_PARAM_TOL:g} of the largest")
        check(res["launches"] == {"match": DP_STEPS, "flip": 2 * DP_STEPS, "wgrad": 24 * DP_STEPS,
                                  "bn": BN_MESH_LAUNCHES_PER_STEP * DP_STEPS},
              f"rank {r} launched B2 1, B3 2, B4 24 and the BatchNorm kernels "
              f"{BN_MESH_LAUNCHES_PER_STEP} times a step")
    check(all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ref["state"]),
          "the two ranks' parameters and statistics are bit-identical")
    del plain

    # 4. profile_trace around 2 steps of the reference's trainer.
    with tempfile.TemporaryDirectory() as tmp:
        trainer, timer = ref["trainer"], StepTimer(skip=0)
        gen = torch.Generator().manual_seed(5)
        with profile_trace(tmp):
            timer.tick()
            for batch in ref["batches"]:
                trainer.train_step(batch, gen)
                torch.cuda.synchronize()
                timer.tick()
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        print(f"    profile_trace: {len(events)} events, {len(kernels)} distinct kernels, "
              f"StepTimer {timer.steps_per_sec():.3f} steps/s (f32, profiler on)  [{card}]")
        check(any("wgrad_f32_kernel" in k for k in kernels)
              and any("bipartite_match_kernel" in k for k in kernels)
              and any("dct_flip_h_kernel" in k for k in kernels)
              and any("bn_reduce_kernel" in k for k in kernels),
              "the trace holds B4's, B2's, B3's and the BatchNorm kernels")
    del ref
    torch.cuda.empty_cache()

    # 3. train-detect under torchrun's environment, a world of 1 on NCCL.
    with tempfile.TemporaryDirectory() as tmp:
        voc, stem = write_detect_inputs(tmp)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        argv = ["train-detect", "--voc-root", voc, "--device-augment", "--pack-cache", stem,
                "--pallas-wgrad", "--batch-size", 32, "--steps-per-epoch", 3, "--epochs", 3,
                "--output-dir", os.path.join(tmp, "exp")]
        rows = []
        # Each run is a new process, so its first epoch is cold (cuDNN's
        # algorithm choice, the allocator); the restart's second epoch is warm.
        for steps, extra in ((3, ["--max-steps", 3]), (6, ["--restart"])):
            proc = subprocess.run(self_command("--cli-worker", *argv, *extra), env=env,
                                  capture_output=True, text=True, timeout=DP_TIMEOUT_S)
            check(proc.returncode == 0, f"train-detect on NCCL {' '.join(map(str, extra))} "
                                        f"exited 0:\n{proc.stderr[-4000:]}")
            lines = proc.stdout.strip().splitlines()
            row, launches = json.loads(lines[-2]), json.loads(lines[-1])["launches"]
            rows.append(row)
            print(f"    train-detect, NCCL world of 1, {' '.join(map(str, extra))}: row "
                  f"{json.dumps(row)}; launches {launches}")
            check(np.isfinite(row["total_loss"]) and row["step"] == 3 * (2 * len(rows) - 1),
                  f"NCCL run {len(rows)}: finite loss at step {row['step']}")
            check(launches == {"match": steps, "flip": 2 * steps, "wgrad": 24 * steps},
                  "B2 1, B3 2, B4 24 launches a step under NCCL")
        check(rows[1]["epoch"] == 2, "--restart resumed at epoch 1 and ran epochs 1 and 2")
        warm_ms = rows[1]["time_s"] * 1e3 / 3
        print(f"    warm steps under NCCL (the restart's second epoch, 3 steps; fit's time_s, "
              f"10 ms resolution; the first run's cold epoch {rows[0]['time_s'] * 1e3 / 3:.1f} ms "
              f"a step): "
              f"{warm_ms:.1f} ms a step, {1e3 / warm_ms:.3f} steps/s (phase 9e's number, without "
              f"a process group, is above)  [{card}]")
    print(f"    phase 9i: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": [r["launches"] for r in ranks], "one_process": one_process}


# Phase 9j: tensor parallelism (ROADMAP A13b), gloo ranks on the one card.
TP_TIMEOUT_S = 300  # a worker of 9j that has not finished by then fails the run
TP_SHARDED_PARAMS = 27_262_976  # ssd300_ssd_custom's 13 leaves of >= 1024 outputs
TP_FORWARD_TOL = 1e-3  # one process's forward vs the sharded ranks', times max |one process|


def run_gloo_ranks(world: int, worker_args, tmp: str) -> tuple[list, float]:
    """`world` processes of this script with `--dp-worker` on the card, one
    gloo group through a file store under `tmp` (a fresh directory: a used
    store hangs a second group); each may take TP_TIMEOUT_S in all, the
    first late or failed one fails the run and every one still alive is
    killed.  Returns their results and the seconds with start-up."""
    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "tp")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(self_command("--dp-worker", r, world, store, out, *worker_args),
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                check(False, f"rank {r} of {world} finished within {TP_TIMEOUT_S} s")
            if p.returncode != 0:
                logs[r].seek(0)
                check(False, f"rank {r} of {world} exited {p.returncode}:\n"
                             f"{logs[r].read()[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    seconds = time.perf_counter() - t0
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)], seconds


def hold_to_one_process(arm: str, ranks: list, ref: dict, steps: int, card: str,
                        n_data: int = 1) -> None:
    """Phase 9j's checks of one arm: each rank's losses within DP_LOSS_TOL
    (relative) and whole parameters within DP_PARAM_TOL of the largest of
    one process's, the ranks' whole states bit-identical, B2 1, B3 2 and
    B4 24 launches a step on every rank and the BatchNorm kernels' (4 a
    direction on a mesh of `n_data` > 1 data ranks); prints each rank's launches,
    model-axis collectives a step, parameter and momentum bytes and peak
    memory."""
    keys = [k for k, v in ref["state"].items() if v.is_floating_point()]
    largest = max(float(ref["state"][k].abs().max()) for k in keys)
    for r, res in enumerate(ranks):
        want = ref["loss"][:steps]
        loss_err = float(((res["loss"] - want).abs() / want.abs()).max())
        p_err = max(float((res["state"][k] - ref["state"][k]).abs().max()) for k in keys)
        print(f"    {arm} rank {r}: losses {[round(float(v), 6) for v in res['loss']]}, relative "
              f"diff {loss_err:.3g}; parameters max |diff| {p_err:.3g} of max |p| {largest:.4g}; "
              f"launches {res['launches']}; {res['model_collectives'] / steps:g} model-axis "
              f"collectives a step; {res['n_params']:,} parameters, {res['param_bytes']:,} B of "
              f"parameters + {res['momentum_bytes']:,} B of momentum; peak "
              f"{res['peak_bytes'] / 2**20:.1f} MiB; {steps} steps {res['seconds']:.2f} s  "
              f"[{card}]")
        check(loss_err <= DP_LOSS_TOL, f"{arm} rank {r}'s losses within {DP_LOSS_TOL:g} of one "
                                       f"process's")
        check(p_err <= DP_PARAM_TOL * largest,
              f"{arm} rank {r}'s whole parameters within {DP_PARAM_TOL:g} of the largest")
        bn = (BN_MESH_LAUNCHES_PER_STEP if n_data > 1 else BN_LAUNCHES_PER_STEP) * steps
        check(res["launches"] == {"match": steps, "flip": 2 * steps, "wgrad": 24 * steps, "bn": bn},
              f"{arm} rank {r} launched B2 1, B3 2, B4 24 and the BatchNorm kernels "
              f"{bn // steps} times a step")
    check(all(torch.equal(ranks[0]["state"][k], res["state"][k])
              for res in ranks[1:] for k in ref["state"]),
          f"{arm}: the ranks' parameters (replicated, and sharded once gathered) and statistics "
          f"are bit-identical")


def tp_probe(dev):
    """Phase 9j's probe batch: 4 seeded 38-block planes on `dev`."""
    rng = np.random.default_rng(23)
    return (torch.from_numpy(rng.normal(0, 100, (4, 38, 38, 64)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.normal(0, 30, (4, 19, 19, 128)).astype(np.float32)).to(dev))


def probe_forward(model, inputs) -> torch.Tensor:
    """The train-mode forward (batch statistics, which keep a random model's
    box offsets finite) with the running statistics left as they are."""
    from jpeg_detection_resnet_ssd_torch.models import layers

    model.train()
    with torch.no_grad(), layers.running_stats_frozen():
        return model(inputs)


def tp_cli_worker(argv) -> int:
    """`chip_smoke.py --tp-cli-worker OUT ARGS`: one gloo rank (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT from the environment) of
    `cli.main(ARGS)` on the card, TF32 off; then rank 0 saves the trained
    model's whole parameters (gathered over the model group) and its
    `probe_forward` of `tp_probe` to OUT, and every rank prints the kernel
    launches of the command as a JSON line."""
    import datetime

    from jpeg_detection_resnet_ssd_torch.cli import main as cli
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm
    from jpeg_detection_resnet_ssd_torch.ops import conv_grad, dct_flip
    from jpeg_detection_resnet_ssd_torch.train import checkpoint_state, loop
    from jpeg_detection_resnet_ssd_torch.utils import maybe_initialize_distributed, process_index

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    maybe_initialize_distributed(backend="gloo", timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    trainers, fit = [], loop.fit

    def keep_trainer(*args, **kwargs):
        trainer, history = fit(*args, **kwargs)
        trainers.append(trainer)
        return trainer, history

    bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0
    loop.fit = keep_trainer
    try:
        cli.main(argv[1:])
        torch.cuda.synchronize()
        launches = {"match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES, "wgrad": conv_grad.LAUNCHES}
        state = checkpoint_state(trainers[0])["model"]
        out = probe_forward(trainers[0].model, tp_probe("cuda"))
        if process_index() == 0:
            torch.save({"state": {k: v.cpu() for k, v in state.items()}, "out": out.cpu()},
                       argv[0])
        print(json.dumps({"launches": launches}))
    finally:
        loop.fit = fit
        torch.distributed.destroy_process_group()
    return 0


def run_tp_cli(card: str) -> dict:
    """Phase 9j's CLI arm: `train-detect --n-model-shards 2` on 2 gloo ranks
    (f32, TF32 off), 3 steps on phase 9e's corpus and `--restart` for 3
    more; then the last checkpoint restored in this process (the CLI's
    `evaluate`/`export` path): its parameters equal the ranks' gathered
    ones, its forward the ranks' sharded forward within TP_FORWARD_TOL, and
    its shared decode runs B1 once.  Returns the launches."""
    import socket

    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec
    from jpeg_detection_resnet_ssd_torch.cli import main as cli
    from jpeg_detection_resnet_ssd_torch.models import make_inference_fn
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms
    from jpeg_detection_resnet_ssd_torch.parallel import model_shards
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        voc, stem = write_detect_inputs(tmp)
        cfg = os.path.join(tmp, "f32.json")
        with open(cfg, "w") as f:
            f.write(ExperimentConfig(compute_dtype="float32", batch_size=DP_BATCH,
                                     model_kwargs={"n_classes": 20}).to_json())
        argv = ["train-detect", "--voc-root", voc, "--device-augment", "--pack-cache", stem,
                "--pallas-wgrad", "--config", cfg, "--steps-per-epoch", 3, "--n-model-shards", 2,
                "--output-dir", os.path.join(tmp, "exp")]
        saved = os.path.join(tmp, "ranks.pt")
        for extra in (["--epochs", 1], ["--epochs", 2, "--restart"]):
            with socket.socket() as sock:
                sock.bind(("localhost", 0))
                port = sock.getsockname()[1]
            t0 = time.perf_counter()
            # Files, not pipes: a rank blocked on a full pipe would stall the other's collectives.
            outs = [open(os.path.join(tmp, f"cli{r}.{e}"), "w+") for r in range(2) for e in "oe"]
            procs = [subprocess.Popen(
                self_command("--tp-cli-worker", saved, *argv, *extra),
                env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="localhost",
                         MASTER_PORT=str(port)),
                stdout=outs[2 * r], stderr=outs[2 * r + 1], text=True) for r in range(2)]
            deadline = time.monotonic() + TP_TIMEOUT_S
            what = f"train-detect --n-model-shards 2 {' '.join(map(str, extra))}"
            try:
                for r, p in enumerate(procs):
                    try:
                        p.wait(timeout=max(deadline - time.monotonic(), 1.0))
                    except subprocess.TimeoutExpired:
                        check(False, f"{what}: rank {r} finished within {TP_TIMEOUT_S} s")
                    if p.returncode != 0:
                        outs[2 * r + 1].seek(0)
                        check(False, f"{what}: rank {r} exited {p.returncode}:\n"
                                     f"{outs[2 * r + 1].read()[-4000:]}")
                lines = []
                for r in range(2):
                    outs[2 * r].seek(0)
                    lines.append(outs[2 * r].read().strip().splitlines())
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                for f in outs:
                    f.close()
            run_dir = next(line.split(": ", 1)[1] for line in lines[0]
                           if line.startswith("run dir: "))
            row = json.loads(lines[0][-2])
            ranks = [json.loads(ls[-1])["launches"] for ls in lines]
            launches[" ".join(map(str, extra))] = ranks
            print(f"    {what}: {time.perf_counter() - t0:.1f} s with start-up; row "
                  f"{json.dumps(row)}; launches {ranks}  [{card}]")
            check(np.isfinite(row["total_loss"]) and row["step"] == 3 * len(launches),
                  f"{what}: finite loss at step {row['step']}")
            check(all(r == {"match": 3, "flip": 6, "wgrad": 72} for r in ranks),
                  f"{what}: B2 1, B3 2, B4 24 launches a step on each rank")
        config = ExperimentConfig.load(os.path.join(run_dir, "saved_config.json"))
        trainer, module, _ = cli._restore_run(config, run_dir, "cuda")
        ranks_saved = torch.load(saved, weights_only=False)
        check(trainer.step == 6 and not model_shards(module),
              "the restored checkpoint is step 6's, whole, in one process")
        check(all(torch.equal(v.cpu(), ranks_saved["state"][k])
                  for k, v in module.state_dict().items()),
              "its parameters and statistics equal the ranks' gathered ones")
        inputs = tp_probe("cuda")
        raw = probe_forward(module, inputs)
        err = float((raw.cpu() - ranks_saved["out"]).abs().max())
        scale = float(raw.abs().max())
        print(f"    one process vs the 2 sharded ranks, train-mode forward of 4 images: max "
              f"|diff| {err:.3g} of max |out| {scale:.4g}")
        check(err <= TP_FORWARD_TOL * scale, f"the restored model's forward equals the sharded "
                                             f"ranks' within {TP_FORWARD_TOL:g} of the largest")
        decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), candidate_selector="shared")
        batched_nms.LAUNCHES = 0
        with torch.no_grad():
            det = decode(raw)
        torch.cuda.synchronize()
        launches["decode"] = batched_nms.LAUNCHES
        check(det.shape == (4, 200, 6) and bool(torch.isfinite(det).all())
              and launches["decode"] == 1,
              f"shared decode of the restored model: (4, 200, 6) finite, B1 launched "
              f"{launches['decode']} time")
        del trainer, module
    return launches


def run_tensor_parallel(card: str, one_process: dict) -> dict:
    """Phase 9j: tensor parallelism on gloo ranks sharing the card
    (`ssd300_ssd_custom`, f32, TF32 off, B2, B3 and B4, the global batch of
    phase 9i): a 1x2 mesh at the 1024 rule for DP_STEPS steps against phase
    9i's one process (`one_process`), a 2x2 mesh for one step, a 1x2 mesh at
    a 512 rule for one step (B4 on 256-column output slices, each launch
    held to its plain version), and `train-detect --n-model-shards 2`.
    Returns each arm's launches."""
    t_phase = time.perf_counter()
    print(f"[9j] tensor parallelism, gloo ranks on {card}")
    torch.cuda.empty_cache()
    ref1 = dp_train(steps=1)
    ref1.pop("trainer"), ref1.pop("batches")
    print(f"    one process, global batch {DP_BATCH}: 1 step {ref1['seconds']:.2f} s, loss "
          f"{float(ref1['loss'][0]):.6f}; {ref1['n_params']:,} parameters, "
          f"{ref1['param_bytes']:,} B + {ref1['momentum_bytes']:,} B of momentum; peak "
          f"{ref1['peak_bytes'] / 2**20:.1f} MiB (this process holds earlier phases' tensors too)")
    launches, seconds = {}, {}
    for arm, world, n_model, min_features, steps, ref in (
            ("1x2", 2, 2, 1024, DP_STEPS, one_process),
            ("2x2", 4, 2, 1024, 1, ref1),
            ("1x2 rule 512", 2, 2, 512, 1, ref1)):
        torch.cuda.empty_cache()
        record = int(min_features == 512)
        with tempfile.TemporaryDirectory() as tmp:
            ranks, seconds[arm] = run_gloo_ranks(world, (n_model, min_features, steps, record), tmp)
        print(f"    {arm}: {world} gloo ranks, {seconds[arm]:.1f} s with start-up")
        hold_to_one_process(arm, ranks, ref, steps, card, n_data=world // n_model)
        launches[arm] = [r["launches"] for r in ranks]
        if n_model == 2 and min_features == 1024:
            want = 51_984_110 - TP_SHARDED_PARAMS // 2
            check(all(r["n_params"] == want for r in ranks),
                  f"{arm}: each rank holds {want:,} parameters (the 13 sharded leaves' half)")
        if record:
            for r, res in enumerate(ranks):
                shares = res["wgrad_shares"]
                sliced = [s for shape, k, s in shares if shape[-1] == 2 * k]
                worst = max(s for _, _, s in shares)
                print(f"    {arm} rank {r}: {len(shares)} B4 launches held to the plain version, "
                      f"{len(sliced)} on 256-column output slices of 512->512 convs; worst max "
                      f"|diff| {worst:.3g} of max |ref| (slices {max(sliced):.3g})")
                check(len(sliced) == 3 and worst <= WGRAD_TOL,
                      f"{arm} rank {r}: B4 on the 3 sharded 3x3 512->512 convs' 256-column "
                      f"slices and on every other conv within {WGRAD_TOL:g} of its plain version")
    t0 = time.perf_counter()
    launches["cli"] = run_tp_cli(card)
    seconds["cli"] = time.perf_counter() - t0
    print(f"    arms' seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    print(f"    phase 9j: {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 9k: the convergence proxies (ROADMAP A17) at a cut depth: the first
# PROXY_TRAIN train and PROXY_TEST held-out images of the detection proxy's
# corpus, and a classification corpus of CLS_PROXY_TRAIN / CLS_PROXY_TEST.
PROXY_TRAIN, PROXY_TEST, PROXY_STEPS, PROXY_BATCH = 64, 16, 60, 32
CLS_PROXY_TRAIN, CLS_PROXY_TEST, CLS_PROXY_STEPS, CLS_PROXY_BATCH = 128, 32, 40, 64
# SHA-256 of the `.y.npy` and `.cbcr.npy` that `PackedDctDataset.create` writes
# at 352 px for the PROXY_TRAIN train images, from the libjpeg path where
# libjpeg is installed (tests/test_torch_proxy.py holds both codecs to it);
# the card's NumPy-codec digests are printed beside them, not held to them,
# since the card's own PIL decodes the corpus' JPEGs.
PROXY_CORPUS_SHA256 = {
    ".y.npy": "d79b1f844e75ac60e32d027d40b4f76a5046d3b7b16b854cdf99faafb27a448a",
    ".cbcr.npy": "1a4afed77716ae5af952bddf6be5b95621dc585f8e15d5d7efa53cbdd904a498",
}


def proxy_script(name: str):
    """A proxy script of `scripts/` as a module (they import only the port)."""
    import importlib

    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def file_sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def check_proxy_losses(label: str, history: list, steps_per_row: int, card: str) -> None:
    """Every epoch row's loss finite, the last 10 steps' mean below the first
    10's (each row is the mean of its epoch's steps); warm steps/s over the
    second half of the rows by `fit`'s time_s (10 ms resolution)."""
    losses = [row["total_loss"] for row in history]
    k = max(1, 10 // steps_per_row)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    warm = history[len(history) // 2:]
    warm_s = sum(row["time_s"] for row in warm)
    print(f"    {label}: loss, first {k * steps_per_row} steps {first:.4f}, last {k * steps_per_row} "
          f"{last:.4f}; warm {steps_per_row * len(warm) / warm_s:.3f} steps/s "
          f"({len(warm) * steps_per_row} steps, fit's time_s)  [{card}]")
    check(all(np.isfinite(losses)), f"{label}: every loss finite")
    check(last < first, f"{label}: the last 10 steps' mean loss is below the first 10's")


def run_proxies(card: str) -> dict:
    """Phase 9k: the detection proxy (`scripts/torch_convergence_proxy.py`,
    `device_v3`) and the classification proxy (`device`) on the card, at a
    cut depth, with every DCT plane from the NumPy codec (no libjpeg here).
    Returns the kernels' launches in each."""
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset
    from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset
    from jpeg_detection_resnet_ssd_torch.ops import batched_nms, conv_grad, dct_flip
    from jpeg_detection_resnet_ssd_torch.ops import bipartite_match as bm

    def reset():
        batched_nms.LAUNCHES = bm.LAUNCHES = conv_grad.LAUNCHES = dct_flip.LAUNCHES = 0

    def read():
        torch.cuda.synchronize()
        return {"nms": batched_nms.LAUNCHES, "match": bm.LAUNCHES, "flip": dct_flip.LAUNCHES,
                "wgrad": conv_grad.LAUNCHES}

    t_phase = time.perf_counter()
    det, cls = proxy_script("torch_convergence_proxy"), proxy_script("torch_cls_convergence_proxy")
    print(f"[9k] the convergence proxies on {card}: device_v3 detection ({PROXY_TRAIN} train, "
          f"{PROXY_TEST} held-out images, {PROXY_STEPS} steps at batch {PROXY_BATCH} bf16), "
          f"classification ({CLS_PROXY_TRAIN}/{CLS_PROXY_TEST}, {CLS_PROXY_STEPS} steps at batch "
          f"{CLS_PROXY_BATCH}); DCT planes from the NumPy codec")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "voc_shapes")
        t0 = time.perf_counter()
        det.generate_corpus(root, keep=(PROXY_TRAIN, PROXY_TEST))
        t1 = time.perf_counter()
        ds = DetectionDataset.from_voc(f"{root}/JPEGImages", f"{root}/ImageSets/Main/trainval.txt",
                                       f"{root}/Annotations")
        stem = os.path.join(root, f"packed_{det.PACK_SIDE}")
        PackedDctDataset.create(ds, stem, img_height=det.PACK_SIDE, img_width=det.PACK_SIDE,
                                num_workers=8, codec="numpy")
        print(f"    corpus: generated in {t1 - t0:.2f} s, packed at {det.PACK_SIDE} px by the NumPy "
              f"codec in {time.perf_counter() - t1:.2f} s")
        for ext, pinned in PROXY_CORPUS_SHA256.items():
            print(f"    {ext}: SHA-256 {file_sha256(stem + ext)} on the card (NumPy codec), "
                  f"{pinned} pinned from the libjpeg path")
        args = det.build_parser().parse_args([str(a) for a in (
            "--variant", "device_v3", "--steps", PROXY_STEPS, "--batch-size", PROXY_BATCH,
            "--data-root", root, "--output-dir", os.path.join(tmp, "runs"), "--codec", "numpy",
            "--num-workers", 8)])
        reset()
        t0 = time.perf_counter()
        out, details = det.run(args)
        launches = read()
        print(f"    {json.dumps(out)}")
        print(f"    detection proxy: {time.perf_counter() - t0:.1f} s; kernel launches: NMS "
              f"{launches['nms']}, matching {launches['match']}, flip {launches['flip']}, "
              f"filter gradient {launches['wgrad']} (off, as the reference's config)")
        check_proxy_losses("detection", details["history"], PROXY_TRAIN // PROXY_BATCH, card)
        n_decodes = 2 * -(-PROXY_TEST // 8)
        check(launches == {"nms": n_decodes, "match": PROXY_STEPS, "flip": 2 * PROXY_STEPS,
                           "wgrad": 0},
              f"B2 once and B3 twice a step, B1 once in each of the {n_decodes} held-out decodes "
              f"(2 selectors x {n_decodes // 2} batches)")
        check(0.0 <= out["heldout_mAP"] <= 1.0 and 0.0 <= out["heldout_mAP_shared_selector"] <= 1.0,
              "held-out mAP in [0, 1] for both selectors")
        exact, shared = details["predictions"]["exact"], details["predictions"]["shared"]
        same = exact == shared
        print(f"    selectors on the same weights: {sum(map(len, exact))} exact and "
              f"{sum(map(len, shared))} shared predictions, identical lists: {same}; mAP exact "
              f"{details['mAP']['exact']:.6f}, shared {details['mAP']['shared']:.6f}, delta "
              f"{details['mAP']['shared'] - details['mAP']['exact']:.6f}")
        del details

        reset()
        t0 = time.perf_counter()
        args = cls.build_parser().parse_args([str(a) for a in (
            "--variant", "device", "--steps", CLS_PROXY_STEPS, "--batch-size", CLS_PROXY_BATCH,
            "--n-train", CLS_PROXY_TRAIN, "--n-test", CLS_PROXY_TEST,
            "--data-root", os.path.join(tmp, "cls_shapes"), "--output-dir",
            os.path.join(tmp, "cls_runs"), "--codec", "numpy", "--num-workers", 8)])
        cls_out, details = cls.run(args)
        cls_launches = read()
        print(f"    {json.dumps(cls_out)}")
        print(f"    classification proxy (corpus and packing included): "
              f"{time.perf_counter() - t0:.1f} s; kernel launches: flip {cls_launches['flip']}, "
              f"matching {cls_launches['match']}, NMS {cls_launches['nms']}, filter gradient "
              f"{cls_launches['wgrad']}")
        check_proxy_losses("classification", details["history"], CLS_PROXY_TRAIN // CLS_PROXY_BATCH,
                           card)
        check(cls_launches == {"nms": 0, "match": 0, "flip": 2 * CLS_PROXY_STEPS, "wgrad": 0},
              "B3 twice a classification step, no other kernel")
        check(0.0 <= cls_out["heldout_top1"] <= 1.0, "held-out top-1 in [0, 1]")
        del details
    torch.cuda.empty_cache()
    print(f"    phase 9k: {time.perf_counter() - t_phase:.1f} s")
    return {"detection": launches, "classification": cls_launches}


def tp_launches(tp: dict, kernel: str) -> dict:
    """One kernel's launches in each arm of phase 9j, a list by rank."""
    return {arm: [r[kernel] for r in ranks] for arm, ranks in tp.items() if arm != "cli"} | {
        f"cli {run}": [r[kernel] for r in ranks] for run, ranks in tp["cli"].items()
        if run != "decode"}


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
    match_err, stress_sims, stress_mask = check_match(dev, anchors)

    print(f"[5] filter-gradient kernel against its plain version (tolerance {WGRAD_TOL:g} max |ref|)")
    wgrad_err = check_wgrad(dev)

    print("[5b] flip kernel against its plain version (bit for bit)")
    flip_err = check_flip(dev)

    print("[5c] augmentation chain: card (flip kernel, TF32 off) vs CPU, one set of host draws")
    check_chain(dev)

    print("[5d] train-mode BatchNorm kernels against their plain version")
    bn_err = check_batch_norm(dev)
    bn_times = time_batch_norm(dev, card)

    nms, served = run_inference(dev, card)
    train = run_training(dev, card, stress_sims, stress_mask)
    flip = run_augmented_training(dev, card, train["trainer"], train["batch"])
    run_evaluate(card, **served)
    run_train_detect(card)
    cls_wgrad, cls_flip = run_classification(dev, card)
    fam = run_other_families(dev, card)
    serve = run_serving(dev, card, **served)
    dp = run_data_parallel(card)
    tp = run_tensor_parallel(card, dp["one_process"])
    proxy = run_proxies(card)

    print(f"[10] done in {time.perf_counter() - t_start:.1f} s")
    source = "jpeg_detection_resnet_ssd_torch/ops/csrc/{}.cu"
    print(json.dumps({"kernels": [
        {"name": "batch_norm_train", "route": "cuda", "source": source.format("batch_norm"),
         "replaces": None, "max_gap": bn_err, "library_ms": None, "launches": train["bn_launches"],
         **bn_times, "data_parallel": {"launches": [r["bn"] for r in dp["launches"]]}},
        {"name": "batched_nms_mask", "route": "cuda", "source": source.format("batched_nms"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_nms.py:114",
         "max_abs_err": nms_err, "library_ms": None, **nms,
         "vgg": {"launches": fam["nms_launches"]}, "serve": serve,
         "tensor_parallel": {"launches": tp["cli"]["decode"]},
         "proxy": {"launches": proxy["detection"]["nms"]}},
        {"name": "bipartite_match", "route": "cuda", "source": source.format("bipartite_match"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_match.py:174",
         "max_abs_err": match_err, "library_ms": None, **train["match"],
         "vgg": {"launches": fam["launches"]["match"]},
         "data_parallel": {"launches": [r["match"] for r in dp["launches"]]},
         "tensor_parallel": {"launches": tp_launches(tp, "match")},
         "proxy": {"launches": proxy["detection"]["match"]}},
        {"name": "conv3x3_filter_grad", "route": "cuda", "source": source.format("conv3x3_wgrad"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_conv_grad.py:128",
         "max_abs_err": max(wgrad_err, train["wgrad_step_err"], cls_wgrad["max_abs_err"],
                            fam["wgrad"]["max_abs_err"]),
         **train["wgrad"], "classification": cls_wgrad, "vgg": fam["wgrad"],
         "data_parallel": {"launches": [r["wgrad"] for r in dp["launches"]]},
         "tensor_parallel": {"launches": tp_launches(tp, "wgrad")}},
        {"name": "dct_flip_horizontal", "route": "cuda", "source": source.format("dct_flip"),
         "replaces": "jpeg_detection_resnet_ssd_tpu/ops/dct_augment.py:75",
         "max_abs_err": max(flip_err, cls_flip["max_abs_err"]), "library_ms": None, **flip,
         "classification": cls_flip, "vgg": {"launches": fam["launches"]["flip"]},
         "data_parallel": {"launches": [r["flip"] for r in dp["launches"]]},
         "tensor_parallel": {"launches": tp_launches(tp, "flip")},
         "proxy": {"launches": proxy["detection"]["flip"],
                   "classification": proxy["classification"]["flip"]}},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


WORKERS = {"--dp-worker": dp_worker, "--cli-worker": cli_worker, "--tp-cli-worker": tp_cli_worker}

if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in WORKERS:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(WORKERS[sys.argv[1]](sys.argv[2:]))
    sys.exit(main())
