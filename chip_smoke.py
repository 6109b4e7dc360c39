#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one card, nvcc

The main path is the `ssd_custom` DCT-SSD300 detector at inference at full
width: `build_model("ssd300_ssd_custom")` -> forward on seeded DCT planes ->
`make_inference_fn` (candidate selection, batched greedy NMS on the CUDA
kernel, global top-200) -> (B, 200, 6) detections.

Phases (any failure exits non-zero):
  1. card name and power limit (nvidia-smi);
  2. build the NMS kernel from the sources in the checkout with nvcc;
  3. the kernel against its plain PyTorch version on seeded problems at the
     serving shape (N=640, K=400) and a ragged one (N=7, K=37), with pairs at
     IoU exactly the threshold and zero-score slots: masks exactly equal;
  4. the main path: a batch-32 bf16 request and a batch-1 f32 request, each
     through the `shared` and the `exact` candidate selector, with the kernel
     launch counter reset just before and read just after; then, on the same
     raw predictions, kernel and plain NMS give identical detections, and the
     f32 forward agrees with the port's CPU forward (the path the CPU tests
     hold against the JAX package);
  5. CUDA-event timings (median and range of 5 windows after a warm-up):
     forward + decode at batch 32 in bf16 (images/s), the forward alone, its
     host enqueue time and its FLOP rate, the decodes alone, the NMS kernel,
     its plain version and its bound, at the main path's shapes;
  6. the `kernels` JSON line, the card line, and the final JSON line.

Weights are the port's seeded init (torch.Generator seeded 0); the BatchNorm
running statistics are then calibrated on the batch-32 request (one
train-mode forward), since identity statistics on N(0, 100) DCT planes drive
the activations, and the box offsets, to overflow.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores, same source
H100_BF16_FLOPS = 989e12  # bf16 dense on the tensor cores, same source
NMS_OPS_PER_PAIR = 16  # 2x(min, max, sub, add d, max 0), mul, add, sub, max, div, cmp


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


def nms_bound(keep: torch.Tensor) -> tuple[float, str, int]:
    """Least time for the greedy NMS these inputs need: each kept candidate i
    (the alive ones at step i) is tested against the K-1-i later ones."""
    n, k = keep.shape
    pairs = int(((k - 1 - torch.arange(k, device=keep.device)) * keep).sum().item())
    ops = NMS_OPS_PER_PAIR * pairs
    nbytes = n * k * (4 * 4 + 4 + 1)  # boxes, scores in; keep out
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), pairs


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from jpeg_detection_resnet_ssd_torch.boxes.anchors import AnchorSpec, build_anchors
    from jpeg_detection_resnet_ssd_torch.boxes.decode import decode_detections, select_candidates
    from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.ops import _build, batched_nms
    from jpeg_detection_resnet_ssd_torch.utils import cuda_times_ms

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    print("[2] build")
    t0 = time.perf_counter()
    log = _build.build("batched_nms", force=True)
    _build.load("batched_nms")
    print(f"    nvcc build of ops/csrc/batched_nms.cu: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    print("[3] NMS kernel against its plain version")
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

    print("[4] main path")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("    TF32 off for cuDNN convolutions and matmuls (f32 checks run in full f32)")
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
    print(f"    NMS kernel launches on the main path: {launches}")
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

    print(f"[5] timings (CUDA events; median of 5 windows [min-max]) on {card}")

    def timed(fn, iters):
        times = cuda_times_ms(fn, iters=iters, windows=5)
        return float(np.median(times)), f"[{min(times):.4f}-{max(times):.4f}]"

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
    print(f"    NMS at the main path's shape N={nb.shape[0]} K={nb.shape[1]}: {alive} candidates "
          f"with score > 0, {int(keep.sum())} kept, {pairs} pair tests needed")
    print(f"    NMS kernel: {kernel_ms:.5f} ms {kernel_spread}; plain PyTorch version: "
          f"{plain_ms:.4f} ms {plain_spread}; bound {bound_ms:.6f} ms ({bound_by}); library: "
          f"none (no single PyTorch call computes a greedy-NMS keep mask)  [{card}]")

    print(f"[6] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "batched_nms_mask",
        "route": "cuda",
        "source": "jpeg_detection_resnet_ssd_torch/ops/csrc/batched_nms.cu",
        "replaces": "jpeg_detection_resnet_ssd_tpu/ops/pallas_nms.py:114",
        "launches": launches,
        "max_abs_err": float(max_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
