"""Driver of a serving mix: one client in a closed loop of batches.

Set-up builds the program's model (`models.build_model`) in the
configuration's compute dtype, loads the benchmark's seeded weights with
BatchNorm statistics that the reference computed on a seeded calibration
batch, and wraps it in the program's serving module
(`serve.export.build_serving_fn`: BatchNorm folded), with the detector's
decode (`models.ssd.make_inference_fn`, the shared candidate pool and the
NMS kernel) or the classifier's top-k.  Each batch leaves a seeded pool of
pinned int16 planes, is copied to the card, served, and its outputs are
copied back to the host; its time is taken from the moment it leaves the
pool to its outputs on the host.  One batch at each pool slot, at window
positions drawn from the seed, also keeps the model's raw output (a
forward hook) for the check after the window (`compare.py`).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from port_bench import compare, inputs, weights
from port_bench.core import device_info, elapsed, reset_peak, sync
from port_bench.counts import flops
from port_bench.trace import Spans, reduce


def _build(spec, W, device):
    from jpeg_detection_resnet_ssd_torch.models import build_model
    from jpeg_detection_resnet_ssd_torch.serve.export import build_serving_fn

    cfg, mix = spec["config"], spec["traffic"]
    dtype = compare.COMPUTE_DTYPES[cfg["compute_dtype"]]
    module, _ = build_model(cfg["model"], dtype=dtype, device=device, **cfg["model_kwargs"])
    weights.load_into(module, W)
    if cfg["task"] == "detection":
        from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec
        from jpeg_detection_resnet_ssd_torch.models.ssd import make_inference_fn

        decode = make_inference_fn(cfg["n_classes"], AnchorSpec(),
                                   candidate_selector=mix["candidate_selector"], device=device)
    else:
        k = mix["top_k"]

        def decode(logits):
            values, idx = torch.topk(logits.float(), k, dim=-1)
            return torch.cat([values, idx.float()], -1)
    serving = build_serving_fn(module, decode)
    del module
    return serving


def run(spec, seed, seconds, trace, device, t_start):
    cfg, mix = spec["config"], spec["traffic"]
    B = mix["batch"]
    spans = Spans(trace)
    W, pool, _ = inputs.for_run(spec, seed, device, pinned=device.type == "cuda")
    compare.calibrate(spec, W, pool[0], mix["calibration_images"], device)
    serving = _build(spec, W, device)

    rng = random.Random(inputs.mix_seed(seed, 4))
    kept: dict[int, torch.Tensor] = {}
    want = [None]

    def hook(_module, _args, out):
        if want[0] is not None:
            kept[want[0]] = out.detach().clone()
    serving.model.register_forward_hook(hook)

    outputs: dict[int, torch.Tensor] = {}
    latencies = []
    bad = []  # images with a non-finite output, counted on the device

    def one_batch(i, keep):
        slot = i % len(pool)
        want[0] = slot if keep else None
        t = time.perf_counter()
        y, c = (x.to(device, non_blocking=True) for x in pool[slot])
        with spans("serve_call"):
            out = serving(y, c)
        bad.append((~torch.isfinite(out)).flatten(1).any(1).sum())
        host = out.cpu()
        latencies.append(time.perf_counter() - t)
        if keep:
            outputs[slot] = host

    with torch.no_grad():
        for i in range(mix["warm_batches"]):
            one_batch(i, False)
        sync(torch, device)
        setup_s = elapsed(t_start)
        latencies.clear()
        bad.clear()
        spans.durations.clear()
        # one kept batch for each pool slot, at a seeded position among the
        # window's first slots x sample_span batches
        keep_at = {s + mix["slots"] * rng.randrange(mix["sample_span"]): s
                   for s in range(mix["slots"])}
        reset_peak(torch, device)
        prof = None
        if trace:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            one_batch(n, n in keep_at)
            n += 1
        sync(torch, device)
        window = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    dev = device_info(torch, 1, device)
    record = {"setup_s": setup_s, "window_s": window, "images": n * B, "batches": n,
              "batch": B, "batch_s": latencies}
    if trace:
        record.update(reduce(prof, window))
        del prof
        record.update(spans={k: list(v) for k, v in spans.durations.items()},
                      images_per_s=n * B / window,
                      image_flops=flops.forward_flops(spec["network"], cfg["input_blocks"],
                                                      cfg["n_classes"]))
        dev["busy_s"], dev["window_s"] = record["busy_s"], window
    del serving
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, nms_work = compare.serve(spec, W, pool, outputs, kept, device)
    if trace:
        record["nms_least_s"] = [nms_work[i % len(pool)] for i in range(n)] if nms_work else None
    return {"record": record, "device": dev, "attempted": n * B,
            "failed": int(torch.stack(bad).sum()) if bad else 0,
            "numbers": numbers}
