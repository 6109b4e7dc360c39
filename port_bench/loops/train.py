"""Driver of a training mix: a closed loop of train steps on one card.

Set-up builds the program's trainer (`train.loop.build_trainer`) with the
configuration's device augment and, for detection, its target encoder,
loads the benchmark's seeded weights, and feeds it through the program's
data layer (`data.pipeline.prefetch_to_device`) from a seeded pool of
source planes.  The first `compare_steps` steps run through that same call
and feed, on pool slots that all differ, and their augmented planes and
boxes, matched targets, losses, the network's outputs in the first step (a
forward hook), the first gradient (the momentum buffer after step one) and
the parameter change are kept; `warm_steps` more steps follow.
The window then runs steps until `--seconds` have passed on the host clock
and closes with `sync(torch, device)`.  After the window the program
is freed and the plain reference repeats the kept steps from the same
seeded inputs and draws (`compare.py`).
"""

from __future__ import annotations

import gc
import itertools
import time

import torch

from port_bench import compare, inputs, weights
from port_bench.core import device_info, elapsed, reset_peak, sync
from port_bench.counts import flops
from port_bench.trace import Spans, reduce


# the program's maker of each augment a mix can name
AUGMENTS = {"detection_v3": "make_dct_detection_augment_v3",
            "classification_v2": "make_dct_classification_augment_v2"}


class _Tap:
    """A program hook wrapped: each call runs inside a span; while `keep` is
    set its result is copied to host memory, and while `count` is set the
    live ground-truth rows it was handed are counted on the device."""

    def __init__(self, fn, name, spans, pick):
        self.fn, self.name, self.spans, self.pick = fn, name, spans, pick
        self.keep = self.count = False
        self.kept, self.live_rows = [], []

    def __call__(self, *args):
        if self.count:
            self.live_rows.append(args[1].sum())
        with self.spans(self.name):
            out = self.fn(*args)
        if self.keep:
            self.kept.append(self.pick(out))
        return out


def _build(spec, seed, device, spans):
    from jpeg_detection_resnet_ssd_torch import ops
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig
    from jpeg_detection_resnet_ssd_torch.train.loop import build_trainer

    cfg, mix = spec["config"], spec["traffic"]
    train = cfg["train"]
    config = ExperimentConfig(model=cfg["model"], task=cfg["task"],
                              model_kwargs=dict(cfg["model_kwargs"]), batch_size=mix["batch"],
                              compute_dtype=cfg["compute_dtype"], seed=seed,
                              **{k: train[k] for k in ("learning_rate", "momentum", "nesterov",
                                                       "lr_decay", "l2_regularization")})
    if cfg["task"] == "detection":
        frame = mix["out_blocks"] * 8
        encoder = TargetEncoder(AnchorSpec(img_height=frame, img_width=frame),
                                ssd_predictor_sizes(cfg["anchor_family"]),
                                n_classes=cfg["n_classes"], device=device)
    else:
        encoder = None
    augment = getattr(ops, AUGMENTS[mix["augment"]])(mix["out_blocks"], device=device)
    trainer, module, _ = build_trainer(config, target_encoder=encoder, augment_fn=augment,
                                       device=device)
    planes_tap = _Tap(augment, "augment", spans,
                      lambda b: tuple(t.detach().cpu() for t in b["inputs"])
                      + ((b["gt"].cpu(), b["gt_mask"].cpu()) if "gt" in b else ()))
    trainer.augment_fn = planes_tap
    target_tap = None
    if encoder is not None:
        target_tap = _Tap(encoder, "encode", spans, lambda t: t[..., :-8].detach().cpu())
        trainer.target_encoder = target_tap
    return trainer, module, planes_tap, target_tap


def _feed(pool, gts, task):
    """Pool slots in order, forever, as the program's host batches."""
    for i in itertools.count():
        s = i % len(pool)
        y, c = pool[s]
        batch = {"inputs": (y.numpy(), c.numpy())}
        if task == "detection":
            batch["gt"], batch["gt_mask"] = gts[s]
        else:
            batch["labels"] = gts[s]
        yield batch


def run(spec, seed, seconds, trace, device, t_start):
    from jpeg_detection_resnet_ssd_torch.data.pipeline import prefetch_to_device

    cfg, mix, network = spec["config"], spec["traffic"], spec["network"]
    task, B = cfg["task"], mix["batch"]
    n_cmp = mix["compare_steps"]
    spans = Spans(trace)
    W, pool, gts = inputs.for_run(spec, seed, device)
    trainer, module, planes_tap, target_tap = _build(spec, seed, device, spans)
    weights.load_into(module, W)
    feed = prefetch_to_device(_feed(pool, gts, task), size=2, device=device)

    p0 = {n: p.detach().clone() for n, p in module.named_parameters()}
    losses = []
    step = 0

    def one_step():
        nonlocal step
        with spans("data_wait"):
            batch = next(feed)
        with spans("train_step"):
            m = trainer.train_step(batch, inputs.step_generator(seed, step))
        losses.append(m["total_loss"])
        step += 1

    planes_tap.keep = True
    if target_tap is not None:
        target_tap.keep = True
    first_out = []
    hook = module.register_forward_hook(
        lambda _m, _a, out: first_out.append(out.detach().float().cpu()))
    one_step()
    hook.remove()
    # the first gradient as the optimizer holds it (none: it took no step)
    grad1 = {n: float(trainer.optimizer.state[p]["momentum_buffer"].float().norm())
             if "momentum_buffer" in trainer.optimizer.state.get(p, {}) else 0.0
             for n, p in module.named_parameters()}
    for _ in range(n_cmp - 1):
        one_step()
    change = {n: float((p.detach() - p0[n]).norm()) for n, p in module.named_parameters()}
    del p0
    prog = {"losses": [float(x) for x in losses[:n_cmp]], "outputs": first_out[0],
            "grad1": grad1, "change": change}
    planes_tap.keep = False
    if target_tap is not None:
        target_tap.keep = False
    for _ in range(mix["warm_steps"]):
        one_step()
    sync(torch, device)
    setup_s = elapsed(t_start)

    if target_tap is not None:
        target_tap.count = trace
    reset_peak(torch, device)
    first = step
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    spans.durations.clear()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one_step()
    sync(torch, device)
    window = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    steps = step - first
    dev = device_info(torch, 1, device)
    window_losses = torch.tensor([float(x) for x in losses[first:]])
    failed = int((~torch.isfinite(window_losses)).sum()) * B
    record = {"setup_s": setup_s, "window_s": window, "images": steps * B, "steps": steps,
              "batch": B}
    if trace:
        record.update(reduce(prof, window))
        del prof
        record.update(
            spans={k: list(v) for k, v in spans.durations.items()},
            peak_mem_bytes=dev["memory_peak_bytes"],
            step_flops=B * flops.train_flops(network, mix["out_blocks"], cfg["n_classes"]),
            out_blocks=mix["out_blocks"],
            b2_live_rows=[int(x) for x in target_tap.live_rows] if target_tap else [],
            max_gt=mix["boxes"]["max_gt"] if task == "detection" else 0,
            n_anchors=network.ANCHORS.count() if task == "detection" else 0)
        dev["busy_s"], dev["window_s"] = record["busy_s"], window

    prog["planes"] = planes_tap.kept
    prog["targets"] = target_tap.kept if target_tap else []
    del trainer, module, feed, planes_tap, target_tap, losses, first_out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, worst = compare.train(spec, seed, W, pool, gts, prog, device)
    return {"record": record, "device": dev, "attempted": steps * B, "failed": failed,
            "numbers": numbers, "worst": worst}
