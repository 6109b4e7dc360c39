"""ImageNet classification evaluation and the inference timing harness.

Counterpart of the JAX package's `eval/imagenet_eval.py`: batched top-1 /
top-5 over a `ClassificationPipeline`, the mean and spread of repeated
runs, and the parameter count.  The top-k ranking is NumPy's `argsort` of
the negated logits on the host, as in the JAX package, so both rank the
same logits identically.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _synchronize(out) -> None:
    """Wait for the device work behind `out` (a tensor or a tuple of them)."""
    leaves = out if isinstance(out, (tuple, list)) else (out,)
    for t in leaves:
        if torch.is_tensor(t) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class ClassificationEvaluator:
    """Batched top-1/top-5 over a ClassificationPipeline."""

    def __init__(self, infer_fn, pipeline):
        """infer_fn: (inputs) -> (B, n_classes) logits (tensor or array)."""
        self.infer_fn = infer_fn
        self.pipeline = pipeline

    def __call__(self):
        top1 = top5 = count = 0
        for batch in self.pipeline:
            with torch.no_grad():
                logits = self.infer_fn(batch["inputs"])
            if torch.is_tensor(logits):
                logits = logits.float().cpu().numpy()
            logits = np.asarray(logits)
            labels = np.asarray(batch["labels"])
            k = min(5, logits.shape[-1])
            topk = np.argsort(-logits, axis=-1)[:, :k]
            top1 += int((topk[:, 0] == labels).sum())
            top5 += int((topk == labels[:, None]).any(axis=1).sum())
            count += len(labels)
        return {
            "top1": top1 / max(count, 1),
            "top5": top5 / max(count, 1),
            "count": count,
        }


def timed_runs(fn, args, n_runs: int = 10, warmup: int = 2):
    """Mean/std wall-clock seconds of `fn(*args)` over `n_runs`, each run
    waited for on the device (host clock), after `warmup` untimed runs."""
    for _ in range(warmup):
        _synchronize(fn(*args))
    times = []
    for _ in range(n_runs):
        t0 = time.perf_counter()
        _synchronize(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": float(np.mean(times)),
        "std_s": float(np.std(times)),
        "runs": n_runs,
    }


def count_params(params) -> int:
    """Number of parameters: of a module, or of a nested dict / iterable
    of arrays (e.g. flax-layout variables' "params")."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(np.shape(params)))
