"""How far one `ssd300_ssd_custom` train step's rounding carries into the
next, on the CPU: the data-parallel step (2 gloo ranks) against one process
on the global batch, beside one process against itself at another thread
count.

    python scripts/torch_dp_spread.py [--global-batch 4] [--steps 2]

Prints each run's per-step losses and the largest parameter difference over
the largest parameter.  At the port's random init the second step's loss
moves by ~1e-3 of itself from a rounding-level change of the first update,
in one process alone too, which is why the data-parallel checks hold one
step on the CPU and a loose second-step tolerance on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")]

import torch_dp_worker as worker  # noqa: E402


def param_diff(a, b) -> float:
    keys = [k for k, v in b.items() if v.is_floating_point()]
    largest = max(float(b[k].abs().max()) for k in keys)
    return max(float((a[k] - b[k]).abs().max()) for k in keys) / largest


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    kw = dict(steps=args.steps, global_batch=args.global_batch)
    runs = {}
    for threads in (1, 3):
        torch.set_num_threads(threads)
        runs[f"one process, {threads} thread(s)"] = worker.ssd_custom_step(**kw)
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        runs["2 gloo ranks, rank 0"] = worker.run_ranks("ssd_custom", tmp, procs, timeout=600, **kw)[0]
    ref = runs["one process, 1 thread(s)"]
    for name, run in runs.items():
        losses = [round(float(v), 4) for v in run["metrics"]["total_loss"]]
        print(f"{name}: losses {losses}; parameters {param_diff(run['state'], ref['state']):.3g} "
              f"of the largest from one process at 1 thread")


if __name__ == "__main__":
    main()
