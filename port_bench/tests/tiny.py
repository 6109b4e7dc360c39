"""Cells cut to a size the CPU runs in seconds, for the harness's tests."""

from __future__ import annotations

import time

import torch

from port_bench import core

CELLS = ("ssd300_ssd_custom.train_v3aug_b512", "resnet50_dct_rfa_thinner.train_v2aug_b1024",
         "ssd300_ssd_custom.serve_b256", "resnet50_dct_rfa_thinner.serve_b512")
SEED = 2**31 + 11  # larger than 32 signed bits hold


def spec(cell: str, batch: int = 2, **kw) -> dict:
    s = core.load_cell(cell, **kw)
    s["traffic"].update(batch=batch, slots=3, warm_steps=0, warm_batches=1,
                        calibration_images=batch, sample_span=1)
    return s


def run(s: dict, seed: int = SEED, seconds: float = 0.2, trace: bool = False, bench_dir=None):
    """One run of the cell's driver on the CPU (the look for a card skipped)
    and its result line."""
    bench_dir = bench_dir or core.BENCH_DIR
    torch.set_num_threads(4)
    driver = core.load_module(bench_dir / "loops" / f"{s['traffic']['kind']}.py")
    out = driver.run(s, seed=seed, seconds=seconds, trace=trace, device=torch.device("cpu"),
                     t_start=time.perf_counter())
    return out, core.result_line(out, s, trace, bench_dir)
