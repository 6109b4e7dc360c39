"""Readings that the limits of a cell are set from, on the card.

    python3 port_bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--faults] [--first-seed N] [--out FILE]

In one process: the program's compared numbers on `--seeds` seeds (each a
whole set-up and the compared steps or kept batches of a run, with a short
window for serving), then the control's on `--control-seeds` seeds: the
plain reference put in the program's place, computed one precision below
what the configuration states (network products in float8 e4m3 with bf16
arithmetic in place of bf16; augment and target encoding in bfloat16 in
place of float32; the decode and the top-k in bfloat16), judged by the
same comparison against the float reference.  With `--faults`, a training
cell also reads, on the control's seeds, the fault of half the batch left
out (the reference's step on the first half only, its mean over that half)
and that of a step that leaves the state unchanged (the program's run with
its optimizer's step doing nothing).
Each reading is one JSON line; `--out` appends them to a file too.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import core  # noqa: E402


def _emit(row, out):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def train_control(spec, seed, device, faults: bool):
    import torch

    from port_bench import compare, inputs
    from port_bench.reference import nets

    task, mix = spec["config"]["task"], spec["traffic"]
    W, pool, gts = inputs.for_run(spec, seed, device)
    ref = compare.reference_train(spec, seed, W, pool, gts, device)
    rows = []
    ctl = compare.reference_train(spec, seed, W, pool, gts, device, prec=nets.FP8,
                                  aug_dtype=torch.bfloat16, enc_dtype=torch.bfloat16)
    rows.append(("control", compare.train_numbers(spec, ctl, ref)))
    if faults:
        n = mix["batch"] // 2
        half = dict(spec, traffic=dict(mix, batch=n))
        cut = [tuple(t[:n] for t in pair) for pair in pool]
        cut_gts = [tuple(a[:n] for a in g) if task == "detection" else g[:n] for g in gts]
        bad = compare.reference_train(half, seed, W, cut, cut_gts, device)
        # the planes, boxes and outputs of the rows that were kept are compared
        ref_half = dict(ref, planes=[tuple(t[:n] for t in p) for p in ref["planes"]],
                        targets=[t[:n] for t in ref["targets"]],
                        outputs=tuple(o[:n] for o in ref["outputs"]))
        num = compare.train_numbers(half, bad, ref_half)
        num.update(compare.state_gaps(bad, ref))
        rows.append(("half_batch", num))
    return rows


def state_unchanged(driver, spec, seed, device):
    """The program's compared numbers with `torch.optim.SGD.step` doing
    nothing, as a step that returns its state unchanged."""
    import torch

    step = torch.optim.SGD.step
    torch.optim.SGD.step = lambda self, closure=None: None
    try:
        out = driver.run(spec, seed=seed, seconds=0.0, trace=False, device=device,
                         t_start=time.perf_counter())
    finally:
        torch.optim.SGD.step = step
    return out["numbers"]


def serve_control(spec, seed, device):
    import torch

    from port_bench import compare, inputs
    from port_bench.reference import nets, ssd

    cfg, mix, network = spec["config"], spec["traffic"], spec["network"]
    W, pool, _ = inputs.for_run(spec, seed, device)
    compare.calibrate(spec, W, pool[0], mix["calibration_images"], device)
    ref_raw, raw, served = {}, {}, {}
    for slot, pair in enumerate(pool):
        ref_raw[slot] = compare.reference_forward(spec, W, pair, device)
        ctl = tuple(t.to(torch.bfloat16)
                    for t in compare.reference_forward(spec, W, pair, device, prec=nets.FP8))
        raw[slot] = torch.cat([t.float() for t in ctl], -1)
        if cfg["task"] == "detection":
            scores, offsets = ctl
            dets = []
            for i in range(0, mix["batch"], compare.CHUNK):
                dets.append(ssd.decode(network.ANCHORS, scores[i:i + compare.CHUNK],
                                       offsets[i:i + compare.CHUNK], cfg["n_classes"],
                                       pool=mix["shared_pool"], dtype=torch.bfloat16).float())
            served[slot] = torch.cat(dets).cpu()
        else:
            v, i = torch.topk(ctl[0], mix["top_k"], -1)
            served[slot] = torch.cat([v.float(), i.float()], -1).cpu()
    numbers, _ = compare.serve_numbers(spec, raw, served, ref_raw)
    return [("control", numbers)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=4_100_000_000)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    core.environment()
    import torch

    spec = core.load_cell(args.workload)
    device = torch.device("cuda:0")
    torch.set_num_threads(core.HOST_THREADS)
    kind = spec["traffic"]["kind"]
    driver = core.load_module(core.BENCH_DIR / "loops" / f"{kind}.py")
    seconds = 0.0 if kind == "train" else 2.0
    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.perf_counter()
        out = driver.run(spec, seed=seed, seconds=seconds, trace=False, device=device, t_start=t)
        _emit({"cell": args.workload, "who": "program", "seed": seed, "numbers": out["numbers"],
               "worst": out.get("worst"),
               "setup_s": out["record"]["setup_s"], "s": time.perf_counter() - t,
               "peak_bytes": out["device"]["memory_peak_bytes"],
               "reference_peak_bytes": out.get("reference_peak_bytes")}, args.out)
        torch.cuda.empty_cache()
    for i in range(args.control_seeds):
        seed = args.first_seed + 1000 + i
        t = time.perf_counter()
        rows = (train_control(spec, seed, device, args.faults) if kind == "train"
                else serve_control(spec, seed, device))
        if args.faults and kind == "train":
            rows.append(("state_unchanged", state_unchanged(driver, spec, seed, device)))
        for who, numbers in rows:
            _emit({"cell": args.workload, "who": who, "seed": seed, "numbers": numbers,
                   "s": time.perf_counter() - t}, args.out)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
