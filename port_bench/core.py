"""The harness's core: one run of one cell, from the manifest.

`main(argv)` reads `BENCHMARK.json`, finds the cell named by `--workload`,
loads its configuration (`configs/<config>.json`) and the reference
network that the configuration names (`reference/net_<network>.py`), its
traffic mix (`traffic/<traffic>.json`) and its limits
(`limits/<cell>.json`), and hands them to the driver of the mix's kind
(`loops/<kind>.py`).  The driver builds the program, warms the cell's
shapes, measures the window, and checks what the timed path produced
against the plain reference.  With `--trace 1` the window runs under
`torch.profiler`.  Each metric the cell reports (its end-to-end metrics, or
with `--trace 1` its per-layer ones) is read by its own reader,
`metrics/<name>.py`, from the run's record.  The last line of standard
output is the result.  Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the JAX package is a prefix of the port's name: compare whole top-level names
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "jpeg_detection_resnet_ssd_tpu")
# The program's host work is dispatch, not arithmetic: one intra-op thread.
# With 4, the idle pool threads spin after each host op and the serving
# loop's batches jitter by up to 2x (NVIDIA H100 80GB HBM3 host).
HOST_THREADS = 1


class BenchError(RuntimeError):
    """A run that cannot give a result; the message goes to standard error."""


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of loaded modules that the port must not pull in."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots (`metrics/mfu.train.py`)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_file_{path.stem.replace('.', '_')}",
                                                  path)
    if spec is None or spec.loader is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(manifest: dict, cell: str, group: str) -> list[dict]:
    """The metrics of `group` ('end_to_end' or 'per_layer') this cell reports."""
    return [m for m in manifest[group] if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, bench_dir: Path = BENCH_DIR, root: Path = ROOT) -> dict:
    """Everything the drivers need about one cell, found by name."""
    manifest = load_json(root / "BENCHMARK.json")
    cell = find_cell(manifest, name)
    entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    config = load_json(root / entry["file"])
    return {
        "cell": cell,
        "config": config,
        "network": load_module(bench_dir / "reference" / f"net_{config['network']}.py"),
        "traffic": load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(bench_dir / "limits" / f"{name}.json"),
        "end_to_end": cell_metrics(manifest, name, "end_to_end"),
        "per_layer": cell_metrics(manifest, name, "per_layer"),
    }


def read_metrics(metrics: list[dict], record: dict, bench_dir: Path = BENCH_DIR) -> dict:
    """{name: {"value", "unit"}} of each metric its reader finds."""
    out = {}
    for m in metrics:
        value = load_module(bench_dir / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when none exceeds it
    (a number that could not be computed is not correct)."""
    checks, ok = {}, True
    for name, spec in limits.items():
        if name.startswith("_"):
            continue
        value = numbers.get(name)
        limit = spec["limit"]
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def device_info(torch, chips: int, device) -> dict:
    if device.type != "cuda":  # a CPU test of the harness: no device numbers
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips))}


def sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        spec = load_cell(args.workload)
        import torch

        chips = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        torch.set_num_threads(HOST_THREADS)
        print(f"host intra-op threads: {torch.get_num_threads()}", flush=True)
        driver = load_module(BENCH_DIR / "loops" / f"{spec['traffic']['kind']}.py")
        out = driver.run(spec, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device=torch.device("cuda:0"), t_start=t_start)
    except (BenchError, ImportError, OSError, KeyError) as exc:
        print(f"port_bench: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"port_bench: the process holds {found} after the window; no result",
              file=sys.stderr)
        return 3
    result = result_line(out, spec, bool(args.trace))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def result_line(out: dict, spec: dict, trace: bool, bench_dir: Path = BENCH_DIR) -> dict:
    """The run's result: `correct` (every compared number within its limit
    and no failed image), the counts, the metrics of the run's kind, the
    device, with a trace the breakdown, and last the compared numbers."""
    ok, checks = judge(out["numbers"], spec["limits"])
    ok &= out["failed"] == 0
    metrics = read_metrics(spec["per_layer" if trace else "end_to_end"], out["record"], bench_dir)
    result = {"correct": ok, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if trace:
        result["breakdown"] = out["record"]["breakdown"]
    result["checks"] = checks
    return result


def elapsed(t_start: float) -> float:
    return time.perf_counter() - t_start


def environment(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, set before torch loads;
    libraries that could pull in JAX are told not to."""
    cache = root / "port_bench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
