"""The harness's run: the result line's schema, a cell, configuration,
traffic mix and per-layer metric added as files alone, and each cell on
the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench import core
from port_bench.tests import tiny

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def _check_schema(result, trace):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and ("breakdown" in keys) == trace
    assert isinstance(result["correct"], bool)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    json.dumps(result)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(trace):
    s = tiny.spec("resnet50_dct_rfa_thinner.serve_b512")
    _, result = tiny.run(s, trace=trace)
    _check_schema(result, trace)
    names = {m["name"] for m in (s["per_layer"] if trace else s["end_to_end"])}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names


# A reference network that a later configuration would add as a file: the
# late-concat-more-channels classifier (a 768-wide Y trunk, stage-3 blocks
# b1/c1/d1), written from the thinner one's parts.
MORE_CHANNELS = """
from port_bench.reference import nets
from port_bench.reference.net_resnet50_dct_rfa_thinner import OUTPUTS, loss, split

mid = (256, 256, 768)
ARCH = nets.LateConcat(
    y_trunk=(nets.conv_block(1, (256, 256, 768), 1, "a2", 1),
             nets.id_block(2, (256, 256, 768), 1, "b2"),
             nets.id_block(3, (256, 256, 768), 1, "c2"),
             nets.conv_block(3, mid, 2, "a3", 1),
             *(nets.id_block(3, mid, 2, b) for b in ("b3", "c3", "d3"))),
    y_down=nets.THINNER.y_down, cbcr=nets.THINNER.cbcr,
    stage3=tuple(nets.id_block(3, (128, 128, 512), 3, b + "1") for b in "bcd"),
    stage4=nets.THINNER.stage4)


def layers(n_classes):
    out, c = nets.trunk_params(ARCH, "stem.")
    p, c = nets.blocks_params("", c, nets.STAGE5)
    return out + p + [("dense", "fc1000", (n_classes, c))]


def forward(net, y, cbcr, n_classes, checkpoint=False):
    _, _, x = net.trunk(ARCH, y, cbcr, "stem.", checkpoint)
    x = net.blocks(x, nets.STAGE5, "", checkpoint)
    return (net.dense(x.mean(dim=(1, 2)), "fc1000").float(),)
"""


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_cell_added_as_files_alone(tmp_path, kind):
    """A configuration with its own reference network, a traffic mix, the
    cell's limits and a per-layer metric, each a new file, run by name."""
    root = tmp_path / "checkout"
    shutil.copytree(core.BENCH_DIR, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    manifest = json.loads((core.ROOT / "BENCHMARK.json").read_text())
    bench = root / "port_bench"
    (bench / "reference" / "net_resnet50_dct_more_channels.py").write_text(MORE_CHANNELS)
    cfg = json.loads((bench / "configs" / "resnet50_dct_rfa_thinner.json").read_text())
    cfg.update(name="resnet50_dct_more_channels", model="resnet50_dct_late_concat_more_channels",
               network="resnet50_dct_more_channels", input_blocks=16)
    (bench / "configs" / "resnet50_dct_more_channels.json").write_text(json.dumps(cfg))
    base = {"serve": "serve_b512", "train": "train_v2aug_b1024"}[kind]
    mix = json.loads((bench / "traffic" / f"{base}.json").read_text())
    mix.update(batch=2, slots=1, calibration_images=2, sample_span=1, warm_batches=1, warm_steps=0,
               source_blocks=20, out_blocks=16)
    (bench / "traffic" / f"{kind}_b2.json").write_text(json.dumps(mix))
    (bench / "metrics" / f"batches.{kind}.py").write_text(
        "def read(record):\n    return float(record['images'] // record['batch']) or None\n")
    cell = f"resnet50_dct_more_channels.{kind}_b2"
    limits = json.loads((bench / "limits" / f"resnet50_dct_rfa_thinner.{base}.json").read_text())
    (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    manifest["configs"].append(dict(manifest["configs"][1], name=cfg["name"],
                                    file="port_bench/configs/resnet50_dct_more_channels.json"))
    manifest["workloads"].append({"name": cell, "config": cfg["name"], "traffic": f"{kind}_b2",
                                  "chips": 1, "why": "a cell added by files alone"})
    rate = f"{kind}_images_per_s"
    for m in manifest["end_to_end"]:
        if m["name"] == rate or (kind == "serve" and m["name"] == "serve_batch_p95_ms"):
            m["workloads"].append(cell)
    manifest["per_layer"].append({"name": f"batches.{kind}", "unit": "batches",
                                  "better": "higher", "source": "program_counter",
                                  "layer": "serving", "moves": rate, "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    s = core.load_cell(cell, bench_dir=bench, root=root)
    assert s["traffic"]["batch"] == 2 and s["config"]["name"] == cfg["name"]
    assert s["network"].layers(1000) != core.load_cell(tiny.CELLS[1])["network"].layers(1000)
    out, result = tiny.run(s, seconds=1.0, trace=True, bench_dir=bench)
    assert result["metrics"][f"batches.{kind}"]["value"] >= 1
    assert set(result["checks"]) == {k for k in limits if not k.startswith("_")}
    assert all(c["value"] is not None for c in result["checks"].values())


def test_a_directory_without_the_program_gives_no_result(tmp_path):
    shutil.copytree(core.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                           "resnet50_dct_rfa_thinner.serve_b512", "--seed", "3", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_each_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    proc = subprocess.run([sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
                           str(tiny.SEED), "--seconds", "3", "--trace", "0"], cwd=core.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    _check_schema(result, False)
    assert result["correct"] is True, result["checks"]
