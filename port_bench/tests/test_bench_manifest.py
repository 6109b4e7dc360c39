"""BENCHMARK.json against the benchmark's contract, and the files each of
its cells and metrics is found by."""

import json
import re

import pytest

from port_bench import core

M = json.loads((core.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["port_bench"] and M["command"][1].startswith("port_bench/")
    assert 1 <= M["run_seconds"] <= 51


def test_names_units_and_keys():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in M[group]}) == len(M[group])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in M["workloads"]}
    assert all(w["chips"] == 1 for w in M["workloads"])
    for cell in cells:
        e2e = [m["name"] for m in core.cell_metrics(M, cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = core.cell_metrics(M, cell, "per_layer")
        assert per_layer
        for m in per_layer:  # each moves an end-to-end metric the cell reports
            assert m["moves"] in e2e
    for m in M["per_layer"] + M["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cell_files(cell):
    spec = core.load_cell(cell)
    assert spec["traffic"]["kind"] in ("train", "serve")
    assert (core.BENCH_DIR / "loops" / f"{spec['traffic']['kind']}.py").exists()
    assert spec["limits"] and all("limit" in v for k, v in spec["limits"].items()
                                  if not k.startswith("_"))


@pytest.mark.parametrize("metric", [m["name"] for m in M["per_layer"] + M["end_to_end"]])
def test_each_metric_has_a_reader_that_finds_nothing_in_an_empty_record(metric):
    reader = core.load_module(core.BENCH_DIR / "metrics" / f"{metric}.py")
    empty = {"spans": {}, "device_ops": {}, "busy_s": 0.0, "window_s": 0.0, "steps": 0,
             "batches": 0, "batch": 0, "images": 0, "batch_s": []}
    assert reader.read(empty) is None


def test_config_files_hold_the_catalog_free_sizes():
    for c in M["configs"]:
        cfg = json.loads((core.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and c["reduced"] == []
        assert c["file"].startswith("port_bench/configs/")
        assert (core.BENCH_DIR / "reference" / f"net_{cfg['network']}.py").exists()
