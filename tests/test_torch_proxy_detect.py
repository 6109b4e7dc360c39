"""The device variants of the port's detection proxy
(`scripts/torch_convergence_proxy.py`): each runs one float32 step on the
CPU at batch 1 (2 train images, 1 held-out) and prints the JAX script's
JSON line; then `scripts/torch_quantize_eval.py` on the `device_v3` run.
The host variants are in `test_torch_proxy_host.py`, so that `--dist
loadfile` spreads the runs over two workers.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_convergence_proxy as proxy  # noqa: E402
import torch_quantize_eval as quantize_eval  # noqa: E402

from torch_cases import run_proxy_script  # noqa: E402

# The JAX script's JSON keys, in its order (`scripts/convergence_proxy.py:351-371`).
JSON_KEYS = ["variant", "seed", "model", "steps", "train_images", "test_images", "final_train_loss",
             "heldout_mAP", "heldout_mAP_shared_selector", "selector_delta", "heldout_AP_nonzero",
             "run_dir"]


@pytest.fixture(scope="module", autouse=True)
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's corpus and run dirs, removed at its end: a run dir holds
    a checkpoint of the full-width model (~0.4 GB for ssd_custom)."""
    path = tmp_path_factory.mktemp("proxy")
    yield path
    shutil.rmtree(path, ignore_errors=True)


def run_variant(workdir, variant, capsys):
    """One float32 step of `variant` on the CPU; its JSON line, checked."""
    out = run_proxy_script(proxy.main, capsys, [
        "--variant", variant, "--steps", 1, "--n-train", 2, "--n-test", 1, "--batch-size", 1,
        "--device", "cpu", "--compute-dtype", "float32", "--codec", "numpy", "--num-workers", 2,
        "--data-root", workdir / "voc", "--output-dir", workdir / "runs"])
    assert list(out) == JSON_KEYS
    assert out["variant"] == variant and out["steps"] == 1
    assert (out["train_images"], out["test_images"]) == (2, 1)
    assert out["model"] == ("ssd300_vgg" if variant == "rgb" else "ssd300_ssd_custom")
    assert np.isfinite(out["final_train_loss"]) and 0.0 <= out["heldout_mAP"] <= 1.0
    assert out["selector_delta"] == round(out["heldout_mAP_shared_selector"] - out["heldout_mAP"], 5)
    assert Path(out["run_dir"], "checkpoints").is_dir()
    if variant != "device_v3":  # kept for the quantize test
        shutil.rmtree(out["run_dir"])
    return out


@pytest.mark.parametrize("variant", proxy.DEVICE_VARIANTS)
def test_device_variant_runs_one_step_and_prints_the_jax_line(workdir, variant, capsys):
    run_variant(workdir, variant, capsys)
    assert (workdir / "voc" / f"packed_{proxy.PACK_SIDE}.y.npy").is_file()


def test_quantize_eval_prints_its_four_variants(workdir, capsys):
    """On the `device_v3` run above: the four JSON rows and the summary of
    `scripts/quantize_eval.py`; folding is exact up to f32 rounding."""
    run_dir = next((workdir / "runs").glob("local_proxy_device_v3_s0_*"))
    summary = quantize_eval.main(["--run-dir", str(run_dir), "--data-root", str(workdir / "voc"),
                                  "--device", "cpu", "--codec", "numpy", "--batch-size", "1",
                                  "--calib-batches", "2"])
    rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r.get("variant") for r in rows[:4]] == ["float", "folded", "int8", "int8_all"]
    assert rows[2]["n_quantized"] > 0 and "kept_float" in rows[2]
    assert rows[4] == summary
    assert list(summary) == ["run_dir", "summary_mAP", "fold_delta", "int8_delta", "int8_all_delta"]
    assert abs(summary["fold_delta"]) <= 1e-3
