"""The host variants of the port's detection proxy (`host`, `none`, `rgb`)
and every variant of its classification proxy
(`scripts/torch_cls_convergence_proxy.py`): one float32 step each on the
CPU at batch 1 (2 train images, 1 held-out), printing the JAX scripts'
JSON lines.  The device variants are in `test_torch_proxy_detect.py`.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import torch_cls_convergence_proxy as cls_proxy  # noqa: E402
import torch_convergence_proxy as proxy  # noqa: E402

from test_torch_proxy_detect import run_variant  # noqa: E402
from torch_cases import run_proxy_script  # noqa: E402

# The JAX script's JSON keys, in its order (`scripts/cls_convergence_proxy.py:181-192`).
CLS_JSON_KEYS = ["variant", "seed", "model", "steps", "train_images", "test_images",
                 "final_train_top1", "heldout_top1", "heldout_top5", "run_dir"]


@pytest.fixture(scope="module", autouse=True)
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The module's corpora and run dirs, removed at its end (each run dir
    holds a full-width checkpoint, which `run_variant` removes as it goes)."""
    path = tmp_path_factory.mktemp("proxy")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.mark.parametrize("variant", [v for v in proxy.VARIANTS if v not in proxy.DEVICE_VARIANTS])
def test_host_variant_runs_one_step_and_prints_the_jax_line(workdir, variant, capsys):
    run_variant(workdir, variant, capsys)


@pytest.mark.parametrize("variant", cls_proxy.VARIANTS)
def test_cls_variant_runs_one_step_and_prints_the_jax_line(workdir, variant, capsys):
    out = run_proxy_script(cls_proxy.main, capsys, [
        "--variant", variant, "--steps", 1, "--n-train", 2, "--n-test", 1, "--batch-size", 1,
        "--device", "cpu", "--compute-dtype", "float32", "--codec", "numpy", "--num-workers", 2,
        "--data-root", workdir / "cls", "--output-dir", workdir / "cls_runs"])
    assert list(out) == CLS_JSON_KEYS
    assert out["variant"] == variant and out["steps"] == 1
    assert (out["train_images"], out["test_images"]) == (2, 1)
    assert out["model"] == ("resnet50_rgb" if variant == "rgb"
                            else "resnet50_dct_late_concat_rfa_thinner")
    assert np.isfinite(out["final_train_top1"])
    assert 0.0 <= out["heldout_top1"] <= out["heldout_top5"] <= 1.0
    assert Path(out["run_dir"], "checkpoints").is_dir()
    shutil.rmtree(out["run_dir"])
    if variant == "device":
        assert (workdir / "cls" / "packed_256.y.npy").is_file()
