"""The classification CLI of the port end to end on the CPU: `train-classify`
-> `--restart` -> `evaluate-classify` on a tiny ImageFolder (modelled on
the JAX package's `tests/test_workflow_classify.py`), the device-augment
path from a packed corpus, a Keras H5 through `--pretrained-weights`, and
the archi resolution of the JAX CLI.

A config JSON selects float32 compute and 4 classes (bf16 convolutions are
slow on the CPU); everything else is the command's own path.
"""

import io
import json
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_torch.cli import main as port_cli
from jpeg_detection_resnet_ssd_torch.data.packed import PackedDctDataset
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's full-size models, and the
    process's count back afterwards: set at import, the count would hold
    for every module that pytest collects after this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


MODEL = "resnet50_dct_late_concat_rfa_thinner"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """4 class dirs x 3 images (ImageNet layout) and a float32 config."""
    from PIL import Image

    root = tmp_path_factory.mktemp("classify")
    rng = np.random.default_rng(0)
    for c in ("c00", "c01", "c02", "c03"):
        os.makedirs(root / "imgs" / c)
        for j in range(3):
            arr = rng.integers(0, 255, (96, 112, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / "imgs" / c / f"{j}.jpeg", "jpeg")
    cfg = root / "f32.json"
    cfg.write_text(ExperimentConfig(
        model=MODEL, task="classification", input_format="dct",
        model_kwargs={"num_classes": 4}, compute_dtype="float32", learning_rate=1e-3,
        nesterov=True, l2_regularization=0.0, batch_size=2, num_workers=2).to_json())
    return {"root": root, "imgs": str(root / "imgs"), "cfg": str(cfg)}


def run_cli(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        port_cli.main([str(a) for a in argv])
    return out.getvalue()


def test_train_restart_evaluate(setup):
    exp = setup["root"] / "exp"
    common = ["train-classify", "--train-dir", setup["imgs"], "--config", setup["cfg"],
              "--output-dir", exp, "--batch-size", 2, "--steps-per-epoch", 2, "--device", "cpu"]
    out = run_cli(common + ["--epochs", 1, "--max-steps", 2])
    run_dir = re.search(r"run dir: (\S+)", out).group(1)
    row = json.loads(out.strip().splitlines()[-1])
    assert np.isfinite(row["loss"]) and row["step"] == 2
    assert {"top1", "top5", "total_loss"} <= row.keys()
    assert os.listdir(os.path.join(run_dir, "checkpoints"))
    with open(os.path.join(run_dir, "saved_config.json")) as f:
        saved = json.load(f)
    assert saved["task"] == "classification" and saved["model"] == MODEL

    out = run_cli(common + ["--epochs", 2, "--max-steps", 4, "--restart"])
    assert re.search(r"run dir: (\S+)", out).group(1) == run_dir
    row2 = json.loads(out.strip().splitlines()[-1])
    assert row2["epoch"] == 1 and row2["step"] == 4 and np.isfinite(row2["loss"])

    out = run_cli(["evaluate-classify", "--run-dir", run_dir, "--val-dir", setup["imgs"],
                   "--batch-size", 4, "--device", "cpu"])
    ev = json.loads(out.strip().splitlines()[-1])
    assert set(ev) == {"top1", "top5", "count"} and ev["count"] == 12
    assert 0.0 <= ev["top1"] <= ev["top5"] <= 1.0


def test_device_augment_from_a_packed_corpus(setup):
    stem = str(setup["root"] / "pack" / "imgs256")
    out = run_cli(["train-classify", "--train-dir", setup["imgs"], "--config", setup["cfg"],
                   "--output-dir", setup["root"] / "exp_aug", "--device-augment",
                   "--pack-cache", stem, "--pallas-wgrad", "--steps-per-epoch", 2, "--epochs", 1,
                   "--steps-per-call", 2, "--device", "cpu"])
    row = json.loads(out.strip().splitlines()[-1])
    assert np.isfinite(row["loss"]) and row["step"] == 2
    corpus = PackedDctDataset(stem)
    assert corpus.meta["task"] == "classification" and corpus.y.shape == (12, 32, 32, 64)
    assert sorted(corpus.labels.tolist()) == [0] * 3 + [1] * 3 + [2] * 3 + [3] * 3


@pytest.mark.parametrize("archi,model,fmt", [
    (None, MODEL, "dct"), ("rgb", "resnet50_rgb", "rgb"),
    ("deconv", "resnet50_dct_deconv", "dct_deconv"),
])
def test_archi_resolution_follows_the_jax_cli(setup, monkeypatch, archi, model, fmt):
    seen = {}

    def fake_fit(config, pipe, **kw):
        seen.update(config=config, pipe=pipe, **kw)
        return None, []

    monkeypatch.setattr("jpeg_detection_resnet_ssd_torch.train.loop.fit", fake_fit)
    argv = ["train-classify", "--train-dir", setup["imgs"], "--output-dir",
            setup["root"] / "exp_archi", "--device", "cpu"] + (["--archi", archi] if archi else [])
    assert run_cli(argv).strip().splitlines()[-1] == "{}"
    cfg = seen["config"]
    assert (cfg.model, cfg.input_format, cfg.task) == (model, fmt, "classification")
    assert (cfg.learning_rate, cfg.nesterov, cfg.lr_decay, cfg.batch_size, cfg.epochs,
            cfg.steps_per_epoch, cfg.warmup_epochs) == (0.1, True, 1e-4, 256, 120, 5000, 5)
    assert cfg.model_kwargs == {"num_classes": 1000} and seen["augment_fn"] is None


def test_pretrained_weights_reach_the_classifier(setup):
    """`--pretrained-weights` imports a Keras H5 by layer name into the
    classifier (here only `fc1000`, a Dense layer: kernel (in, out))."""
    import h5py

    rng = np.random.default_rng(4)
    kernel = rng.normal(0, 0.01, (2048, 4)).astype(np.float32)
    bias = rng.normal(0, 0.01, 4).astype(np.float32)
    path = setup["root"] / "fc.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("fc1000")
        g.attrs["weight_names"] = np.array([b"fc1000/kernel:0", b"fc1000/bias:0"])
        g.create_dataset("fc1000/kernel:0", data=kernel)
        g.create_dataset("fc1000/bias:0", data=bias)
    out = run_cli(["train-classify", "--train-dir", setup["imgs"], "--config", setup["cfg"],
                   "--output-dir", setup["root"] / "exp_h5", "--pretrained-weights", path,
                   "--steps-per-epoch", 1, "--epochs", 1, "--device", "cpu"])
    assert "h5 import: 1 loaded, 0 skipped, 0 mismatched" in out
    run_dir = re.search(r"run dir: (\S+)", out).group(1)
    ckpt = torch.load(os.path.join(run_dir, "checkpoints", "ckpt_00000001.pt"), weights_only=True)
    # one step at lr 1e-3 moves the imported weights by about lr * grad
    moved = ckpt["model"]["fc1000.weight"].numpy() - kernel.T
    assert np.abs(moved).max() < 0.05 and np.isfinite(json.loads(out.strip().splitlines()[-1])["loss"])


def test_device_augment_needs_the_dct_input(setup):
    with pytest.raises(SystemExit, match=re.escape("requires input_format='dct'")):
        run_cli(["train-classify", "--train-dir", setup["imgs"], "--archi", "rgb",
                 "--device-augment", "--output-dir", setup["root"] / "exp_err", "--device", "cpu"])


def test_classification_commands_default_to_cuda(setup, monkeypatch):
    args = port_cli.build_parser().parse_args(["train-classify", "--train-dir", "t"])
    assert args.device == "cuda" and args.fn is port_cli.cmd_train_classify
    args = port_cli.build_parser().parse_args(["evaluate-classify", "--run-dir", "r",
                                               "--val-dir", "v"])
    assert (args.device, args.batch_size) == ("cuda", 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_cli(["train-classify", "--train-dir", setup["imgs"], "--config", setup["cfg"],
                 "--output-dir", setup["root"] / "exp_cuda"])
