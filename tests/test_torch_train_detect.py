"""The port's `train-detect` end to end on the CPU, as
`tests/test_workflow.py` drives the JAX package's: a seeded VOC tree, a
Keras H5 of seeded weights, two steps with the host SSD chain, a restart
that reuses the run dir, `evaluate` on that run dir, and the device-augment
path from a packed corpus.  Then the first float32 step of `train-detect`'s
host path in both packages from the same H5 and the same first batch: their
losses agree within 1e-4 relative.
"""

import contextlib
import io
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.cli import main as jax_cli
from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.cli import main as port_cli
from jpeg_detection_resnet_ssd_torch.train import CheckpointManager, ExperimentConfig

from torch_cases import write_voc_tree
from torch_parity import random_flax_variables


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads for this module's full-size models, and the
    process's count back afterwards: set at import, the count would hold
    for every module that pytest collects after this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def run(cli, argv):
    """`cli.main(argv)` in this process; returns (run dir, last JSON row,
    standard output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main([str(a) for a in argv])
    text = out.getvalue()
    run_dir = re.search(r"run dir: (\S+)", text)
    return (run_dir.group(1) if run_dir else None), json.loads(text.strip().splitlines()[-1]), text


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_detect")
    voc = tmp / "voc"
    write_voc_tree(voc, n_images=6, seed=7, image_set="trainval.txt")
    shutil.copy(voc / "ImageSets" / "Main" / "trainval.txt", voc / "ImageSets" / "Main" / "test.txt")
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    weights = tmp / "weights.h5"
    variables = random_flax_variables(module, tuple(a[:1] for a in example()), train=False)
    export_keras_h5(variables, str(weights))
    f32 = tmp / "f32.json"
    f32.write_text(ExperimentConfig(compute_dtype="float32", model_kwargs={"n_classes": 20},
                                    batch_size=2, num_workers=2).to_json())
    return dict(tmp=tmp, voc=voc, weights=weights, f32=f32, variables=variables)


def test_train_restart_evaluate_workflow(setup):
    exp = setup["tmp"] / "exp"
    common = ["train-detect", "--voc-root", setup["voc"], "--output-dir", exp, "--batch-size", 2,
              "--steps-per-epoch", 2, "--num-workers", 2, "--pretrained-weights",
              setup["weights"], "--device", "cpu"]
    run_dir, row, out = run(port_cli, common + ["--epochs", 1, "--max-steps", 2])
    assert "h5 import: 161 loaded, 0 skipped, 0 mismatched" in out
    assert row["epoch"] == 0 and row["step"] == 2 and np.isfinite(row["total_loss"])
    ckpt = CheckpointManager(os.path.join(run_dir, "checkpoints"))
    assert ckpt.all_steps() == [2]

    run_dir2, row2, _ = run(port_cli, common + ["--epochs", 2, "--max-steps", 4, "--restart"])
    assert run_dir2 == run_dir, "restart must reuse the latest run dir"
    assert row2["epoch"] == 1 and row2["step"] == 4 and np.isfinite(row2["total_loss"])
    assert ckpt.all_steps() == [2, 4]

    _, ev, _ = run(port_cli, ["evaluate", "--run-dir", run_dir, "--voc-root", setup["voc"],
                           "--batch-size", 3, "--ap-mode", "sample", "--device", "cpu",
                           "--out-dir", setup["tmp"] / "preds"])
    assert np.isfinite(ev["mAP"]) and len(ev["AP"]) == 20
    assert sorted(os.listdir(setup["tmp"] / "preds"))[0] == "comp3_det_test_aeroplane.txt"


def test_device_augment_from_a_packed_corpus(setup):
    """Pack on the first call, reuse the corpus on the restart; steps in
    groups of 2 (the second epoch's first group straddles nothing)."""
    stem = setup["tmp"] / "pack" / "voc"
    common = ["train-detect", "--voc-root", setup["voc"], "--output-dir", setup["tmp"] / "exp_da",
              "--config", setup["f32"], "--steps-per-epoch", 3, "--device-augment",
              "--pack-cache", stem, "--steps-per-call", 2, "--device", "cpu"]
    run_dir, row, _ = run(port_cli, common + ["--epochs", 1])
    assert row["step"] == 3 and np.isfinite(row["total_loss"])
    meta = json.loads((setup["tmp"] / "pack" / "voc.meta.json").read_text())
    assert meta == {"n": 6, "img_height": 352, "img_width": 352, "max_gt": 64, "quality": 75}
    mtime = os.path.getmtime(str(stem) + ".y.npy")
    run_dir2, row2, _ = run(port_cli, common + ["--epochs", 2, "--restart"])
    assert run_dir2 == run_dir and row2["epoch"] == 1 and row2["step"] == 6
    assert os.path.getmtime(str(stem) + ".y.npy") == mtime


def test_validation_loss_is_reported(setup):
    _, row, _ = run(port_cli, ["train-detect", "--voc-root", setup["voc"], "--output-dir",
                            setup["tmp"] / "exp_val", "--config", setup["f32"], "--epochs", 1,
                            "--steps-per-epoch", 1, "--val-image-set", "test.txt",
                            "--device", "cpu"])
    assert np.isfinite(row["val_loss"]) and np.isfinite(row["total_loss"])


def test_first_float32_step_matches_jax(setup):
    """The first float32 step of `train-detect`'s host path in both
    packages, at batch 2: each package's H5 import of the same weights (the
    port's through its CLI; the JAX package's into the exported tree, which
    every H5 layer overwrites, saving its CLI's module init), each package's
    `DetectionPipeline` (the default SSD chain, seed 0, padded GT to the
    step) and `fit` for one step; the JAX package's on a one-device mesh
    (the CLI's mesh spans every device, which batch 2 does not fill).
    Losses within 1e-4 relative."""
    from jpeg_detection_resnet_ssd_tpu.boxes import AnchorSpec as JaxAnchorSpec
    from jpeg_detection_resnet_ssd_tpu.boxes import TargetEncoder as JaxTargetEncoder
    from jpeg_detection_resnet_ssd_tpu.compat import import_weights_by_name as jax_import
    from jpeg_detection_resnet_ssd_tpu.data import DetectionDataset as JaxDataset
    from jpeg_detection_resnet_ssd_tpu.data import DetectionPipeline as JaxPipeline
    from jpeg_detection_resnet_ssd_tpu.parallel.mesh import make_mesh
    from jpeg_detection_resnet_ssd_tpu.train.config import ExperimentConfig as JaxConfig
    from jpeg_detection_resnet_ssd_tpu.train.loop import fit as jax_fit
    from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
    from jpeg_detection_resnet_ssd_torch.data import DetectionDataset, DetectionPipeline
    from jpeg_detection_resnet_ssd_torch.models.ssd import ssd_predictor_sizes
    from jpeg_detection_resnet_ssd_torch.train import fit

    import jax

    voc = setup["voc"]
    paths = (str(voc / "JPEGImages"), str(voc / "ImageSets" / "Main" / "trainval.txt"),
             str(voc / "Annotations"))
    sizes = ssd_predictor_sizes("resnet_custom")
    config = ExperimentConfig.load(str(setup["f32"]))
    config.pretrained_weights = str(setup["weights"])
    config.epochs, config.steps_per_epoch = 1, 1
    jax_config = JaxConfig.from_json(config.to_json())

    encoder = TargetEncoder(AnchorSpec(), sizes, device="cpu")
    pipe = DetectionPipeline(DetectionDataset.from_voc(*paths), 2, train=True, encoder=encoder,
                             num_workers=2, device_encode=True)
    _, got = fit(config, pipe, max_steps=1, target_encoder=encoder, device="cpu",
                 init_variables=port_cli._maybe_import_pretrained(config))

    jax_encoder = JaxTargetEncoder(JaxAnchorSpec(), sizes)
    jax_pipe = JaxPipeline(JaxDataset.from_voc(*paths), 2, train=True, encoder=jax_encoder,
                           num_workers=2, device_encode=True)
    template = jax.tree_util.tree_map(np.zeros_like, setup["variables"])
    jax_variables, report = jax_import(template, str(setup["weights"]))
    assert len(report["loaded"]) == 161 and not report["mismatched"]
    _, want = jax_fit(jax_config, jax_pipe, max_steps=1, target_encoder=jax_encoder.encode_fn,
                      mesh=make_mesh(devices=jax.devices()[:1]), init_variables=jax_variables)
    for key in ("total_loss", "loss", "reg"):
        assert abs(got[0][key] - want[0][key]) <= 1e-4 * abs(want[0][key]), (
            key, got[0][key], want[0][key])


@pytest.mark.parametrize("extra,message", [
    (["--device-augment", "--config", "deconv.json"], "requires input_format='dct'"),
    (["--pack-cache", "x"], "only takes effect together with --device-augment"),
    (["--device-augment", "--archi", "deconv"], "requires input_format='dct'"),
    (["--archi", "resnet"], "unknown --archi 'resnet'"),
])
def test_device_augment_flag_errors(setup, extra, message):
    cfg = setup["tmp"] / "deconv.json"
    cfg.write_text(ExperimentConfig(input_format="dct_deconv").to_json())
    extra = [str(cfg) if a == "deconv.json" else a for a in extra]
    with pytest.raises(SystemExit, match=re.escape(message)):
        port_cli.main(["train-detect", "--voc-root", str(setup["voc"]), "--device", "cpu",
                       "--output-dir", str(setup["tmp"] / "exp_err"), *extra])


@pytest.mark.parametrize("extra,error,match", [
    (["--n-model-shards", "2"], ValueError, "mesh 0x2 != 1 processes"),
    (["--pretrained-weights", "https://example.invalid/w.h5"], OSError,
     "pre-stage the file at"),
    (["--pretrained-weights", "ssd300_voc07"], FileNotFoundError, "ssd300_voc07"),
], ids=["extra0-A13", "extra1-A14", "extra2-A14"])
def test_what_is_not_ported_names_its_roadmap_item(setup, extra, error, match, monkeypatch):
    """Tensor parallelism (A13b) is ported: `--n-model-shards 2` in one
    process asks for a 1x2 mesh of one process, which raises (it runs under
    `torchrun`, `tests/test_torch_tensor_parallel.py`).  A URL is served
    from the weight cache or refused with the path to pre-stage (nothing is
    downloaded); a name that is neither a known checkpoint nor a file fails
    as the JAX CLI's `_resolve_pretrained_source` makes it fail: it is taken
    for a path."""
    def no_network(*args, **kwargs):
        raise AssertionError("the CLI tried to open a URL")

    monkeypatch.setattr("urllib.request.urlopen", no_network)
    monkeypatch.setenv("HOME", str(setup["tmp"] / "home"))
    if extra[-1] == "ssd300_voc07":
        assert jax_cli._resolve_pretrained_source("ssd300_voc07") == "ssd300_voc07"
    with pytest.raises(error, match=match):
        port_cli.main(["train-detect", "--voc-root", str(setup["voc"]), "--device", "cpu",
                       "--output-dir", str(setup["tmp"] / "exp_np"), *extra])


# The model and input format that the JAX CLI's train-detect picks for each
# flag set (`--config` names its own model and format), one CPU step of it
# at batch 1 (bf16 compute but for the float32 config), and `evaluate` on
# the run, which builds the run's model and reads its input format.
@pytest.mark.parametrize("extra,model,input_format", [
    (["--vgg"], "ssd300_vgg_dct", "dct"),
    (["--archi", "deconv"], "ssd300_deconv", "dct_deconv"),
    (["--archi", "up_sampling"], "ssd300_up_sampling", "dct"),
    (["--archi", "cb5_only"], "ssd300_cb5_only", "dct"),
    (["--archi", "y_cb4_cbcr_cb5"], "ssd300_y_cb4_cbcr_cb5", "dct"),
    (["--config", "vgg.json"], "ssd300_vgg", "rgb"),
])
def test_other_families_train_one_cpu_step(setup, extra, model, input_format):
    cfg = setup["tmp"] / "vgg.json"
    cfg.write_text(ExperimentConfig(model="ssd300_vgg", input_format="rgb", compute_dtype="float32",
                                    momentum_dtype="bfloat16").to_json())
    extra = [str(cfg) if a == "vgg.json" else a for a in extra]
    out = setup["tmp"] / f"exp_{model}"
    run_dir, row, _ = run(port_cli, ["train-detect", "--voc-root", setup["voc"], "--device", "cpu",
                                     "--output-dir", out, "--batch-size", 1, "--steps-per-epoch", 1,
                                     "--epochs", 1, "--num-workers", 1, *extra])
    saved = ExperimentConfig.load(os.path.join(run_dir, "saved_config.json"))
    _, ev, _ = run(port_cli, ["evaluate", "--run-dir", run_dir, "--voc-root", setup["voc"],
                              "--batch-size", 3, "--device", "cpu"])
    shutil.rmtree(out)  # the checkpoint
    assert row["step"] == 1 and np.isfinite(row["total_loss"]) and row["reg"] > 0
    assert (saved.model, saved.input_format) == (model, input_format)
    assert len(ev["AP"]) == 20 and 0.0 <= ev["mAP"] <= 1.0


@pytest.mark.parametrize("model", ["ssd300_vgg", "ssd300_vgg_dct_image", "ssd300_deconv"])
def test_infer_feeds_each_model_its_input_contract(setup, model):
    """`infer --model` packs the image as the model reads it: RGB pixels,
    the DCT image, or Y, Cb and Cr apart."""
    image = sorted((setup["voc"] / "JPEGImages").iterdir())[0]
    output = setup["tmp"] / f"{model}.png"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_cli.main(["infer", "--image", str(image), "--model", model, "--output", str(output),
                       "--confidence", "0.0", "--device", "cpu"])
    assert re.fullmatch(rf"\d+ detections -> {re.escape(str(output))}", out.getvalue().strip())
    assert output.stat().st_size > 0


def test_train_detect_defaults_to_cuda(setup, monkeypatch):
    args = port_cli.build_parser().parse_args(["train-detect", "--voc-root", "v"])
    assert (args.device, args.steps_per_call, args.crop, args.reg) == ("cuda", 1, True, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["train-detect", "--voc-root", str(setup["voc"]),
                       "--output-dir", str(setup["tmp"] / "exp_cuda")])
