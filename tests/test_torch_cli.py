"""The port's command line end to end on the CPU: `evaluate`, `compute-map`,
`infer` and `export` (then `evaluate --exported` and `infer --exported`) of
`python -m jpeg_detection_resnet_ssd_torch.cli`, on a seeded 4-image VOC
tree, at batch 2.

The run directory is the port's own: a `saved_config.json` and one
checkpoint written by the port's `CheckpointManager` (seeded weights, with
BatchNorm statistics calibrated on seeded DCT planes by `chip_smoke.py`'s
`calibrate_batch_norm`, so the random model's boxes stay finite).  The port's `compute-map` must print what the JAX
package's `compute-map` prints on the same files.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jpeg_detection_resnet_ssd_tpu.cli import main as jax_cli
from jpeg_detection_resnet_ssd_tpu.compat import export_keras_h5
from jpeg_detection_resnet_ssd_tpu.models import build_model as jax_build_model
from jpeg_detection_resnet_ssd_torch.cli import main as port_cli
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, build_trainer
from jpeg_detection_resnet_ssd_torch.train.checkpoints import CheckpointManager
from jpeg_detection_resnet_ssd_torch.train.config import create_run_dir

from chip_smoke import calibrate_batch_norm
from torch_cases import write_voc_tree
from torch_parity import random_flax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def run_cli(*args):
    """`python -m jpeg_detection_resnet_ssd_torch.cli ARGS` from the repo
    root; returns its standard output."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "jpeg_detection_resnet_ssd_torch.cli", *map(str, args)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    write_voc_tree(tmp / "voc", n_images=4, seed=1)
    config = ExperimentConfig(compute_dtype="float32", num_workers=2, output_dir=str(tmp / "exp"))
    run_dir = create_run_dir(config)
    trainer, module, _ = build_trainer(config, device="cpu")
    rng = np.random.default_rng(0)  # DCT planes as the JAX package's benchmark draws them
    calibrate_batch_norm(module, (torch.from_numpy(rng.normal(0, 100, (2, 38, 38, 64)).astype(np.float32)),
                                  torch.from_numpy(rng.normal(0, 30, (2, 19, 19, 128)).astype(np.float32))))
    CheckpointManager(os.path.join(run_dir, "checkpoints")).save(0, trainer)
    out = run_cli("evaluate", "--run-dir", run_dir, "--voc-root", tmp / "voc", "--batch-size", 2,
                  "--out-dir", tmp / "pred", "--device", "cpu")
    return dict(tmp=tmp, voc=tmp / "voc", pred=tmp / "pred", run_dir=run_dir,
                evaluate=json.loads(out.strip().splitlines()[-1]))


def test_evaluate_writes_voc_files_and_prints_map(run):
    result = run["evaluate"]
    assert 0.0 <= result["mAP"] <= 1.0 and len(result["AP"]) == 20
    files = sorted(os.listdir(run["pred"]))
    assert len(files) == 20 and files[0] == "comp3_det_test_aeroplane.txt"
    lines = [line.split() for f in files for line in open(run["pred"] / f)]
    assert len(lines) > 20
    assert {line[0] for line in lines} <= {f"01{i:04d}" for i in range(4)}
    assert all(np.isfinite([float(v) for v in line[1:]]).all() for line in lines)


def _jax_compute_map(*args):
    """The JAX package's `compute-map` in this process (NumPy only)."""
    parsed = jax_cli.build_parser().parse_args(["compute-map", *map(str, args)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        parsed.fn(parsed)
    return out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--ap-mode", "integrate", "--reference-iou"]])
def test_compute_map_prints_what_jax_prints(run, extra, capsys):
    args = ["--pred-dir", run["pred"], "--voc-root", run["voc"], *extra]
    if extra:  # in this process
        port_cli.main(["compute-map", *map(str, args)])
        got = capsys.readouterr().out
    else:
        got = run_cli("compute-map", *args)
    assert got == _jax_compute_map(*args)
    assert json.loads(got)["mAP"] >= 0.0


@pytest.fixture(scope="module")
def weights(run):
    """A Keras H5 of seeded flax variables (moderate BatchNorm statistics, so
    the boxes stay finite) and `infer --weights`' output with it."""
    module, example = jax_build_model("ssd300_ssd_custom", n_classes=20)
    variables = random_flax_variables(module, tuple(a[:1] for a in example()), train=False)
    h5 = run["tmp"] / "weights.h5"
    export_keras_h5(variables, str(h5))
    png = run["tmp"] / "det.png"
    out = run_cli("infer", "--image", run["voc"] / "JPEGImages" / "010002.jpg", "--weights", h5,
                  "--output", png, "--confidence", 0.2, "--device", "cpu")
    return dict(h5=h5, png=png, infer=out)


def test_infer_writes_a_png(run, weights):
    image = run["voc"] / "JPEGImages" / "010002.jpg"
    out, png = weights["infer"], weights["png"]
    assert "h5 import: 161 loaded, 0 skipped, 0 mismatched" in out
    assert out.strip().splitlines()[-1].endswith(f"detections -> {png}")
    from PIL import Image

    with Image.open(png) as im, Image.open(image) as src:
        assert im.format == "PNG" and im.size == src.size


@pytest.fixture(scope="module")
def artifact(run, weights):
    """`export --model ssd300_ssd_custom --weights H5 --symbolic-batch` on the
    CPU: the folded forward and the decode as one `torch.export` program."""
    out_dir = run["tmp"] / "artifact"
    out = run_cli("export", "--model", "ssd300_ssd_custom", "--weights", weights["h5"],
                  "--output", out_dir, "--symbolic-batch", "--batch-size", 2,
                  "--confidence", 0.01, "--top-k", 200, "--device", "cpu")
    yield out_dir, json.loads(out.strip().splitlines()[-1])
    shutil.rmtree(out_dir)  # ~210 MB of float32 weights


def test_export_writes_the_artifact_and_its_manifest(artifact):
    out_dir, printed = artifact
    manifest = json.loads((out_dir / "manifest.json").read_text())
    assert sorted(os.listdir(out_dir)) == ["manifest.json", "model.pt2"]
    assert printed["bytes"] == manifest["bytes"] == (out_dir / "model.pt2").stat().st_size
    assert manifest["format"] == "torch.export" and manifest["device"] == "cpu"
    assert manifest["symbolic_batch"] and manifest["model"] == "ssd300_ssd_custom"
    assert manifest["inputs"] == [{"shape": ["b", 38, 38, 64], "dtype": "float32"},
                                  {"shape": ["b", 19, 19, 128], "dtype": "float32"}]
    assert manifest["requires"]["import"] == "jpeg_detection_resnet_ssd_torch.ops"
    assert manifest["decode"]["nms_impl"] == "auto" and manifest["fold_bn"]


@pytest.mark.parametrize("argv", [
    ["evaluate", "--run-dir", "r", "--voc-root", "v", "--exported", "a"],
    ["infer", "--image", "x.jpg", "--exported", "a"],
])
def test_serving_artifacts_name_their_roadmap_item(run, weights, artifact, argv):
    """The serving artifacts of ROADMAP A14 (once refused naming it) run:
    `evaluate --exported` prints an mAP and writes the VOC files; `infer
    --exported` finds what `infer --weights` finds with the same weights
    (folded BatchNorm moves scores by ~1e-6, far from the 0.2 cut)."""
    out_dir, _ = artifact
    if argv[0] == "evaluate":
        pred = run["tmp"] / "pred_exported"
        out = run_cli("evaluate", "--run-dir", run["run_dir"], "--voc-root", run["voc"],
                      "--batch-size", 2, "--out-dir", pred, "--exported", out_dir, "--device", "cpu")
        result = json.loads(out.strip().splitlines()[-1])
        assert 0.0 <= result["mAP"] <= 1.0 and len(result["AP"]) == 20
        assert len(os.listdir(pred)) == 20
    else:
        png = run["tmp"] / "det_exported.png"
        out = run_cli("infer", "--image", run["voc"] / "JPEGImages" / "010002.jpg",
                      "--exported", out_dir, "--output", png, "--confidence", 0.2, "--device", "cpu")
        got = out.strip().splitlines()[-1]
        want = weights["infer"].strip().splitlines()[-1]
        assert got.split()[0] == want.split()[0] and int(got.split()[0]) > 0
        assert got.endswith(f"detections -> {png}") and png.stat().st_size > 0


def test_evaluate_exported_fixed_batch_equals_the_checkpoint(run):
    """An artifact of the run's checkpoint at a fixed batch of 3 (the last
    batch of the 4 images is padded up to it and trimmed back) gives the mAP
    and the VOC files of the in-process evaluate, to the folded BatchNorm's
    float32 rounding: scores within 1e-4, boxes within the files' 0.1-px
    step (a coordinate near a rounding boundary may cross it)."""
    out_dir = run["tmp"] / "artifact_b3"
    run_cli("export", "--run-dir", run["run_dir"], "--output", out_dir, "--batch-size", 3,
            "--candidate-selector", "exact", "--device", "cpu")
    pred = run["tmp"] / "pred_b3"
    out = run_cli("evaluate", "--run-dir", run["run_dir"], "--voc-root", run["voc"],
                  "--batch-size", 3, "--out-dir", pred, "--exported", out_dir, "--device", "cpu")
    assert json.loads(out.strip().splitlines()[-1])["mAP"] == pytest.approx(run["evaluate"]["mAP"], abs=1e-6)
    for name in sorted(os.listdir(run["pred"])):
        want = [line.split() for line in open(run["pred"] / name)]
        got = [line.split() for line in open(pred / name)]
        assert [r[0] for r in got] == [r[0] for r in want], name
        np.testing.assert_allclose(np.array([r[1:2] for r in got], float),
                                   np.array([r[1:2] for r in want], float), atol=1e-4)
        np.testing.assert_allclose(np.array([r[2:] for r in got], float),
                                   np.array([r[2:] for r in want], float), atol=0.1 + 1e-9)
    shutil.rmtree(out_dir)


@pytest.mark.parametrize("command", ["train-classify", "evaluate-classify", "export", "bench"])
def test_unported_subcommands_are_not_offered(command, capsys):
    """Every JAX subcommand is offered: the classification commands and
    `export` ask for their arguments; `bench` (A14c, ported) asks for none."""
    if command == "bench":
        args = port_cli.build_parser().parse_args([command])
        assert args.fn is port_cli.cmd_bench and args.model == "ssd300_ssd_custom"
        return
    with pytest.raises(SystemExit):
        port_cli.main([command])
    err = capsys.readouterr().err
    assert "invalid choice" not in err and "the following arguments are required" in err


def test_the_device_defaults_to_cuda():
    args = port_cli.build_parser().parse_args(["evaluate", "--run-dir", "r", "--voc-root", "v"])
    assert args.device == "cuda" and args.batch_size == 8 and args.ap_mode == "integrate"
    args = port_cli.build_parser().parse_args(["infer", "--image", "x.jpg"])
    assert args.device == "cuda" and args.model == "ssd300_ssd_custom"
