"""The PyTorch port stands alone: no jax, no flax, nothing of the JAX
package, and entry points that default to CUDA and raise without it."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jpeg_detection_resnet_ssd_torch as port
from jpeg_detection_resnet_ssd_torch.models import build_model, make_inference_fn
from jpeg_detection_resnet_ssd_torch.boxes import AnchorSpec, TargetEncoder
from jpeg_detection_resnet_ssd_torch.ops import (
    make_dct_classification_augment,
    make_dct_classification_augment_v2,
    make_dct_detection_augment,
    make_dct_detection_augment_v2,
    make_dct_detection_augment_v3,
)
from jpeg_detection_resnet_ssd_torch.train import ExperimentConfig, Trainer, build_trainer, fit
from jpeg_detection_resnet_ssd_torch.utils import cuda_times_ms, resolve_device

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "jpeg_detection_resnet_ssd_tpu")
# The port's scripts that a user runs on the card (they import only the port).
PROXY_SCRIPTS = ("torch_convergence_proxy", "torch_cls_convergence_proxy", "torch_quantize_eval")


def port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + ".")
    )


def import_every_module_without(blocked):
    """Import every port module in a fresh interpreter where the modules
    `blocked` cannot be imported; fails if one is needed or if anything of
    the JAX package is imported."""
    mods = [port.__name__, *port_modules()]
    assert len(mods) >= 60
    assert {"jpeg_detection_resnet_ssd_torch.cli.main", "jpeg_detection_resnet_ssd_torch.dctjpeg",
            "jpeg_detection_resnet_ssd_torch.serve.folding", "jpeg_detection_resnet_ssd_torch.serve.export",
            "jpeg_detection_resnet_ssd_torch.serve.quantize",
            "jpeg_detection_resnet_ssd_torch.data.pipeline", "jpeg_detection_resnet_ssd_torch.data.packed",
            "jpeg_detection_resnet_ssd_torch.data.augment", "jpeg_detection_resnet_ssd_torch.models.resnet",
            "jpeg_detection_resnet_ssd_torch.models.zoo", "jpeg_detection_resnet_ssd_torch.eval.imagenet_eval",
            "jpeg_detection_resnet_ssd_torch.ops.dct_augment",
            "jpeg_detection_resnet_ssd_torch.losses.classification"} <= set(mods)
    code = (
        "import sys\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        # and the proxy scripts, which parse their arguments without them
        f"sys.path.insert(0, {str(REPO / 'scripts')!r})\n"
        f"for m in {PROXY_SCRIPTS!r}:\n"
        "    argv = ['--run-dir', 'r', '--data-root', 'd'] if m == 'torch_quantize_eval' else []\n"
        "    importlib.import_module(m).build_parser().parse_args(argv)\n"
        # building the host chains and parsing train-detect need none of them
        "from jpeg_detection_resnet_ssd_torch.data import augment\n"
        "for chain in ('SSDDataAugmentation', 'SSDDataAugmentationNoCrop',\n"
        "              'DataAugmentationConstantInputSize', 'DataAugmentationVariableInputSize',\n"
        "              'DataAugmentationSatellite'):\n"
        "    getattr(augment, chain)()\n"
        "from jpeg_detection_resnet_ssd_torch.cli import main\n"
        "args = main.build_parser().parse_args(['train-detect', '--voc-root', 'v', '--device-augment'])\n"
        "assert args.fn is main.cmd_train_detect\n"
        "args = main.build_parser().parse_args(['train-classify', '--train-dir', 't', '--device-augment'])\n"
        "assert args.fn is main.cmd_train_classify\n"
        "args = main.build_parser().parse_args(['evaluate-classify', '--run-dir', 'r', '--val-dir', 'v'])\n"
        "assert args.fn is main.cmd_evaluate_classify\n"
        # the classifiers build on the CPU without jax, PIL, cv2 or h5py
        "from jpeg_detection_resnet_ssd_torch.models import build_model\n"
        "for name in ('resnet50_rgb', 'resnet50_dct_deconv'):\n"
        "    build_model(name, num_classes=3, device='cpu')\n"
        "bad = [m for m in sys.modules if m.startswith('jpeg_detection_resnet_ssd_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_module_imports_without_jax_or_flax():
    import_every_module_without(("jax", "jaxlib", "flax", "optax"))


def test_artifact_loads_and_runs_without_jax_or_flax(tmp_path):
    """A serving artifact whose graph holds the decode's NMS custom operator
    loads and runs in a fresh interpreter where jax, jaxlib, flax and optax
    cannot be imported (its manifest's `requires` names the port's `ops`,
    which `load_serving_artifact` imports), and gives this process's result."""
    import numpy as np

    from jpeg_detection_resnet_ssd_torch.serve import build_serving_fn, export_serving_artifact

    from torch_cases import raw_predictions

    decode = make_inference_fn(n_classes=20, spec=AnchorSpec(), top_k=20, device="cpu")
    serving = build_serving_fn(torch.nn.Identity(), decode_fn=decode, fold_bn=False)
    raw = raw_predictions(seed=2, batch=2)
    manifest = export_serving_artifact(serving, raw, str(tmp_path / "art"), device="cpu",
                                       symbolic_batch=True)
    assert manifest["requires"]["import"] == "jpeg_detection_resnet_ssd_torch.ops"
    np.save(tmp_path / "raw.npy", raw)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "from jpeg_detection_resnet_ssd_torch.serve import load_serving_artifact\n"
        f"fn, manifest = load_serving_artifact({str(tmp_path / 'art')!r})\n"
        f"raw = torch.from_numpy(np.load({str(tmp_path / 'raw.npy')!r}))\n"
        f"np.save({str(tmp_path / 'got.npy')!r}, fn(raw[:1]).numpy())\n"
        "bad = [m for m in sys.modules if m.startswith('jpeg_detection_resnet_ssd_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    with torch.no_grad():
        want = serving(torch.from_numpy(raw[:1])).numpy()
    got = np.load(tmp_path / "got.npy")
    assert got.shape == (1, 20, 6) and (got[..., 1] > 0).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_every_module_imports_without_pil_cv2_or_h5py():
    """The card's machine may lack the host image and weight-file packages:
    the port imports them only inside the functions that use them."""
    import_every_module_without(("PIL", "cv2", "h5py"))


def _imported_names(path):
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            yield str(node.args[0].value)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT_DIR.rglob("*.py")) + ["chip_smoke.py"]
    + sorted(str(p.relative_to(REPO)) for p in (REPO / "scripts").glob("torch_*.py")),
)
def test_source_imports_nothing_of_jax(path):
    bad = [
        name for name in _imported_names(REPO / path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("ssd300_ssd_custom", n_classes=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("resnet50_dct_cb5_only", num_classes=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(ExperimentConfig(model="resnet50_rgb", task="classification"))
    from jpeg_detection_resnet_ssd_torch.data import DeviceDCTAugmentedPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceDCTAugmentedPipeline([], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_inference_fn(n_classes=20, spec=AnchorSpec())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cuda_times_ms(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TargetEncoder(AnchorSpec(), ((1, 1),) * 6)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_trainer(ExperimentConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit(ExperimentConfig(), [])
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, None, torch.optim.SGD(model.parameters(), lr=0.1))
    for maker in (make_dct_detection_augment, make_dct_detection_augment_v2,
                  make_dct_detection_augment_v3, make_dct_classification_augment,
                  make_dct_classification_augment_v2):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            maker(38)


def test_unported_models_name_their_roadmap_item():
    """Every registry name is ported (A12b was the last family): the
    original VGG SSD300 builds on the CPU; an unknown name still raises."""
    model, example = build_model("ssd300_vgg", device="cpu")
    assert next(model.parameters()).device.type == "cpu" and example().shape == (2, 300, 300, 3)
    with pytest.raises(ValueError, match="unknown model"):
        build_model("no_such_model", device="cpu")


def test_cpu_path_builds_nothing(monkeypatch):
    """On the CPU the kernels' wrappers never reach nvcc or a library."""
    from jpeg_detection_resnet_ssd_torch.ops import (
        _build, batched_nms, bipartite_match, conv_grad, dct_flip,
    )

    def fail(name):
        raise AssertionError(f"tried to load {name}")

    monkeypatch.setattr(_build, "load", fail)
    keep = batched_nms.batched_nms_mask(torch.zeros(1, 2, 4), torch.ones(1, 2))
    assert keep.shape == (1, 2)
    assert bipartite_match.bipartite_match(torch.ones(1, 2, 3)).shape == (1, 2)
    assert conv_grad.conv3x3_filter_grad(torch.ones(1, 2, 2, 3), torch.ones(1, 2, 2, 4)).shape == (3, 3, 3, 4)
    assert dct_flip.dct_flip_horizontal(torch.ones(1, 2, 3, 128)).shape == (1, 2, 3, 128)
    aug = make_dct_detection_augment_v3(8, device="cpu")
    out = aug({"inputs": (torch.ones(2, 12, 12, 64), torch.ones(2, 6, 6, 128)),
               "gt": torch.zeros(2, 4, 5), "gt_mask": torch.zeros(2, 4, dtype=torch.bool)})
    assert out["inputs"][0].shape == (2, 8, 8, 64)
    assert (batched_nms.LAUNCHES, bipartite_match.LAUNCHES, conv_grad.LAUNCHES,
            dct_flip.LAUNCHES) == (0, 0, 0, 0)
